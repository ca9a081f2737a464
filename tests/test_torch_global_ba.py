"""Whole-map BA through the port, against the JAX package: one bite of
`ba.bundle_adjust_resumable` on the same problem, and the twin of
`tests/test_global_ba.py` (its 3 cases: map-wide error reduction, the
spanning-tree propagation to keyframes and points made during the BA, and
the stop request), each run in both packages on copies of the same map,
and `mapper.global_ba` on it.

Bounds: the bite's poses within 1e-5 (rotations) and 1e-4 (translations),
points within 1e-3 and the damping equal; after `run_full_map_ba` the two
maps' keyframe rotations within 1e-4, translations within 1e-3 and points
within 1e-2 (ten float32 LM iterations with another summation order), the
same observations erased, and the reprojection RMSE within 1 % of each
other. The JAX test's bars hold for the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_global_ba import _build_noisy_map, _feats, _reproj_rmse
from orb_slam3_comments_ghr_tpu.optim import ba as jba
from orb_slam3_comments_ghr_tpu.pipeline import mapper as jmapper
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.optim import ba as tba
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper
from orb_slam3_comments_ghr_torch.utils import config as tconfig

torch.set_num_threads(1)

TCAM = tcameras.euroc_cam0()


def both_maps(seed: int):
    """(JAX map, JAX mapper, port map, port mapper, keyframes) on copies of
    `_build_noisy_map(seed)`."""
    m, mapper, kfs, _ = _build_noisy_map(seed=seed)
    tm = convert.map_state_from_numpy(convert.map_state_to_numpy(m))
    tmp = tmapper.LocalMapper(TCAM, convert.config_from_jax(mapper.cfg), tm, device="cpu")
    return m, mapper, tm, tmp, kfs


def same_maps(m, tm):
    np.testing.assert_allclose(tm.kf_R, m.kf_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t, m.kf_t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.mp_pos, m.mp_pos, rtol=0, atol=1e-2)
    assert (tm.mp_obs_kf == m.mp_obs_kf).all()


def test_resumable_bite_against_jax():
    m, mapper, kfs, _ = _build_noisy_map(seed=1)
    pts = m.local_point_ids(kfs, cap=10**9)
    anchor = min(kfs)
    cam_ids = [k for k in kfs if k != anchor] + [anchor]
    K, chunk = 32, 256
    P = -(-len(pts) // chunk) * chunk  # several point chunks
    cam_slot = {c: i for i, c in enumerate(cam_ids)}
    arrays = dict(cam_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
                  cam_t=np.zeros((K, 3), np.float32), cam_fixed=np.arange(K) >= len(cam_ids) - 1,
                  p=np.zeros((P, 3), np.float32), p_valid=np.arange(P) < len(pts))
    arrays["cam_R"][: len(cam_ids)] = m.kf_R[cam_ids]
    arrays["cam_t"][: len(cam_ids)] = m.kf_t[cam_ids]
    arrays["p"][: len(pts)] = m.mp_pos[pts]
    tables = jmapper._build_obs_tables(m, pts, cam_slot, P)[:5]
    arrays.update(zip(("obs_cam", "obs_uv", "obs_ur", "obs_level", "obs_valid"), tables))
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ref = jba.bundle_adjust_resumable(mapper.cam, jprob, jnp.asarray(1e-4, jnp.float32), iters=2,
                                      point_chunk=chunk)
    port = tba.bundle_adjust_resumable(TCAM, convert.ba_problem_from_numpy(arrays, device="cpu"),
                                       torch.tensor(1e-4), iters=2, point_chunk=chunk)
    for a, b, tol in zip(port, ref, (1e-5, 1e-4, 1e-3, 0.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=tol)
    assert float(ref[3]) < 1e-4  # both bites accepted their steps


class TestFullMapBA:
    def test_error_drops_map_wide(self):
        m, mapper, tm, tmp, kfs = both_maps(0)
        e0 = _reproj_rmse(tm, kfs)
        pts = m.local_point_ids(kfs, cap=10**9)
        mapper.run_full_map_ba(kfs, pts, iters=10)
        tmp.run_full_map_ba(kfs, pts, iters=10)
        same_maps(m, tm)
        e1 = _reproj_rmse(tm, kfs)
        assert abs(e1 - _reproj_rmse(m, kfs)) < 0.01 * e1
        assert e1 < 0.35 * e0, (e0, e1)

    def test_propagates_to_kfs_created_during_ba(self):
        m, mapper, tm, tmp, kfs = both_maps(3)
        snapshot = list(kfs)
        pts = m.local_point_ids(snapshot, cap=10**9)
        # a keyframe inserted while the BA runs: a child of the last
        # snapshot keyframe, with a point first seen from it
        par = snapshot[-1]
        for mm, mp in ((m, mapper), (tm, tmp)):
            child = mm.add_keyframe(mm.kf_R[par].copy(), (mm.kf_t[par] + [0.1, 0, 0]).copy(),
                                    _feats(), timestamp=99.0, parent=par)
            p_new = mm.add_map_points(np.array([[0.5, 0.5, 8.0]], np.float32),
                                      np.zeros((1, 8), np.uint32), child, np.array([0]))[0]
            rel_before = mm.kf_R[child] @ mm.kf_R[par].T
            trel_before = mm.kf_t[child] - rel_before @ mm.kf_t[par]
            p_cam_before = mm.kf_R[child] @ mm.mp_pos[p_new] + mm.kf_t[child]
            mp.run_full_map_ba(snapshot, pts, iters=6)
            rel_after = mm.kf_R[child] @ mm.kf_R[par].T
            trel_after = mm.kf_t[child] - rel_after @ mm.kf_t[par]
            np.testing.assert_allclose(rel_after, rel_before, atol=1e-4)
            np.testing.assert_allclose(trel_after, trel_before, atol=1e-4)
            p_cam_after = mm.kf_R[child] @ mm.mp_pos[p_new] + mm.kf_t[child]
            np.testing.assert_allclose(p_cam_after, p_cam_before, atol=1e-3)
        same_maps(m, tm)

    def test_abort_stops_early_but_writes_back(self):
        m, mapper, tm, tmp, kfs = both_maps(5)
        pts = m.local_point_ids(kfs, cap=10**9)
        e0 = _reproj_rmse(tm, kfs)
        v0 = tm.version
        for mp in (mapper, tmp):
            mp.request_abort_gba()
            mp.run_full_map_ba(kfs, pts, iters=10)
        same_maps(m, tm)
        assert tm.version > v0  # still wrote back a consistent state
        assert _reproj_rmse(tm, kfs) <= e0 * 1.05


def test_global_ba_against_jax():
    """`global_ba` on a map small enough for the windowed solver (the
    first keyframe pinned), then with `dba_devices` set: in one process
    there is no world of ranks to shard over, so it takes the same
    single-device path, bit for bit (the sharded path since ROADMAP A8:
    `test_torch_parallel.py`)."""
    m, mapper, tm, tmp, kfs = both_maps(0)
    mapper.cfg.local_ba_points = tmp.cfg.local_ba_points = 1024  # all 700 points fit
    e0 = _reproj_rmse(tm, kfs)
    mapper.global_ba(iters=10)
    tmp.global_ba(iters=10)
    same_maps(m, tm)
    assert _reproj_rmse(tm, kfs) < 0.35 * e0
    snap = convert.map_state_to_numpy(tm)
    for dba_devices in (2, 0):
        cfg = tconfig.SlamConfig(dba_devices=dba_devices, local_ba_points=1024)
        mp = tmapper.LocalMapper(TCAM, cfg, convert.map_state_from_numpy(snap), device="cpu")
        assert mp._dba_mesh() is None
        mp.global_ba(iters=4)
        if dba_devices:
            sharded = mp.map
    for k in ("kf_R", "kf_t", "mp_pos", "mp_obs_kf"):
        assert np.array_equal(getattr(sharded, k), getattr(mp.map, k)), k
