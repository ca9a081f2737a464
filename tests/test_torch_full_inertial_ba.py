"""The whole-map FullInertialBA of the port (`mapper.full_inertial_ba`,
Optimizer.cc:3254: every keyframe of the active map's temporal chain and
its landmarks, in abortable bites), on the CPU: the twins of
`tests/test_full_inertial_ba.py`'s three cases, and one call replayed in
both packages from the same map.

The map is made once per module by the port: the JAX test's mono-inertial
run (world 77, 512 rendered features, `vi_sequence`, a keyframe at least
every 4 frames) cut from 160 frames to 95 for time; it still holds a
temporal chain of more than 12 keyframes, past the 10-keyframe local
window, and the IMU is initialized. The twins keep the JAX test's bars.

The replay: `full_inertial_ba(iters=3)` (one bite of the dense solver) on
copies of the same map, keyframe preintegrations and IMU bias, in a new
JAX mapper and in the port's. Bounds (three float32 LM iterations that sum
in another order): keyframe rotations within 1e-5, translations and
velocities within 1e-4, biases within 1e-5, points within 1e-3, ten times
tighter than `tests/test_torch_global_ba.py`'s after ten iterations."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vi_ba_outliers import jax_vi_ba_erases_outliers
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.optim import imu as jimu
from orb_slam3_comments_ghr_tpu.pipeline import imu_frontend as jfront, mapper as jmapper
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.optim import imu as timu, vi_ba as tvi_ba
from orb_slam3_comments_ghr_torch.pipeline import imu_frontend as tfront, mapper as tmapper
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic

torch.set_num_threads(1)

TCAM = tcameras.euroc_cam0()
NOISE = dict(noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
# tests/test_full_inertial_ba.py
CFG = dict(sensor=tconfig.IMU_MONOCULAR, n_features=512, local_points_cap=2048,
           local_ba_points=2048, max_frames_between_kf=4, min_init_matches=60,
           enable_loop_closing=False)
N_FRAMES = 95


@pytest.fixture(scope="module")
def vi_map():
    """(slam, ground truth, snapshot of the map before any test ran)."""
    world = synthetic.make_world(77, n_points=3000)
    poses, imu_rows, times = synthetic.vi_sequence(N_FRAMES)
    calib = timu.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32), **NOISE)
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), imu_calib=calib, device="cpu")
    for i, (R, t) in enumerate(poses):
        chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1)) & (imu_rows[:, 0] <= times[i])]
        if len(chunk):
            slam.feed_imu(chunk)
        feats, _ = synthetic.render_features(world, TCAM, R, t, n_feat=512, seed=7700 + i,
                                             device="cpu")
        slam.track_features(feats, times[i])
    gt = [(times[i], np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))
          for i, (R, t) in enumerate(poses)]
    snap = dict(map=convert.map_state_to_numpy(slam.map),
                preint={k: {f: np.asarray(a) for f, a in v._asdict().items()}
                        for k, v in slam.mapper.kf_preint.items()},
                bias=np.asarray(slam.mapper.imu.bias).copy())
    return slam, gt, snap


def _kf_ate(slam, gt):
    m = slam.map
    gtd = {round(t, 6): T for t, T in gt}
    est = []
    for kf in m.kf_ids():
        t = round(float(m.kf_time[kf]), 6)
        if t in gtd:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = m.kf_R[kf], m.kf_t[kf]
            est.append((t, T))
    return evaluation.ate_rmse(est, gt, with_scale=False), len(est)


def test_covers_whole_chain_and_keeps_accuracy(vi_map):
    slam, gt, _ = vi_map
    m = slam.map
    assert m.map_imu_init.get(m.active_map, False)
    assert len(m.kf_ids()) > 12  # well beyond the <= 10-keyframe local window
    ate0, _ = _kf_ate(slam, gt)
    v0 = m.version
    poses_before = m.kf_R[m.kf_ids()].copy()
    slam.mapper.full_inertial_ba(iters=6)
    assert m.version > v0
    # the whole chain moved, the oldest free keyframes too
    moved = np.array([np.abs(m.kf_R[k] - poses_before[i]).max()
                      for i, k in enumerate(m.kf_ids())])
    assert (moved[1:8] > 0).any(), "early-chain keyframes untouched"
    ate1, _ = _kf_ate(slam, gt)
    assert ate1 < max(ate0 * 1.2, 0.3), (ate0, ate1)


def test_abort_stops_at_bite_boundary(vi_map):
    slam = vi_map[0]
    slam.mapper.request_abort_gba()  # consumed at the start: a fresh call runs
    calls = []
    orig = slam.mapper._run_vi_ba

    def spy(chain, pts, iters, seam=(), point_cap=None, **kw):
        calls.append(iters)
        slam.mapper.abort_gba = True  # as request_abort_gba would
        return orig(chain, pts, iters=iters, seam=seam, point_cap=point_cap, **kw)

    slam.mapper._run_vi_ba = spy
    try:
        slam.mapper.full_inertial_ba(iters=9)
    finally:
        del slam.mapper._run_vi_ba
    assert calls == [3], calls  # stopped after the first bite


def test_past_dense_cap_runs_chunked_over_all_points(vi_map, monkeypatch):
    """Past the dense solver's cap, every landmark of the chain goes to the
    point-chunked solver (Optimizer.cc:3254 optimizes all map points)."""
    slam, gt, _ = vi_map
    m, mapper = slam.map, slam.mapper
    chain = mapper._temporal_chain(int(m.kf_ids()[-1]), cap=256)
    all_pts = m.local_point_ids(chain, None)
    small = max(16, len(all_pts) // 8 // 4)
    chunked = tvi_ba.vi_bundle_adjust_chunked
    seen_P = []

    def spy(cam, prob, lam, iters=2, **kw):
        seen_P.append(int(prob.p.shape[0]))
        return chunked(cam, prob, lam, iters=iters, **kw)

    monkeypatch.setattr(tvi_ba, "vi_bundle_adjust_chunked", spy)
    monkeypatch.setattr(mapper, "cfg", dataclasses.replace(mapper.cfg, local_ba_points=small))
    ate0, _ = _kf_ate(slam, gt)
    mapper.full_inertial_ba(iters=2)
    ate1, _ = _kf_ate(slam, gt)
    assert len(all_pts) > 4 * small, "fixture map too small to exercise"
    assert seen_P and seen_P[0] >= len(all_pts), (seen_P, len(all_pts))
    assert seen_P[0] % tmapper.VI_CHUNK == 0
    assert ate1 < max(ate0 * 1.3, 0.3), (ate0, ate1)


def _jax_mapper(snap):
    cfg = jconfig.SlamConfig(**CFG)
    jm = jstate.MapState(jstate.MapConfig(**snap["map"]["cfg"]))
    for k, v in snap["map"].items():
        if k != "cfg":
            setattr(jm, k, v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
    mp = jmapper.LocalMapper(jcameras.euroc_cam0(), cfg, jm)
    mp.imu = jfront.ImuFrontend(jimu.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), **NOISE))
    mp.imu.bias = snap["bias"].copy()
    mp.kf_preint = {k: jimu.Preintegrated(**{f: jnp.asarray(a) for f, a in v.items()})
                    for k, v in snap["preint"].items()}
    return mp


def _port_mapper(snap):
    tm = convert.map_state_from_numpy(snap["map"])
    mp = tmapper.LocalMapper(TCAM, tconfig.SlamConfig(**CFG), tm, device="cpu")
    mp.imu = tfront.ImuFrontend(timu.ImuCalib(Rbc=np.eye(3, dtype=np.float32),
                                              tbc=np.zeros(3, np.float32), **NOISE), device="cpu")
    mp.imu.bias = snap["bias"].copy()
    mp.kf_preint = {k: convert.preintegrated_from_numpy(v, device="cpu")
                    for k, v in snap["preint"].items()}
    return mp


def test_full_inertial_ba_replayed_against_jax(vi_map):
    snap = vi_map[2]
    jmp, tmp = _jax_mapper(snap), _port_mapper(snap)
    with jax_vi_ba_erases_outliers():  # the port's VI-BA erase (ROADMAP C10)
        jmp.full_inertial_ba(iters=3)
    tmp.full_inertial_ba(iters=3)
    m, tm = jmp.map, tmp.map
    kfs = m.kf_ids()
    assert m.version == tm.version == snap["map"]["version"] + 1
    assert np.abs(tm.kf_t[kfs] - snap["map"]["kf_t"][kfs]).max() > 1e-4  # the BA moved the map
    np.testing.assert_allclose(tm.kf_R, m.kf_R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.kf_t, m.kf_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_vel, m.kf_vel, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_bias, m.kf_bias, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.mp_pos, m.mp_pos, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tmp.imu.bias, np.asarray(jmp.imu.bias), rtol=0, atol=1e-5)
