"""ROADMAP C10 and C6 in the port, on the CPU.

C10: every `_run_vi_ba` (local inertial BA, the IMU init's VI-BA,
`full_inertial_ba`, `merge_inertial_ba`; dense and point-chunked) erases
the observations that fail the chi2 gate at the solved state, as the
visual `_write_back` does and the reference's inertial BAs do; the JAX
package's `_run_vi_ba` erases none. The twins that hold inertial maps
against the JAX package run the JAX mapper under
`jax_vi_ba_erases_outliers()`, which adds the same erase after its
`_run_vi_ba`, leaving the JAX package itself untouched.

The problems: the two-fragment map of `test_torch_inertial_merge.py` (six
keyframes, 120 exactly reprojected points), with seeded outliers: ten
observations moved by 30 px and three points pushed behind the cameras.
Bounds: the erased observations are exactly the rows whose chi2 at the
written-back state exceeds 5.991 (recomputed here in float64 numpy; no row
lies within 1e-3 of the gate), and include every seeded outlier; a right
camera row that fails clears only that row; the JAX mapper under the
context manager erases the same observations as the port.

C6: `replace_point` carries the old point's right-camera rows into the
slots the new point gains (the JAX package drops them); everything else of
the two maps stays equal."""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_inertial_merge import TCAM, jax_mapper, port_mapper, two_fragments
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.optim import vi_ba as jvi_ba
from orb_slam3_comments_ghr_tpu.pipeline import mapper as jmapper
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.map import state as tstate

torch.set_num_threads(1)

GATE = 5.991  # chi2 of a monocular row at level 0 (sigma 1 px)


def erase_failing_rows(m, pts, obs_valid, inlier):
    """The outlier erase of the mappers' `_write_back`: a failing row's
    observation is removed; in a rig table a right row (column >= D)
    clears only that row."""
    D = m.cfg.obs_cap
    for j, srow in np.argwhere(obs_valid[: len(pts)] & ~inlier[: len(pts)]):
        if srow >= D:
            m.mp_obs_r_level[pts[j], srow - D] = -1
            continue
        c = m.mp_obs_kf[pts[j], srow]
        if c >= 0:
            m.remove_observation(int(pts[j]), int(c))


@contextlib.contextmanager
def jax_vi_ba_erases_outliers():
    """The JAX mapper with the port's repair of ROADMAP C10: after each
    `LocalMapper._run_vi_ba`, the rows of its problem that fail the chi2
    gate at the solved state (the JAX `_vis_terms` without Huber, as its
    `vi_bundle_adjust` classifies them) are erased from the map. The solver
    calls inside `_run_vi_ba` are recorded to get the problem and the final
    state (the last bite's, on the bite-wise and chunked paths)."""
    solves = []
    originals = {name: getattr(jvi_ba, name) for name in
                 ("vi_bundle_adjust", "vi_bundle_adjust_step", "vi_bundle_adjust_chunked")}

    def recording(name):
        def call(cam, prob, *args, **kwargs):
            out = originals[name](cam, prob, *args, **kwargs)
            solves.append((cam, prob, out[0], out[1], out[4]))
            return out
        return call

    run_vi_ba = jmapper.LocalMapper._run_vi_ba

    def run_and_erase(self, chain, pts, *args, **kwargs):
        solves.clear()
        run_vi_ba(self, chain, pts, *args, **kwargs)
        if not solves:
            return
        cam, prob, Rwb, pwb, p = solves[-1]
        chi2, delta2 = jvi_ba._vis_terms(cam, prob, Rwb, pwb, p, False)[4::2]
        obs_valid = np.asarray(prob.obs_valid)
        erase_failing_rows(self.map, pts, obs_valid, obs_valid & np.asarray(chi2 <= delta2))

    with pytest.MonkeyPatch.context() as mp:
        for name in originals:
            mp.setattr(jvi_ba, name, recording(name))
        mp.setattr(jmapper.LocalMapper, "_run_vi_ba", run_and_erase)
        yield


# ------------------------------------------------------------------- C10
def seeded_outliers(rig: bool = False):
    """The two-fragment map with ten observations moved by 30 px and three
    points pushed 30 m behind the cameras; with `rig`, a right camera
    (x_r = x_l - (0.11, 0, 0)) whose rows are exact but for two moved by
    30 px. Returns (map, keyframe ids, preintegrations, points, the moved
    (mp, kf) observations, the moved right rows (mp, slot))."""
    m, kf_ids, preint = two_fragments()
    rng = np.random.default_rng(4)
    pts = m.local_point_ids(kf_ids, 512)
    obs = [(mp, s) for mp in pts for s in range(m.cfg.obs_cap) if m.mp_obs_kf[mp, s] >= 0]
    moved = [obs[i] for i in rng.choice(len(obs), 10, replace=False)]
    for mp, s in moved:
        m.kf_feat_xy[m.mp_obs_kf[mp, s], m.mp_obs_idx[mp, s]] += np.float32(30.0)
    behind = [int(mp) for mp in rng.choice(pts, 3, replace=False)]
    m.mp_pos[behind, 2] = -30.0
    right_moved = []
    if rig:
        t_rl = np.array([-0.11, 0.0, 0.0], np.float32)
        m.rig = (np.eye(3, dtype=np.float32), t_rl)
        for kf in kf_ids:
            mps = np.nonzero(m.mp_obs_kf[pts] == kf)[0]
            pc = m.mp_pos[pts[mps]] @ m.kf_R[kf].T + m.kf_t[kf] + t_rl
            uv = (TCAM.fx * pc[:, :2] / pc[:, 2:3] + [TCAM.cx, TCAM.cy]).astype(np.float32)
            m.set_right_observations(kf, pts[mps], uv, np.zeros(len(mps), np.int32))
        live = np.argwhere((m.mp_obs_r_level[pts] >= 0)
                           & ~np.isin(pts, behind)[:, None])
        for j, s in live[rng.choice(len(live), 2, replace=False)]:
            m.mp_obs_r_uv[pts[j], s] += np.float32(30.0)
            right_moved.append((int(pts[j]), int(s)))
    return m, kf_ids, preint, pts, moved, right_moved


def _observations(m, pts):
    return {(int(mp), int(m.mp_obs_kf[mp, s]), int(m.mp_obs_idx[mp, s]))
            for mp in pts for s in range(m.cfg.obs_cap) if m.mp_obs_kf[mp, s] >= 0}


def _chi2(m, mp, kf, fi, right=None):
    """The row's chi2 at the map's state, float64 (level 0: sigma 1 px),
    projected as the BAs project (a point behind the camera mirrors)."""
    pc = m.kf_R[kf].astype(np.float64) @ m.mp_pos[mp] + m.kf_t[kf]
    uv = m.kf_feat_xy[kf, fi]
    if right is not None:
        pc = pc + m.rig[1]
        uv = m.mp_obs_r_uv[mp, right]
    z = pc[2] if abs(pc[2]) >= 1e-9 else 1e-9  # the pinhole projection's 1/z
    uv_hat = np.array([TCAM.fx * pc[0] / z + TCAM.cx, TCAM.fy * pc[1] / z + TCAM.cy])
    return float(np.sum((uv - uv_hat) ** 2))


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_vi_ba_erases_exactly_the_failing_rows(chunked):
    m, kf_ids, preint, pts, moved, _ = seeded_outliers()
    mapper = port_mapper(m, preint)
    before = _observations(m, pts)
    mapper._run_vi_ba(kf_ids, pts, iters=8, chunked=chunked)
    erased = before - _observations(m, pts)
    chi2 = {o: _chi2(m, *o) for o in before}
    assert min(abs(c - GATE) for c in chi2.values()) > 1e-3
    assert erased == {o for o, c in chi2.items() if c > GATE}
    for mp, s in moved:  # every seeded outlier went
        assert not any(o[0] == mp and o[1] == m.mp_obs_kf[mp, s] for o in _observations(m, pts))
    behind = m.mp_pos[:, 2] < -10
    assert {o[0] for o in erased} & set(np.nonzero(behind)[0].tolist())


def test_failing_right_row_clears_only_that_row():
    m, kf_ids, preint, pts, _, right_moved = seeded_outliers(rig=True)
    mapper = port_mapper(m, preint)
    before = _observations(m, pts)
    right_before = m.mp_obs_r_level[pts] >= 0
    mapper._run_vi_ba(kf_ids, pts, iters=8)
    left_erased = before - _observations(m, pts)
    for mp, s in right_moved:
        assert m.mp_obs_r_level[mp, s] == -1  # the right row went
        kf, fi = int(m.mp_obs_kf[mp, s]), int(m.mp_obs_idx[mp, s])
        assert kf >= 0 and (mp, kf, fi) not in left_erased  # its left observation stays
    # every right row left passes the gate, every right row erased fails it
    for j, s in np.argwhere(right_before):
        mp = int(pts[j])
        kf = int(m.mp_obs_kf[mp, s])
        if kf < 0:  # its left observation went with its slot
            continue
        c = _chi2(m, mp, kf, int(m.mp_obs_idx[mp, s]), right=s)
        assert (m.mp_obs_r_level[mp, s] >= 0) == (c <= GATE), (mp, s, c)
    assert (m.mp_obs_r_level[pts] >= 0).sum() > 100


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_jax_erase_matches_the_port(chunked):
    m, kf_ids, preint, pts, _, _ = seeded_outliers()
    arrays = convert.map_state_to_numpy(m)
    tmp, jmp = port_mapper(m, preint), jax_mapper(arrays, preint)
    tmp._run_vi_ba(kf_ids, pts, iters=8, chunked=chunked)
    with jax_vi_ba_erases_outliers():
        jmp._run_vi_ba(kf_ids, pts, iters=8, chunked=chunked)
    erased = _observations(convert.map_state_from_numpy(arrays), pts) - _observations(tmp.map, pts)
    assert len(erased) >= 10
    np.testing.assert_array_equal(tmp.map.mp_obs_kf, jmp.map.mp_obs_kf)
    np.testing.assert_array_equal(tmp.map.kf_feat_mp, jmp.map.kf_feat_mp)
    np.testing.assert_array_equal(tmp.map.mp_n_obs, jmp.map.mp_n_obs)


# -------------------------------------------------------------------- C6
def test_fused_point_keeps_its_right_rows():
    """Two points, each seen by two keyframes with right rows on every
    observation; `replace_point(old, new)` moves the old point's keyframe
    observation into the new point with its right row. The same calls on
    the JAX map give the same map but for that row, which it drops."""
    maps = [pkg.MapState(pkg.MapConfig(max_kf=4, max_mp=8, n_feat=8, obs_cap=4))
            for pkg in (tstate, jstate)]
    feats = {"xy": np.zeros((8, 2), np.float32), "level": np.zeros(8, np.int32),
             "angle": np.zeros(8, np.float32), "desc": np.zeros((8, 8), np.uint32),
             "valid": np.ones(8, bool), "u_right": np.full(8, -1.0, np.float32),
             "depth": np.full(8, -1.0, np.float32)}
    for m in maps:
        m.rig = (np.eye(3, dtype=np.float32), np.array([-0.1, 0.0, 0.0], np.float32))
        kfs = [m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), feats, 0.1 * i)
               for i in range(3)]
        new, old = m.add_map_points(np.array([[0, 0, 5], [0.01, 0, 5]], np.float32),
                                    np.zeros((2, 8), np.uint32), kfs[0], np.array([0, 1]))
        m.add_observation(int(new), kfs[1], 0)
        m.add_observation(int(old), kfs[2], 1)
        for kf in kfs:
            mps = np.array([new, old])
            m.set_right_observations(kf, mps, np.array([[10, 20], [30, 40]], np.float32) + kf,
                                     np.array([1, 2], np.int32))
        m.replace_point(int(old), int(new))
    tm, jm = maps
    s_new = np.nonzero(tm.mp_obs_kf[new] == 2)[0]
    assert len(s_new) == 1  # keyframe 2's observation moved into `new`
    np.testing.assert_array_equal(tm.mp_obs_r_uv[new, s_new[0]], [32, 42])
    assert tm.mp_obs_r_level[new, s_new[0]] == 2
    assert jm.mp_obs_r_level[new, s_new[0]] == -1  # the JAX package drops it (C6)
    assert (tm.mp_obs_r_level[new] >= 0).sum() == 3 and (tm.mp_obs_r_level[old] < 0).all()
    for k, v in vars(tm).items():
        # the port's slot birth versions (`mp_born`) have no JAX counterpart
        if isinstance(v, np.ndarray) and not k.startswith("mp_obs_r_") and k != "mp_born":
            np.testing.assert_array_equal(v, getattr(jm, k), err_msg=k)
