"""The port's copies of the host modules against the JAX package's: the map
store (the same call sequence gives equal arrays, exactly), the config
defaults, the trajectory metrics, and the `convert` carry-over of maps,
configs and BA problems."""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, evaluation as jevaluation
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation as tevaluation

torch.set_num_threads(1)

N_FEAT = 64


def _feats(rng):
    return {
        "xy": (rng.random((N_FEAT, 2)) * 700).astype(np.float32),
        "level": rng.integers(0, 8, N_FEAT).astype(np.int32),
        "angle": rng.random(N_FEAT).astype(np.float32),
        "desc": rng.integers(0, 2**32, (N_FEAT, 8), dtype=np.uint32),
        "valid": rng.random(N_FEAT) > 0.1,
        "u_right": np.full(N_FEAT, -1.0, np.float32),
        "depth": np.full(N_FEAT, -1.0, np.float32),
    }


def _pose(rng, i):
    a = 0.1 * i
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    return R, np.array([0.3 * i, 0.0, 0.1 * i], np.float32) + rng.normal(0, 0.01, 3).astype(np.float32)


def _drive(mod, seed=0):
    """One call sequence over a small map: keyframes, points, observations,
    fuse-style replacement, removal, geometry updates. Returns the map and
    what the read-only queries gave."""
    rng = np.random.default_rng(seed)
    m = mod.MapState(mod.MapConfig(max_kf=4, max_mp=32, n_feat=N_FEAT, obs_cap=4))
    kfs = []
    for i in range(6):  # grows the keyframe pool past max_kf
        R, t = _pose(rng, i)
        kfs.append(m.add_keyframe(R, t, _feats(rng), 0.05 * i, parent=i - 1, prev=i - 1))
    pos = (rng.random((40, 3)) * 4 + [0, 0, 6]).astype(np.float32)
    desc = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    ids = m.add_map_points(pos, desc, kfs[0], np.arange(40))  # grows the point pool
    for k in kfs[1:4]:
        sel = rng.permutation(40)[:25]
        m.add_observations(ids[sel], k, rng.permutation(N_FEAT)[:25])
    m.add_observation(int(ids[0]), kfs[4], 7)
    m.update_point_geometry(ids)
    queries = {
        "cov": m.covisibility(kfs[1]),
        "covk": m.covisible_kfs(kfs[2], k=3, min_weight=2),
        "local": m.local_point_ids(kfs[1:3], 20).tolist(),
        "edges": [a.tolist() for a in m.covisibility_edges(min_weight=3)],
        "level": m.predict_scale_level(np.full(5, 3.0), ids[:5]).tolist(),
    }
    m.replace_point(int(ids[3]), int(ids[4]))
    m.remove_observation(int(ids[5]), kfs[1])
    m.remove_point(int(ids[6]))
    m.remove_keyframe(kfs[2])
    m.create_new_map()
    m.apply_transform(0, 1.5, np.eye(3, dtype=np.float32), np.ones(3, np.float32))
    new = m.add_map_points(pos[:3], desc[:3], kfs[5], np.arange(3))  # reuses freed ids
    queries["new"] = new.tolist()
    queries["kf_ids"] = m.kf_ids(0).tolist()
    queries["mp_ids"] = m.mp_ids(0).tolist()
    return m, queries


def test_map_state_copy_equals_jax():
    mj, qj = _drive(jstate)
    mt, qt = _drive(tstate)
    assert qt == qj
    aj, at = convert.map_state_to_numpy(mj), convert.map_state_to_numpy(mt)
    assert aj.keys() == at.keys()
    for k in aj:
        if isinstance(aj[k], np.ndarray):
            assert at[k].dtype == aj[k].dtype, k
            np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
        else:
            assert at[k] == aj[k], k


def test_map_state_round_trip_through_convert():
    mj, _ = _drive(jstate, seed=1)
    mt = convert.map_state_from_numpy(convert.map_state_to_numpy(mj))
    assert isinstance(mt, tstate.MapState)
    for k, v in convert.map_state_to_numpy(mj).items():
        got = convert.map_state_to_numpy(mt)[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert got == v, k
    # the copy is independent of its source
    mt.kf_R[0] += 1.0
    assert not np.array_equal(mt.kf_R[0], mj.kf_R[0])
    # and keeps working: the same next call gives the same result
    assert mt.covisibility(1) == mj.covisibility(1)


def test_config_defaults_equal():
    assert dataclasses.asdict(tconfig.SlamConfig()) == dataclasses.asdict(jconfig.SlamConfig())
    for name in ("MONOCULAR", "STEREO", "RGBD", "IMU_MONOCULAR", "IMU_STEREO", "IMU_RGBD"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    jc = jconfig.SlamConfig(n_features=512, enable_loop_closing=False, voc_path="x.npz")
    assert dataclasses.asdict(convert.config_from_jax(jc)) == dataclasses.asdict(jc)
    assert tconfig.SlamConfig(sensor=tconfig.IMU_MONOCULAR).is_inertial
    assert tconfig.SlamConfig().is_mono


def _traj(rng, n, noise):
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = _pose(rng, i)[0]
        T[:3, 3] = [np.sin(0.2 * i), 0.1 * i, np.cos(0.3 * i)] + rng.normal(0, noise, 3)
        out.append((0.05 * i + rng.normal(0, 0.002), T))
    return out


@pytest.mark.parametrize("with_scale", [True, False])
def test_evaluation_copy_equals_jax(with_scale):
    rng = np.random.default_rng(4)
    est, gt = _traj(rng, 30, 0.01), _traj(rng, 30, 0.0)
    ta, tb = np.array([t for t, _ in est]), np.array([t for t, _ in gt])
    for a, b in zip(tevaluation.associate(ta, tb), jevaluation.associate(ta, tb)):
        np.testing.assert_array_equal(a, b)
    pa, pb = rng.random((20, 3)), rng.random((20, 3))
    for a, b in zip(tevaluation.horn_align(pa, pb, with_scale), jevaluation.horn_align(pa, pb, with_scale)):
        np.testing.assert_array_equal(a, b)
    assert tevaluation.ate_rmse(est, gt, with_scale) == jevaluation.ate_rmse(est, gt, with_scale)


def test_ba_problem_from_numpy_types():
    rng = np.random.default_rng(5)
    P, D, K = 16, 3, 4
    arrays = dict(
        cam_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), cam_t=rng.random((K, 3)),
        cam_fixed=np.array([1, 0, 0, 1]), p=rng.random((P, 3)), p_valid=np.ones(P),
        obs_cam=rng.integers(0, K, (P, D)), obs_uv=rng.random((P, D, 2)),
        obs_ur=np.full((P, D), -1.0), obs_level=rng.integers(0, 8, (P, D)),
        obs_valid=rng.random((P, D)) > 0.3,
    )
    prob = convert.ba_problem_from_numpy(arrays, device="cpu")
    assert prob.cam_fixed.dtype == torch.bool and prob.obs_valid.dtype == torch.bool
    assert prob.obs_cam.dtype == torch.int32 and prob.obs_level.dtype == torch.int32
    assert prob.p.dtype == torch.float32
    back = convert.to_numpy(prob)
    np.testing.assert_array_equal(back["obs_cam"], arrays["obs_cam"])
    np.testing.assert_allclose(back["p"], arrays["p"].astype(np.float32))
