"""Trajectory export through culled keyframes and pool growth of the
port's map, on the CPU: the twins of `tests/test_exports.py`'s
`test_trajectory_through_culled_ref_kf_is_exact` and
`test_kf_pool_grows_past_capacity`, run by the port alone to the JAX
test's bars (the four trajectory writers are covered by
`tests/test_torch_slam.py::test_trajectory_exports`)."""

import numpy as np
import torch

from orb_slam3_comments_ghr_torch.map.state import MapConfig, MapState
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.pipeline.tracker import FrameRecord
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

torch.set_num_threads(1)


def _feats(n):
    return {"xy": np.zeros((n, 2), np.float32), "level": np.zeros(n, np.int32),
            "angle": np.zeros(n, np.float32), "desc": np.zeros((n, 8), np.uint32),
            "valid": np.ones(n, bool), "u_right": np.full(n, -1.0, np.float32),
            "depth": np.full(n, -1.0, np.float32)}


def _T(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


def test_trajectory_through_culled_ref_kf_is_exact():
    """A frame whose reference keyframe is culled (then its parent too)
    exports its exact pose through the frozen Tcp chain (System.cc:760-847,
    KeyFrame.h:392)."""
    slam = SLAM(cameras.euroc_cam0(), SlamConfig(n_features=64, enable_loop_closing=False),
                device="cpu")
    m = slam.map
    rng = np.random.default_rng(3)

    def rand_pose():
        w = rng.normal(size=3) * 0.2
        th = np.linalg.norm(w)
        k = w / max(th, 1e-9)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        return R.astype(np.float32), rng.normal(size=3).astype(np.float32)

    feats = _feats(4)
    (R0, t0), (R1, t1), (R2, t2) = rand_pose(), rand_pose(), rand_pose()
    k0 = m.add_keyframe(R0, t0, feats, 0.0)
    k1 = m.add_keyframe(R1, t1, feats, 1.0, parent=k0)
    k2 = m.add_keyframe(R2, t2, feats, 2.0, parent=k1)
    # a frame tracked against k2
    T_fw = _T(*rand_pose())
    slam.tracker.records.append(FrameRecord(5.0, k2, T_fw @ np.linalg.inv(_T(R2, t2)), False))
    # cull k2, then k1; then move k0: the export follows its anchor chain
    m.remove_keyframe(k2)
    m.remove_keyframe(k1)
    d = np.eye(4, dtype=np.float32)
    d[:3, 3] = [0.1, -0.2, 0.3]
    T_0w_new = d @ _T(R0, t0)
    m.kf_R[k0], m.kf_t[k0] = T_0w_new[:3, :3], T_0w_new[:3, 3]
    traj = slam.trajectory()
    assert len(traj) == 1
    _, T_cw = traj[0]
    np.testing.assert_allclose(T_cw, T_fw @ np.linalg.inv(_T(R0, t0)) @ T_0w_new, atol=1e-5)


def test_kf_pool_grows_past_capacity():
    m = MapState(MapConfig(max_kf=4, max_mp=16, n_feat=8, obs_cap=4))
    feats = _feats(8)
    for i in range(10):
        m.add_keyframe(np.eye(3, dtype=np.float32), np.float32([i, 0, 0]), feats, float(i))
    assert m.n_kf == 10 and m.cfg.max_kf >= 10
    assert m.kf_valid[:10].all()
    assert (m.kf_t[9] == np.float32([9, 0, 0])).all()
    ids = m.add_map_points(np.zeros((40, 3), np.float32), np.zeros((40, 8), np.uint32), 0,
                           np.arange(40) % 8)
    assert (ids >= 0).all() and m.cfg.max_mp >= 40
