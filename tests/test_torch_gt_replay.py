"""Replays of the reference's EuRoC MH01 ground truth through the port:
the twins of `tests/test_gt_replay.py` (4: the feature-level replay's
tracking and ATE, the loader, the IMU synthesis) and
`tests/test_image_stereo_replay.py` (1: rendered stereo images, metric
ATE). They skip, as the JAX files do, unless the reference's ground truth
is mounted (`orb_slam3_comments_ghr_tpu.utils.gt_replay.GT_DIR`); the port
reads that folder through `gt_dir`.

Bounds: the JAX tests' own bars (> 90 % tracked, one map, ATE < 5 cm; the
loader's orthonormality 1e-5 and inversion 1e-4; the preintegrated
rotation within 0.02 and position within 5 cm of the ground truth). The
loader and the IMU synthesis are also held to the JAX package's bit for
bit. The replays read `SLAM.n_map_resets` and the tracker's loss counters
where `scripts/run_gt_replay.py` reads them: none may fire on the real
motion profile."""

import os

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.utils import gt_replay as jgt
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.optim import imu as imu_mod
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import evaluation, gt_replay, synthetic
from orb_slam3_comments_ghr_torch.utils.config import STEREO, SlamConfig

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(jgt.GT_DIR, "MH01_GT.txt")),
    reason="reference EuRoC ground truth not mounted",
)

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()


def _gt():
    return gt_replay.load_euroc_gt("MH01", gt_dir=jgt.GT_DIR)


def _no_resets(slam):
    assert slam.n_map_resets == 0
    assert slam.tracker.n_lost_resets == 0 and slam.tracker.n_submap_spawns == 0


@pytest.fixture(scope="module")
def mh01_slice():
    times, R_cw, t_cw, p_wc, _ = _gt()
    n = 240  # the first 12 s: the hover and the first fast excursion
    world = gt_replay.make_hall_world(11, p_wc[:n], n_points=8000)
    slam = SLAM(CAM, SlamConfig(n_features=512, min_init_matches=50, max_frames_between_kf=10),
                device="cpu")
    tracked = 0
    for i in range(n):
        feats, _ = synthetic.render_features(world, CAM, R_cw[i], t_cw[i], n_feat=512,
                                             seed=1000 + i, device="cpu")
        if slam.track_features(feats, float(times[i])) is not None:
            tracked += 1
    return slam, tracked, n, gt_replay.gt_as_tum(times[:n], R_cw[:n], t_cw[:n])


def test_tracks_real_trajectory(mh01_slice):
    slam, tracked, n, _ = mh01_slice
    assert tracked > 0.9 * n
    assert slam.map.n_maps == 1
    _no_resets(slam)


def test_ate_against_reference_ground_truth(mh01_slice):
    slam, _, _, gt = mh01_slice
    ate = evaluation.ate_rmse(slam.trajectory(), gt, with_scale=True)
    assert ate < 0.05, ate


def test_gt_loader_roundtrip():
    times, R_cw, t_cw, p_wc, q_wc = _gt()
    assert len(times) > 3000 and abs(times[1] - times[0] - 0.05) < 1e-3
    i = 100
    assert np.allclose(R_cw[i] @ R_cw[i].T, np.eye(3), atol=1e-5)
    assert np.allclose(-R_cw[i].T @ t_cw[i], p_wc[i], atol=1e-4)
    for a, b in zip((times, R_cw, t_cw, p_wc, q_wc), jgt.load_euroc_gt("MH01")):
        assert np.array_equal(a, np.asarray(b))


def test_imu_synthesis_consistency():
    """Preintegrating the synthesized IMU between two ground-truth poses
    reproduces their relative rotation and, with the ground-truth velocity,
    their position change."""
    from scipy.interpolate import CubicSpline

    times, R_cw, _, p_wc, q_wc = _gt()
    n = 400
    rows = gt_replay.synthesize_imu(times[:n], p_wc[:n], q_wc[:n])
    assert np.array_equal(rows, jgt.synthesize_imu(times[:n], p_wc[:n], q_wc[:n]))
    calib = imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                             noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
    i0, i1 = 300, 340  # a 2 s window with real motion
    chunk = rows[(rows[:, 0] > times[i0]) & (rows[:, 0] <= times[i1])]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pre = imu_mod.preintegrate(f32(chunk[:, 1:4]), f32(chunk[:, 4:7]),
                               f32(np.diff(chunk[:, 0], prepend=times[i0])), torch.zeros(6), calib)
    R_wb0, R_wb1 = R_cw[i0].T, R_cw[i1].T
    assert np.abs(pre.dR.numpy() - R_wb0.T @ R_wb1).max() < 0.02
    dT = float(pre.dT)
    v0 = CubicSpline(times[:n], p_wc[:n], axis=0).derivative(1)(times[i0])
    g = np.array([0, 0, -gt_replay.GRAVITY])
    p1 = p_wc[i0] + v0 * dT + 0.5 * g * dT ** 2 + R_wb0 @ pre.dP.numpy()
    assert np.linalg.norm(p1 - p_wc[i1]) < 0.05


def test_image_mode_stereo_tracks_metric():
    times, R_cw, t_cw, p_wc, _ = _gt()
    n = 80  # the hover and the first translation
    scene = gt_replay.make_room_scene(11, p_wc[:n])
    slam = SLAM(CAM, SlamConfig(sensor=STEREO, n_features=640, min_init_matches=50,
                                max_frames_between_kf=10), device="cpu")
    b = float(CAM.bf) / float(CAM.fx)
    tracked = 0
    for i in range(n):
        img_l = gt_replay.render_room(scene, CAM, R_cw[i], t_cw[i])
        img_r = gt_replay.render_room(scene, CAM, R_cw[i], t_cw[i] - np.array([b, 0.0, 0.0],
                                                                             t_cw.dtype))
        if slam.track_stereo(img_l, img_r, float(times[i])) is not None:
            tracked += 1
    assert tracked > 0.9 * n
    assert slam.map.n_maps == 1
    _no_resets(slam)
    ate = evaluation.ate_rmse(slam.trajectory(), gt_replay.gt_as_tum(times[:n], R_cw[:n],
                                                                    t_cw[:n]), with_scale=False)
    assert ate < 0.05, ate
