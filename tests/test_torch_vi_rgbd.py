"""The twin of `tests/test_rgbd_inertial.py` through the port, on the CPU:
rendered image frames of `make_textured_scene(61)` along `vi_sequence(60)`
with the exact depth maps and the IMU rows, `SLAM.track_rgbd(...,
imu_samples=...)` under `IMU_RGBD` (the real extractor, the RGB-D
conversion, the inertial tracker and mapper). The IMU must initialize
(gravity and bias; depth gives the scale) and the trajectory be metric with
no scale fit: the test's bars, > 45 frames tracked and ATE < 12 cm.

Shorter than the JAX test, and the port alone, for the suite's time: an
image frame costs ~2.5 s on one CPU thread, so the run stops at frame 50
(the IMU initializes at frame 35; the bars stand as they are), and the JAX
package's run of the same frames would double the file.
`scripts/vi_slam_cpu.py --sensor imu_rgbd` runs both packages on all 60
frames, and `chip_smoke.py` phase 8 runs the port on them on the card;
their results stand side by side in PERF.md."""

import numpy as np
import torch

from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.optim import imu as imu_mod
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import config, evaluation, synthetic

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()
CALIB = imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                         noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)


def test_e2e_imu_rgbd_images():
    scene = synthetic.make_textured_scene(61)
    n_frames = 50
    poses, imu_rows, times = synthetic.vi_sequence(60)
    poses = poses[:n_frames]
    cfg = config.SlamConfig(sensor=config.IMU_RGBD, n_features=768, local_points_cap=2048,
                            local_ba_points=2048, max_frames_between_kf=5,
                            enable_loop_closing=False)
    slam = SLAM(CAM, cfg, imu_calib=CALIB, device="cpu")
    est = []
    for i, (R, t) in enumerate(poses):
        chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1)) & (imu_rows[:, 0] <= times[i])]
        img = np.clip(np.round(synthetic.render_image(scene, CAM, R, t)), 0, 255).astype(np.uint8)
        pose = slam.track_rgbd(img, synthetic.depth_map(scene, CAM, R, t), times[i],
                               imu_samples=chunk if len(chunk) else None)
        if pose is not None:
            est.append((times[i], pose))
    assert slam.map.map_imu_init.get(slam.map.active_map, False), \
        "IMU never initialized in IMU_RGBD mode"
    assert len(est) > 45
    gt = [(times[i], np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))
          for i, (R, t) in enumerate(poses)]
    # depth makes the map metric from frame 1: no scale fit allowed
    rmse = evaluation.ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.12, rmse


def test_feed_requires_inertial_config():
    slam = SLAM(CAM, config.SlamConfig(sensor=config.IMU_RGBD, n_features=256,
                                       enable_loop_closing=False), imu_calib=CALIB, device="cpu")
    assert slam.cfg.is_inertial and slam.imu is not None
