"""Image-mode RGB-D SLAM through both packages: the twin of
`tests/test_rgbd.py`, cut for the CPU to 768 features and 14 frames.
`SLAM.track_rgbd` takes uint8 renders of `make_textured_scene(61)` along
`circular_trajectory(40)` with the exact depth map (`synthetic.depth_map`):
extraction, virtual right coordinates, depth-seeded initialization,
tracking, keyframes and local mapping.

The JAX tracker runs with the reference's count of stereo observations, as
the port's does (see `tests/test_torch_stereo_slam.py`). Bounds: runs are
compared by outcome, since the pose and BA LMs sum in another order than
XLA (float32): both initialize on the first frame and track every frame,
keyframe counts within 1, metric ATE (no scale fit) < 8 cm in both and
within 5 mm of each other."""

import numpy as np
import pytest
import torch

from test_torch_stereo_slam import ATE_GAP, JCAM, TCAM, _jax_counts_stereo_twice
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic

torch.set_num_threads(1)

N_FRAMES = 14
CFG = dict(sensor=tconfig.RGBD, n_features=768, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, enable_loop_closing=False)


@pytest.fixture(scope="module")
def runs():
    scene = synthetic.make_textured_scene(61)
    poses = synthetic.circular_trajectory(40)[:N_FRAMES]
    ts = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    js = jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG))
    est_t, est_j = [], []
    with _jax_counts_stereo_twice():
        for i, (R, t) in enumerate(poses):
            img = np.clip(np.round(synthetic.render_image(scene, TCAM, R, t)), 0, 255).astype(np.uint8)
            depth = synthetic.depth_map(scene, TCAM, R, t)
            for slam, est in ((ts, est_t), (js, est_j)):
                pose = slam.track_rgbd(img, depth, i * 0.05)
                if pose is not None:
                    est.append((i * 0.05, pose))
    return (ts, est_t), (js, est_j), synthetic.gt_trajectory(poses)


def test_port_tracks_every_frame_and_maps(runs):
    (ts, est_t), _, _ = runs
    assert ts.state == "OK" and len(est_t) == N_FRAMES
    assert ts.n_keyframes() >= 2 and ts.n_map_points() > 500


def test_same_outcome_as_jax(runs):
    (ts, est_t), (js, est_j), gt = runs
    assert js.state == "OK" and len(est_j) == N_FRAMES
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    ate_t = evaluation.ate_rmse(est_t, gt, with_scale=False)  # metric: no scale fit
    ate_j = evaluation.ate_rmse(est_j, gt, with_scale=False)
    assert ate_t < 0.08 and ate_j < 0.08, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < ATE_GAP, (ate_t, ate_j)
    assert evaluation.ate_rmse(ts.trajectory(), gt, with_scale=False) < 0.08
