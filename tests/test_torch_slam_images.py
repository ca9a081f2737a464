"""Image-mode monocular SLAM through both packages at a reduced size:
20 uint8 frames of the synthetic two-plane scene (`make_textured_scene(7)`,
752x480 EuRoC cam0) along `circular_trajectory(200)`, 768 features,
`local_points_cap` and `local_ba_points` 1024, `min_init_matches` 50, loop
closing off, through `SLAM.track_monocular`: extraction, two-view
initialization, tracking, keyframes, local mapping and local BA.

The size is cut for the CPU: 512 features (or the 300-frame arc) do not
initialize within 20 frames in either package, so the run takes 768
features on a faster arc. Bounds: the packages draw their RANSAC sets from
different generators, so runs are compared by outcome: both reach ATE
< 5 cm, keyframe counts within 2, map points within 20 %."""

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic

torch.set_num_threads(1)

N_FRAMES = 20
CFG = dict(n_features=768, local_points_cap=1024, local_ba_points=1024,
           min_init_matches=50, enable_loop_closing=False)


@pytest.fixture(scope="module")
def sequence():
    cam = tcameras.euroc_cam0()
    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(200)[:N_FRAMES]
    frames = [np.clip(np.round(synthetic.render_image(scene, cam, *p)), 0, 255).astype(np.uint8)
              for p in poses]
    return frames, synthetic.gt_trajectory(poses)


def _run(slam, frames):
    est, init = [], None
    for i, img in enumerate(frames):
        pose = slam.track_monocular(img, i * 0.05)
        if pose is not None:
            init = i if init is None else init
            est.append((i * 0.05, pose))
    return est, init


@pytest.fixture(scope="module")
def runs(sequence):
    frames, _ = sequence
    t = tsystem.SLAM(tcameras.euroc_cam0(), tconfig.SlamConfig(**CFG), device="cpu")
    j = jsystem.SLAM(jcameras.euroc_cam0(), jconfig.SlamConfig(**CFG))
    return (t, *_run(t, frames)), (j, *_run(j, frames))


def test_port_initializes_maps_and_tracks(runs):
    (slam, est, init), _ = runs
    assert init is not None and init <= 5
    assert len(est) >= 0.9 * (N_FRAMES - init)
    assert slam.state == "OK"
    assert slam.n_keyframes() >= 3 and slam.n_map_points() > 200


def test_both_packages_reach_ate_under_5cm(runs, sequence):
    _, gt = sequence
    (ts, test, _), (js, jest, _) = runs
    assert evaluation.ate_rmse(test, gt) < 0.05
    assert evaluation.ate_rmse(ts.trajectory(), gt) < 0.05
    assert evaluation.ate_rmse(jest, gt) < 0.05


def test_same_map_size_as_jax(runs):
    (ts, _, _), (js, _, _) = runs
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 2
    assert abs(ts.n_map_points() - js.n_map_points()) <= 0.2 * js.n_map_points()
