"""Image tracking through a camera roll, in the port on the CPU: the twin of
`tests/test_inplane_rotation.py`. The camera rolls up to ~23 degrees about
its optical axis while it orbits textured scene 21 (36 rendered frames
through `SLAM.track_monocular`), so tracking lasts only if the descriptors
are steered by the keypoint angle and the rotation histogram keeps the
dominant-rotation matches. Both packages get the same frames (the JAX
package renders them).

Bounds: each package to the JAX test's bars (> 60 % of the frames tracked,
Sim(3) ATE < 6 cm), and the same outcome after the two-view init: both
track every frame after their own init. The sync twins' count tolerance
(`test_torch_slam.py::test_same_outcome_as_jax`: the same number of
tracked frames) does not apply here: the rolled frames give the two-view
init ~68 matches, where one RANSAC draw of either package succeeds about
one time in five (4 of 20 seeds each on frames 0 and 1), so the frame at
which each package initializes depends on its generator's draws (the JAX
package at frame 1, the port at frame 14 on these frames). The JAX tracker
runs under `jax_velocity_from_previous_frame` (ROADMAP C9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slam import JCAM, TCAM, jax_velocity_from_previous_frame
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

N_FRAMES = 36
CFG = dict(n_features=768, local_points_cap=2048, local_ba_points=1024,
           max_frames_between_kf=6, min_init_matches=50)


def _roll(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def rolled_runs():
    scene = jsynthetic.make_textured_scene(21)
    poses = []
    for i, (R, t) in enumerate(jsynthetic.circular_trajectory(N_FRAMES)):
        Rz = _roll(0.4 * np.sin(2 * np.pi * i / N_FRAMES))
        poses.append(((Rz @ R).astype(np.float32), (Rz @ t).astype(np.float32)))
    images = [jsynthetic.render_image(scene, JCAM, R, t) for R, t in poses]
    runs = {}
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
        else:
            slam = jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG))
        est = []
        with jax_velocity_from_previous_frame():
            for i, img in enumerate(images):
                pose = slam.track_monocular(img if pkg == "torch" else jnp.asarray(img), i * 0.05)
                if pose is not None:
                    est.append((i * 0.05, pose))
        runs[pkg] = (slam, est)
    return runs, jsynthetic.gt_trajectory(poses)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_tracking_survives_camera_roll(rolled_runs, pkg):
    runs, gt = rolled_runs
    _, est = runs[pkg]
    assert len(est) > 0.6 * N_FRAMES, len(est)
    rmse = evaluation.ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.06, rmse


def test_same_outcome_as_jax(rolled_runs):
    """Both packages track every frame from their init on."""
    runs, _ = rolled_runs
    for slam, est in runs.values():
        first = round(est[0][0] / 0.05)
        assert len(est) == N_FRAMES - first, (first, len(est))
        assert slam.n_keyframes() >= 3
