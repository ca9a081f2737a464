"""The twin of `tests/test_vi_pipeline.py` through the port, on the CPU,
against the JAX package: 80 frames of rendered monocular features (512)
with the IMU rows of `vi_sequence`, `SLAM.track_features`, `IMU_MONOCULAR`.
The IMU initialization must recover gravity and the metric scale (its
`optimize_scale` path), in both packages.

Bounds: the test's own bars in both packages (IMU initialized, > 60 frames
tracked, after the init a Sim(3)-aligned ATE < 8 cm and a metric ATE < 25
cm, finite keyframe velocities); against each other, by outcome (float32
LMs summing in another order than XLA): the IMU initialized at the same
keyframe time, the same tracked count, keyframes within 1, and the
post-init ATEs within 5 mm."""

import numpy as np
import pytest
import torch

from test_torch_vi_ba_outliers import jax_vi_ba_erases_outliers
from test_torch_vi_slam import run
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

# tests/test_vi_pipeline.py
CFG = dict(sensor=tconfig.IMU_MONOCULAR, n_features=512, local_points_cap=2048,
           local_ba_points=2048, max_frames_between_kf=5, min_init_matches=60,
           enable_loop_closing=False)


@pytest.fixture(scope="module")
def mono_runs():
    with jax_vi_ba_erases_outliers():  # the port's VI-BA erase (ROADMAP C10)
        jax_run = run("jax", CFG, 31, 80, 4100, False)
    return {"torch": run("torch", CFG, 31, 80, 4100, False), "jax": jax_run}


def _post_init_ates(slam, est, gt):
    t_init = slam.mapper.t_imu_init
    assert t_init is not None
    est_post = [(t, T) for t, T in est if t > t_init]
    gt_post = [(t, T) for t, T in gt if t > t_init]
    return (evaluation.ate_rmse(est_post, gt_post, with_scale=True),
            evaluation.ate_rmse(est_post, gt_post, with_scale=False))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_imu_initialized(mono_runs, pkg):
    slam = mono_runs[pkg][0]
    assert slam.map.map_imu_init.get(slam.map.active_map, False)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_metric_scale_recovered(mono_runs, pkg):
    """After the IMU init the monocular map is metric: small ATE without a
    scale fit, on the post-init segment."""
    slam, est, gt = mono_runs[pkg]
    assert len(est) > 60
    scaled, metric = _post_init_ates(slam, est, gt)
    assert scaled < 0.08, scaled
    assert metric < 0.25, metric


def test_gravity_aligned(mono_runs):
    m = mono_runs["torch"][0].map
    assert np.all(np.isfinite(m.kf_vel[m.kf_ids()]))


def test_mono_inertial_twin_of_jax(mono_runs):
    (ts, test, gt), (js, jest, _) = mono_runs["torch"], mono_runs["jax"]
    assert ts.mapper.t_imu_init == js.mapper.t_imu_init
    assert len(test) == len(jest)
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    for a, b in zip(_post_init_ates(ts, test, gt), _post_init_ates(js, jest, gt)):
        assert abs(a - b) < 0.005, (a, b)
