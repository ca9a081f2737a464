"""Monocular fisheye (KB8) SLAM through the port, on the CPU: the twin of
`tests/test_fisheye.py::TestFisheyeMono::test_e2e_kb8`. 40 frames of
synthetic features rendered through the KB8 model (raw fisheye pixels),
undistorted to the virtual pinhole and tracked by `SLAM.track_features`,
in both packages (the JAX run under `jax_velocity_from_previous_frame`,
ROADMAP C9).

Bounds: the JAX test's bars for both runs (tracking at the end, > 30
poses, Sim(3) ATE < 6 cm), and the port within the JAX run's band: its ATE
no more than 2 cm above the JAX run's and its pose count within 3 (the two
packages draw their RANSAC sets from different generators, so the runs
part by float order, as in `test_torch_slam.py`)."""

import numpy as np
import pytest
import torch

from test_torch_slam import jax_velocity_from_previous_frame
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

N_FRAMES = 40
CFG = dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, min_init_matches=60)


def kb8_cam():
    """The fisheye of `tests/test_fisheye.py` (JAX package's Camera)."""
    return jcameras.Camera(
        kind=jcameras.KANNALA_BRANDT8, fx=380.0, fy=380.0, cx=376.0, cy=240.0,
        k1=0.01, k2=-0.002, k3=0.001, k4=-0.0005, width=752, height=480,
    )


def run(pkg):
    """(slam, estimates, ground truth) of one package on the JAX test's
    frames: the features are rendered by the JAX package through KB8 and
    undistorted by each package's own `undistort_points`."""
    jcam = kb8_cam()
    world = jsynthetic.make_world(51, n_points=3000)
    poses = jsynthetic.circular_trajectory(N_FRAMES)
    if pkg == "jax":
        slam, cam = jsystem.SLAM(jcam, jconfig.SlamConfig(**CFG)), jcam
    else:
        cam = convert.camera_from_jax(jcam)
        slam = tsystem.SLAM(cam, tconfig.SlamConfig(**CFG), device="cpu")
    est = []
    for i, (R, t) in enumerate(poses):
        feats, _ = jsynthetic.render_features(world, jcam, R, t, n_feat=512, seed=7100 + i)
        if pkg == "jax":
            feats = feats._replace(xy=jcameras.undistort_points(jcam, feats.xy))
        else:
            feats = convert.features_from_numpy(
                {k: np.asarray(v) for k, v in feats._asdict().items()}, device="cpu")
            feats = feats._replace(xy=tcameras.undistort_points(cam, feats.xy))
        pose = slam.track_features(feats, i * 0.05)
        if pose is not None:
            est.append((i * 0.05, pose))
    return slam, est, jsynthetic.gt_trajectory(poses)


@pytest.fixture(scope="module")
def runs():
    with jax_velocity_from_previous_frame():
        jax_run = run("jax")
    return run("torch"), jax_run


def test_e2e_kb8_twin_of_jax(runs):
    (ts, test, gt), (js, jest, _) = runs
    ates = []
    for slam, est in ((ts, test), (js, jest)):
        assert slam.state == "OK"
        assert len(est) > 30
        ates.append(evaluation.ate_rmse(est, gt, with_scale=True))
    assert max(ates) < 0.06, ates
    assert ates[0] < ates[1] + 0.02, ates
    assert abs(len(test) - len(jest)) <= 3, (len(test), len(jest))


def test_far_fisheye_keypoints_do_not_break_the_init():
    """ROADMAP C11: a fisheye keypoint near 90 degrees off the axis
    undistorts to 1e5-5e6 px; one such match in the two-view init
    dominates the Hartley normalization and the reconstruction fails. The
    port's `_initialize_mono` leaves matches more than an image size outside
    the virtual image out of it. Two frames of synthetic features (the
    monocular twin's world) with a pair of far-off keypoints planted on one
    shared landmark: the reconstruction over every match fails, the
    tracker's init succeeds and triangulates no far point."""
    from orb_slam3_comments_ghr_torch.map.state import MapConfig, MapState
    from orb_slam3_comments_ghr_torch.ops import matching
    from orb_slam3_comments_ghr_torch.optim import twoview
    from orb_slam3_comments_ghr_torch.pipeline import tracker as ttracker
    from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

    cam = tcameras.euroc_cam0()
    world = tsynthetic.make_world(3, n_points=3000)
    poses = tsynthetic.circular_trajectory(40)
    (f1, ids1), (f2, ids2) = (tsynthetic.render_features(world, cam, *poses[i], n_feat=512,
                                                         seed=100 + i, device="cpu") for i in (0, 8))
    pairs = [(int(np.nonzero(ids1 == w)[0][0]), int(np.nonzero(ids2 == w)[0][0]))
             for w in np.intersect1d(ids1, ids2)]
    a, b = next((i, j) for i, j in pairs if f1.level[i] == 0 and f2.level[j] == 0)
    far = torch.tensor([4.0e6, -3.0e6])  # as the TUM-VI rim undistorts
    f1.xy[a], f2.xy[b] = far, far + 20.0
    idx, _, ok = matching.search_for_initialization(f1, f2, window=100.0, ratio=0.9)
    assert bool(ok[a]) and int(idx[a]) == b
    plain = twoview.reconstruct(cam, f1.xy, f2.xy[idx.long()], ok, torch.Generator().manual_seed(0))
    assert not bool(plain.success)
    cfg = tconfig.SlamConfig(n_features=512, min_init_matches=60)
    m = MapState(MapConfig(max_kf=8, max_mp=2048, n_feat=512))
    tr = ttracker.Tracker(cam, cfg, m, device="cpu")
    assert not tr._initialize_mono(f1, 0.0)
    assert tr._initialize_mono(f2, 0.4)
    assert m.n_kf == 2 and m.kf_feat_mp[0, a] < 0 and len(m.mp_ids()) > 60
