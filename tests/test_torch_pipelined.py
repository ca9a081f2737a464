"""The deep-pipelined monocular tracker of the port, on the CPU: the two
cases of `tests/test_pipelined.py` (36 rendered 752x480 frames through
`SLAM.track_monocular_pipelined`, the JAX run beside the port's in one
module fixture; the latency of `pipeline_depth` frames and
`flush_pipeline`), and its pieces against the JAX package: `chain_seed` on
random inputs (both branches, within 1e-6) and `Tracker.prepare_frame(steps=3)`
on the same tracker state (within 1e-5).

Bounds: each package to the JAX test's bars (> 25 poses returned, > 25
trajectory entries, Sim(3) ATE < 5 cm, `worker_errors == 0`), and the two
runs return the same number of poses. Both packages share the frames (the
JAX package renders them).

`tests/test_stereo_pipelined.py` (60 stereo-inertial image frames through
`track_stereo_pipelined`) costs more than Tier-1 can take in either
package on the CPU; the port's run goes to the card instead, as
`chip_smoke.py` phase 14 (c), to that test's bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_global_ba import _feats
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms, tracker as jtracker
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms, tracker as ttracker
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

JCAM, TCAM = jcameras.euroc_cam0(), tcameras.euroc_cam0()
CFG = dict(n_features=768, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, min_init_matches=60)


def _slam(pkg: str):
    return (tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu") if pkg == "torch"
            else jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG)))


@pytest.fixture(scope="module")
def pipelined_runs():
    scene = jsynthetic.make_textured_scene(61)
    poses = jsynthetic.circular_trajectory(36)
    images = [jsynthetic.render_image(scene, JCAM, R, t) for R, t in poses]
    runs = {}
    for pkg in ("jax", "torch"):
        slam = _slam(pkg)
        n_out = 0
        for i, img in enumerate(images):
            if slam.track_monocular_pipelined(img if pkg == "torch" else jnp.asarray(img),
                                              i * 0.05) is not None:
                n_out += 1
        if slam.flush_pipeline() is not None:
            n_out += 1
        slam.wait_idle()
        runs[pkg] = (slam, n_out)
    return runs, jsynthetic.gt_trajectory(poses)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_pipelined_matches_sync_quality(pipelined_runs, pkg):
    runs, gt = pipelined_runs
    slam, n_out = runs[pkg]
    assert slam.worker_errors == 0
    traj = slam.trajectory()
    assert n_out > 25
    assert len(traj) > 25
    rmse = evaluation.ate_rmse(traj, gt, with_scale=True)
    assert rmse < 0.05, rmse
    assert n_out == runs["jax"][1]


def test_pipeline_latency_is_depth_frames():
    """The first `pipeline_depth` calls return None (frames in flight);
    flush_pipeline retires them all."""
    scene = jsynthetic.make_textured_scene(61)
    poses = jsynthetic.circular_trajectory(6)
    slam = _slam("torch")
    depth = slam.cfg.pipeline_depth
    for k in range(depth):
        img = jsynthetic.render_image(scene, JCAM, *poses[k])
        assert slam.track_monocular_pipelined(img, k * 0.05) is None
    slam.flush_pipeline()
    assert slam.tracker.frame_id >= depth - 1  # frames consumed (ids from -1)
    assert not slam._pipe


@pytest.mark.parametrize("n_prev", [250, 3])  # above and below min_matches
def test_chain_seed_against_jax(n_prev):
    rng = np.random.default_rng(n_prev)
    rot = lambda: np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    args = [rot(), rng.normal(size=3).astype(np.float32), np.int32(n_prev), rot(),
            rng.normal(size=3).astype(np.float32), rot(), rng.normal(size=3).astype(np.float32)]
    R, t = tprograms.chain_seed(*(torch.as_tensor(a) for a in args), min_matches=15)
    jR, jt = jprograms.chain_seed(*(jnp.asarray(a) for a in args), min_matches=15)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R.numpy(), args[3] @ args[0] if n_prev >= 15 else args[5],
                               rtol=0, atol=1e-6)


def _one_keyframe_tracker(pkg: str):
    """A tracker in state OK on a map of one keyframe with 40 points, its
    last pose and constant-velocity model set alike in both packages."""
    rng = np.random.default_rng(5)
    mc = dict(max_kf=8, max_mp=256, n_feat=256, obs_cap=8)
    m = (tstate.MapState(tstate.MapConfig(**mc)) if pkg == "torch"
         else jstate.MapState(jstate.MapConfig(**mc)))
    kf = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), _feats(), 0.0)
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (40, 3)).astype(np.float32)
    ids = m.add_map_points(pts, rng.integers(0, 2**32, (40, 8), dtype=np.uint32), kf,
                           np.arange(40))
    m.update_point_geometry(ids)
    cfg = dict(CFG, n_features=256)
    t = (ttracker.Tracker(TCAM, tconfig.SlamConfig(**cfg), m, device="cpu") if pkg == "torch"
         else jtracker.Tracker(JCAM, jconfig.SlamConfig(**cfg), m))
    a = 0.02
    vel = np.eye(4, dtype=np.float32)
    vel[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    vel[:3, 3] = [0.03, -0.01, 0.02]
    t.state, t.last_kf, t.velocity, t.last_time = ttracker.OK, kf, vel, 0.95
    t.last_R = vel[:3, :3].T.copy()
    t.last_t = np.array([0.1, 0.0, -0.05], np.float32)
    return t


def test_prepare_frame_steps_against_jax():
    tt, jt = _one_keyframe_tracker("torch"), _one_keyframe_tracker("jax")
    ready, lp, ids, R0, t0 = tt.prepare_frame(1.0, steps=3)
    jready, jlp, jids, jR0, jt0 = jt.prepare_frame(1.0, steps=3)
    assert ready and jready and np.array_equal(ids, jids)
    np.testing.assert_allclose(R0.numpy(), np.asarray(jR0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.pos.numpy(), np.asarray(jlp.pos), rtol=0, atol=1e-5)
    assert tt._prepared_th == jt._prepared_th
    # three constant-velocity steps from the last pose
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = tt.last_R, tt.last_t
    T3 = np.linalg.matrix_power(tt.velocity.astype(np.float64), 3) @ T
    np.testing.assert_allclose(R0.numpy(), T3[:3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t0.numpy(), T3[:3, 3], rtol=0, atol=1e-5)
    # the context a deep pipeline keeps for the frame comes back as it was
    ctx = tt.capture_frame_context()
    tt.prepare_frame(1.05, steps=1)
    tt.restore_frame_context(ctx)
    assert tt._prepared_ts == 1.0 and tt._prepared[3] is ctx[1][3]
