"""Non-rectified fisheye stereo through the port, on the CPU: the twins of
the six cases of `tests/test_fisheye_stereo.py`, each run in both
packages on the same seeded inputs:
- `fisheye_stereo_depth` (epipolar match, DLT triangulation, the depth and
  reprojection gates) on 512 points seen by both cameras of the KB8 pair,
  and on unrelated descriptors;
- the second-camera factor of the visual BA (`BAProblem.obs_rig`): points
  seen only by the right camera converge, and do not without their right
  rows; the chunked whole-map solver equals the dense one with the rig;
- `SLAM.track_stereo_fisheye` end to end (40 frames of rendered
  features, sensor STEREO), with right-camera rows in the map and in the
  BA tables.

Bounds: `fisheye_stereo_depth` equals the JAX function up to ties: the
same matches on every left keypoint whose best right candidate is not tied
(>= 99 %), depths within 1e-4 relative where both accept; the JAX test's
bars on both. The BA cases: the JAX test's bars on both packages, and the
solved points within 1e-3 m of the JAX solve (float32 LMs summing in
another order). The end-to-end run: the JAX test's bars (> 50 right rows,
> 30 poses, metric ATE < 10 cm, the right rows in columns [D, 2D) of the
BA tables with obs_rig = 1) on both packages, and the port's ATE no more
than 2 cm above the JAX run's."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slam import jax_velocity_from_previous_frame
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import ba as jba
from orb_slam3_comments_ghr_tpu.pipeline import mapper as jmapper, programs as jprograms
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.optim import ba as tba
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper, programs as tprograms
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)


def kb8_pair():
    """The KB8 pair of `tests/test_fisheye_stereo.py` (JAX Cameras) and its
    extrinsics x_l = R_lr x_r + t_lr."""
    cam_l = jcameras.Camera(
        kind=jcameras.KANNALA_BRANDT8, fx=380.0, fy=380.0, cx=376.0, cy=240.0,
        k1=0.01, k2=-0.002, k3=0.001, k4=-0.0005, width=752, height=480,
    )
    cam_r = jcameras.Camera(
        kind=jcameras.KANNALA_BRANDT8, fx=382.0, fy=382.0, cx=370.0, cy=244.0,
        k1=0.012, k2=-0.001, k3=0.0008, k4=-0.0004, width=752, height=480,
    )
    R_lr = np.asarray(jlie.so3_exp(jnp.array([0.0, 0.02, 0.0])), np.float32)
    t_lr = np.array([0.11, 0.001, -0.002], np.float32)
    return cam_l, cam_r, R_lr, t_lr


def _depth_both(xy1, d1, ok1, xy2, d2, ok2):
    """`fisheye_stereo_depth` of both packages on raw pixels (undistorted by
    each package), levels 0. Returns ((depth, ridx, matched) numpy) x 2."""
    cam_l, cam_r, R_lr, t_lr = kb8_pair()
    n1, n2 = len(xy1), len(xy2)
    j = jprograms.fisheye_stereo_depth(
        jcameras.pinhole_equivalent(cam_l), jcameras.pinhole_equivalent(cam_r),
        jcameras.undistort_points(cam_l, jnp.asarray(xy1)), jnp.zeros(n1, jnp.int32),
        jnp.asarray(d1), jnp.asarray(ok1),
        jcameras.undistort_points(cam_r, jnp.asarray(xy2)), jnp.zeros(n2, jnp.int32),
        jnp.asarray(d2), jnp.asarray(ok2), jnp.asarray(R_lr), jnp.asarray(t_lr))
    tl, tr = convert.camera_from_jax(cam_l), convert.camera_from_jax(cam_r)
    t = tprograms.fisheye_stereo_depth(
        tcameras.pinhole_equivalent(tl), tcameras.pinhole_equivalent(tr),
        tcameras.undistort_points(tl, torch.tensor(xy1)), torch.zeros(n1, dtype=torch.int32),
        convert.desc_tensor(d1, "cpu"), torch.from_numpy(ok1),
        tcameras.undistort_points(tr, torch.tensor(xy2)), torch.zeros(n2, dtype=torch.int32),
        convert.desc_tensor(d2, "cpu"), torch.from_numpy(ok2),
        torch.from_numpy(R_lr), torch.from_numpy(t_lr))
    return tuple(a.numpy() for a in t), tuple(np.asarray(a) for a in j)


def test_recovers_metric_depth():
    cam_l, cam_r, R_lr, t_lr = kb8_pair()
    rng = np.random.default_rng(0)
    N = 512
    uv_seed = rng.random((N, 2)).astype(np.float32) * [650, 420] + 50
    rays = np.asarray(jcameras.unproject(jcameras.pinhole_equivalent(cam_l), jnp.asarray(uv_seed)))
    z_true = (rng.random(N).astype(np.float32) * 6 + 3)
    X_l = rays * z_true[:, None]
    X_r = (X_l - t_lr) @ R_lr
    uv_l = np.asarray(jcameras.project(cam_l, jnp.asarray(X_l)))
    uv_r = np.asarray(jcameras.project(cam_r, jnp.asarray(X_r)))
    ok = (np.asarray(jcameras.in_image(cam_l, jnp.asarray(uv_l), 8.0))
          & np.asarray(jcameras.in_image(cam_r, jnp.asarray(uv_r), 8.0)))
    desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    (d, rid, rm), (jd, jrid, jrm) = _depth_both(uv_l, desc, ok, uv_r, desc, ok)
    for depth, ridx, matched in ((d, rid, rm), (jd, jrid, jrm)):  # the JAX test's bars
        assert (ridx[matched] == np.nonzero(matched)[0]).mean() > 0.95
        got = depth > 0
        assert got.sum() > 0.8 * ok.sum()
        assert np.median(np.abs(depth[got] - z_true[got]) / z_true[got]) < 0.01
    assert (rm == jrm).mean() >= 0.99 and (rid[rm & jrm] == jrid[rm & jrm]).all()
    both = (d > 0) & (jd > 0)
    np.testing.assert_allclose(d[both], jd[both], rtol=1e-4)


def test_no_matches_without_overlap():
    rng = np.random.default_rng(1)
    N = 256
    xy = rng.random((N, 2)).astype(np.float32) * 400 + 100
    d1 = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    ok = np.ones(N, bool)
    (d, _, rm), (jd, _, jrm) = _depth_both(xy, d1, ok, xy, d2, ok)
    assert int((d > 0).sum()) < 10 and int((jd > 0).sum()) < 10
    np.testing.assert_array_equal(rm, jrm)


# --------------------------------------------------- the second-camera factor
def _rig_problem(right_only_n=8, with_right=True):
    """`TestSecondCameraFactor._problem` of the JAX test: 4 fixed cameras,
    64 points, 6 observations each, the first 8 points seen only by the
    right camera. Returns (JAX problem, port problem, true points, JAX
    camera, port camera)."""
    rng = np.random.default_rng(3)
    cam_l, _, R_lr, t_lr = kb8_pair()
    cam = jcameras.pinhole_equivalent(cam_l)
    R_rl = R_lr.T
    t_rl = -R_lr.T @ t_lr
    K, P, D = 4, 64, 6
    cam_R = np.stack([np.asarray(jlie.so3_exp(jnp.array([0.0, 0.05 * k, 0.0])))
                      for k in range(K)]).astype(np.float32)
    cam_t = (rng.random((K, 3)).astype(np.float32) - 0.5) * 0.2
    uv_seed = rng.random((P, 2)).astype(np.float32) * [600, 400] + 70
    rays = np.asarray(jcameras.unproject(cam, jnp.asarray(uv_seed)))
    z = rng.random(P).astype(np.float32) * 5 + 4
    p_true = (rays * z[:, None] - cam_t[0]) @ cam_R[0]
    obs_cam = np.tile(np.arange(D, dtype=np.int32)[None] % K, (P, 1))
    obs_rig = np.zeros((P, D), np.int32)
    obs_rig[:right_only_n] = 1
    pc0 = np.einsum("pdij,pj->pdi", cam_R[obs_cam], p_true) + cam_t[obs_cam]
    pc = np.where(obs_rig[..., None] == 1, np.einsum("ij,pdj->pdi", R_rl, pc0) + t_rl, pc0)
    uv = np.asarray(jcameras.project(cam, jnp.asarray(pc)))
    obs_valid = (pc[..., 2] > 0.5) & np.asarray(jcameras.in_image(cam, jnp.asarray(uv), -1e5))
    if not with_right:
        obs_valid[:right_only_n] = False
    arrays = dict(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=np.ones(K, bool),
        p=(p_true + rng.normal(0, 0.08, (P, 3)).astype(np.float32)), p_valid=np.ones(P, bool),
        obs_cam=obs_cam, obs_uv=uv.astype(np.float32), obs_ur=np.full((P, D), -1.0, np.float32),
        obs_level=np.zeros((P, D), np.int32), obs_valid=obs_valid, obs_rig=obs_rig,
        rig_R=np.stack([np.eye(3, dtype=np.float32), R_rl]),
        rig_t=np.stack([np.zeros(3, np.float32), t_rl]).astype(np.float32),
    )
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return (jprob, convert.ba_problem_from_numpy(arrays, device="cpu"), p_true, cam,
            convert.camera_from_jax(cam))


def test_right_only_points_constrained():
    jprob, tprob, p_true, jcam, tcam = _rig_problem()
    jp = np.asarray(jba.bundle_adjust(jcam, jprob, iters=12)[2])
    tp = tba.bundle_adjust(tcam, tprob, iters=12)[2].numpy()
    for p in (tp, jp):
        err = np.linalg.norm(p - p_true, axis=-1)
        assert float(err[:8].max()) < 0.01, err[:8]
        assert float(err[8:].max()) < 0.01, err[8:].max()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)


def test_without_right_obs_unconstrained():
    jprob, tprob, p_true, jcam, tcam = _rig_problem(with_right=False)
    jp = np.asarray(jba.bundle_adjust(jcam, jprob, iters=12)[2])
    tp = tba.bundle_adjust(tcam, tprob, iters=12)[2].numpy()
    for p in (tp, jp):
        assert float(np.linalg.norm(p - p_true, axis=-1)[:8].min()) > 0.01
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)


def test_chunked_gba_matches_dense_with_rig():
    jprob, tprob, _, jcam, tcam = _rig_problem()
    lam0 = 1e-4
    pd = tba.bundle_adjust_step(tcam, tprob, torch.tensor(lam0), iters=4)[2].numpy()
    pc = tba.bundle_adjust_resumable(tcam, tprob, torch.tensor(lam0), iters=4,
                                     point_chunk=32)[2].numpy()
    np.testing.assert_allclose(pd, pc, atol=5e-3)  # the JAX test's bound
    jpc = np.asarray(jba.bundle_adjust_resumable(jcam, jprob, jnp.asarray(lam0, jnp.float32),
                                                 iters=4, point_chunk=32)[2])
    np.testing.assert_allclose(pc, jpc, rtol=0, atol=1e-3)


# ----------------------------------------------------------------- end to end
N_FRAMES = 40
CFG = dict(sensor=jconfig.STEREO, n_features=768, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, enable_loop_closing=False)


def run(pkg):
    """(slam, estimates, ground truth) of one package on the JAX test's
    frames: both views rendered by the JAX package through their KB8
    models, fed as raw-pixel features to `track_stereo_fisheye`."""
    cam_l, cam_r, R_lr, t_lr = kb8_pair()
    cam_l = replace(cam_l, bf=float(cam_l.fx) * float(t_lr[0]))
    world = jsynthetic.make_world(21, n_points=5000, center=(0.0, 0.0, 6.0),
                                  extent=(20.0, 12.0, 9.0))
    poses = jsynthetic.circular_trajectory(N_FRAMES, radius=2.5)
    if pkg == "jax":
        slam, cam_right = jsystem.SLAM(cam_l, jconfig.SlamConfig(**CFG)), cam_r
    else:
        slam = tsystem.SLAM(convert.camera_from_jax(cam_l), tconfig.SlamConfig(**CFG),
                            device="cpu")
        cam_right = convert.camera_from_jax(cam_r)
    R_rl, t_rl = R_lr.T, -R_lr.T @ t_lr
    est = []
    for i, (R, t) in enumerate(poses):
        fl, _ = jsynthetic.render_features(world, cam_l, R, t, n_feat=768, seed=910 + i)
        fr, _ = jsynthetic.render_features(world, cam_r, (R_rl @ R).astype(np.float32),
                                           (R_rl @ t + t_rl).astype(np.float32), n_feat=768,
                                           seed=5910 + i)
        if pkg == "torch":
            fl, fr = (convert.features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()},
                                                  device="cpu") for f in (fl, fr))
        pose = slam.track_stereo_fisheye(None, None, cam_right, R_lr, t_lr, i * 0.05,
                                         features=(fl, fr))
        if pose is not None:
            est.append((i * 0.05, pose))
    return slam, est, jsynthetic.gt_trajectory(poses)


@pytest.fixture(scope="module")
def stereo_runs():
    with jax_velocity_from_previous_frame():
        jax_run = run("jax")
    return run("torch"), jax_run


def test_e2e_with_right_observations(stereo_runs):
    ates = []
    for (slam, est, gt), build in zip(stereo_runs, (tmapper._build_obs_tables,
                                                     jmapper._build_obs_tables)):
        m = slam.map
        assert m.rig is not None
        n_right = int((m.mp_obs_r_level >= 0).sum())
        assert n_right > 50, n_right
        assert len(est) > 30
        ates.append(evaluation.ate_rmse(est, gt, with_scale=False))
        kfs = [int(k) for k in m.kf_ids()]
        pts = m.local_point_ids(kfs, None)
        tabs = build(m, pts, {c: i for i, c in enumerate(kfs)}, len(pts))
        obs_valid, obs_rig = tabs[4], tabs[5]
        D = m.cfg.obs_cap
        assert int(obs_valid[:, D:].sum()) > 50
        assert (obs_rig[:, D:] == 1).all()
    assert max(ates) < 0.10, ates
    assert ates[0] < ates[1] + 0.02, ates
