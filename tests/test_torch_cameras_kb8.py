"""The port's Kannala-Brandt (KB8) fisheye model against the JAX package,
on the CPU: the twins of `tests/test_cameras.py::TestKB8` (3) and
`tests/test_fisheye.py::TestUndistortion` (2), and one frame of
`programs.extract_and_track(undistort=True)` on a rendered KB8 image.

Bounds: projections within 1e-3 px of the JAX package's (float32
`atan2` / `sqrt` in another library), the Newton unprojection's bearings
within 1e-5, and the JAX tests' own bars on the port; the closed-form
Jacobian within 1e-4 (relative to 1 + |J|) of JAX's `jacfwd` of the same
projection. The frame: the raw keypoints (level, descriptor, validity and
the raw pixel before undistortion) bit-equal on >= 98 % of slots, as
`test_torch_programs.py` holds the pinhole extraction; the undistorted
keypoints within 1e-3 px of the JAX package's where the raw ones are
equal; the pose within 1e-4, `match_feat` equal on >= 99 % of rows,
`n_inliers` within 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fisheye import kb8_cam
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)


def _tum_vi_kb8():
    """`tests/test_cameras.py`'s TUM-VI-style fisheye (JAX Camera)."""
    return jcameras.Camera(
        kind=jcameras.KANNALA_BRANDT8, fx=190.978, fy=190.973, cx=254.931, cy=256.897,
        k1=0.00348238, k2=0.000715034, k3=-0.00205323, k4=0.000202936, width=512, height=512,
    )


def _both(jcam):
    return jcam, convert.camera_from_jax(jcam)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ----------------------------------------------- tests/test_cameras.py::TestKB8
def test_project_unproject():
    jcam, tcam = _both(_tum_vi_kb8())
    dirs = np.array(jax.random.normal(jax.random.PRNGKey(1), (128, 3)))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.2  # within ~60 degrees of the axis
    uv = tcameras.project(tcam, _t(dirs))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jcameras.project(jcam, jnp.asarray(dirs))),
                               rtol=0, atol=1e-3)
    ray = tcameras.unproject(tcam, uv)
    np.testing.assert_allclose(ray.numpy(), np.asarray(jcameras.unproject(jcam, jnp.asarray(uv.numpy()))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcameras.project(tcam, ray).numpy(), uv.numpy(), atol=1e-2)


def test_jacobian_matches_autodiff():
    jcam, tcam = _both(_tum_vi_kb8())
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(256, 3)).astype(np.float32)
    pc[:, 2] = np.abs(pc[:, 2]) + 0.2
    pc[:2] = [[0.3, -0.2, 1.5], [0.0, 0.0, 2.0]]  # the JAX test's points (the second on axis)
    J = tcameras.project_jac(tcam, _t(pc)).numpy()
    J_ad = np.asarray(jax.vmap(jax.jacfwd(lambda p: jcameras.project(jcam, p)))(jnp.asarray(pc)))
    np.testing.assert_allclose(J[:2], J_ad[:2], atol=1e-4)
    assert np.max(np.abs(J - J_ad) / (1 + np.abs(J_ad))) < 1e-4


def test_wide_angle():
    jcam, tcam = _both(_tum_vi_kb8())
    pc = np.array([1.0, 0.0, 0.36], np.float32)  # ~70 degrees off the axis
    uv = tcameras.project(tcam, _t(pc))
    assert bool(tcameras.in_image(tcam, uv))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jcameras.project(jcam, jnp.asarray(pc))),
                               rtol=0, atol=1e-3)


# ------------------------------------ tests/test_fisheye.py::TestUndistortion
def test_roundtrip_to_pinhole():
    jcam, tcam = _both(kb8_cam())
    rays = np.array(jax.random.normal(jax.random.PRNGKey(0), (128, 3)))
    rays[:, 2] = np.abs(rays[:, 2]) + 1.5
    uv_fish = tcameras.project(tcam, _t(rays))
    uv_un = tcameras.undistort_points(tcam, uv_fish).numpy()
    uv_pin = tcameras.project(tcameras.pinhole_equivalent(tcam), _t(rays)).numpy()
    np.testing.assert_allclose(uv_un, uv_pin, atol=0.05)
    np.testing.assert_allclose(
        uv_un, np.asarray(jcameras.undistort_points(jcam, jnp.asarray(uv_fish.numpy()))),
        rtol=0, atol=1e-3)


def test_pinhole_passthrough():
    uv = torch.tensor([[100.0, 100.0]])
    out = tcameras.undistort_points(tcameras.euroc_cam0(), uv)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jcameras.undistort_points(jcameras.euroc_cam0(), jnp.asarray(uv.numpy()))))
    assert out is uv


# ------------------------------------------ extract_and_track(undistort=True)
def test_extract_and_track_undistorted_frame():
    """Frame 2 of the two-plane scene rendered through KB8 (752x480,
    `kb8_cam`), tracked against a 4096-point map made from keyframes 0, 10,
    20 and 30 (their undistorted keypoints back-projected with the exact
    depth), from frame 1's true pose, in both packages."""
    jcam, tcam = _both(kb8_cam())
    geom = tcameras.pinhole_equivalent(tcam)
    scene = tsynthetic.make_textured_scene(7)
    poses = tsynthetic.circular_trajectory(300)

    def frame(i):
        img = tsynthetic.render_image(scene, tcam, *poses[i])
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    kfs = (0, 10, 20, 30)
    feats = [tbatched.extract_batched(torch.from_numpy(frame(i))) for i in kfs]
    pts = tsynthetic.local_points_from_keyframes(
        tcam, feats, [poses[i] for i in kfs],
        [tsynthetic.depth_map(scene, tcam, *poses[i]) for i in kfs], cap=4096)
    assert int(pts.valid.sum()) == 4096
    img, (R0, t0) = frame(2), poses[1]
    t_feats, t_res = tprograms.extract_and_track(
        tcam, geom, torch.from_numpy(img), pts, torch.from_numpy(R0), torch.from_numpy(t0),
        undistort=True)
    jpts = jprograms.LocalPoints(**{k: jnp.asarray(v) for k, v in convert.to_numpy(pts).items()})
    j_feats, j_res = jprograms.extract_and_track(
        jcam, jcameras.pinhole_equivalent(jcam), jnp.asarray(img), jpts, jnp.asarray(R0),
        jnp.asarray(t0), undistort=True)
    t_raw = convert.to_numpy(tprograms.extract_only(tcam, torch.from_numpy(img)))
    j_raw = {k: np.asarray(v) for k, v in jprograms.extract_only(jcam, jnp.asarray(img))._asdict().items()}
    same = ((t_raw["xy"] == j_raw["xy"]).all(-1) & (t_raw["level"] == j_raw["level"])
            & (t_raw["desc"] == j_raw["desc"]).all(-1) & (t_raw["valid"] == j_raw["valid"]))
    assert same.mean() >= 0.98, same.mean()
    t_xy, j_xy = t_feats.xy.numpy(), np.asarray(j_feats.xy)
    assert np.isfinite(t_xy).all()  # padded slots too
    live = same & t_raw["valid"]
    np.testing.assert_allclose(t_xy[live], j_xy[live], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_res.R.numpy(), np.asarray(j_res.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_res.t.numpy(), np.asarray(j_res.t), rtol=0, atol=1e-4)
    assert (t_res.match_feat.numpy() == np.asarray(j_res.match_feat)).mean() >= 0.99
    assert abs(int(t_res.n_inliers) - int(j_res.n_inliers)) <= 3
    R_gt, t_gt = poses[2]
    R, t = t_res.R.numpy().astype(np.float64), t_res.t.numpy().astype(np.float64)
    assert np.linalg.norm(R.T @ t - R_gt.T @ t_gt) < 0.01
    assert int(t_res.n_inliers) >= 300
