"""The port's stereo rectification (`io/rectify.py`) and CLAHE
(`frontend/clahe.py`) against the JAX package: twins of the geometry,
epipolar, remap and CLAHE tests of `tests/test_rectify_clahe.py`, each also
held against the JAX function on the same inputs.

Bounds: the host maps are the same numpy code, so bit-equal; the bilinear
remap is the same float32 arithmetic per pixel, but XLA fuses its products
and sums into fused multiply-adds, so it agrees to 1e-4 grey levels (a few
float32 steps at 255); CLAHE's
clip-and-redistribute sums and its cumulative sum run in another order than
XLA's, so its output agrees to 1e-3 grey levels (of 255)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.frontend import batched as jbatched, clahe as jclahe
from orb_slam3_comments_ghr_tpu.io import rectify as jrectify
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched, clahe as tclahe
from orb_slam3_comments_ghr_torch.io import rectify as trectify
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

REMAP_ATOL = 1e-4
CLAHE_ATOL = 1e-3

# EuRoC MH cam0/cam1 raw calibration, as in tests/test_rectify_clahe.py
INTR1 = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
             k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
INTR2 = dict(fx=457.587, fy=456.134, cx=379.999, cy=255.238,
             k1=-0.28368365, k2=0.07451284, p1=-0.00010473, p2=-3.55590700e-05)
R12 = tlie.so3_exp(torch.tensor([0.003, -0.002, 0.001])).numpy()
T12 = np.array([0.1101, -0.0002, 0.0003])


def test_rect_rotations_geometry():
    R1, R2, baseline = trectify._rect_rotations(R12, T12)
    np.testing.assert_allclose(R1 @ R1.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(R2 @ R2.T, np.eye(3), atol=1e-6)
    b = R1 @ T12
    assert b[0] > 0
    np.testing.assert_allclose(b[1:], 0.0, atol=1e-9)
    np.testing.assert_allclose(R1 @ R12, R2, atol=1e-6)
    assert abs(baseline - np.linalg.norm(T12)) < 1e-12
    for t, j in zip((R1, R2, baseline), jrectify._rect_rotations(R12, T12)):
        np.testing.assert_array_equal(t, j)


def test_epipolar_rows_align():
    """Random 3D points project to the same row in both rectified views,
    with disparity bf / depth; the rig equals the JAX package's."""
    rig = trectify.build_rectifier(INTR1, INTR2, R12, T12, 752, 480)
    jrig = jrectify.build_rectifier(INTR1, INTR2, R12, T12, 752, 480)
    assert rig.cam_rect == tcameras.Camera(**jrig.cam_rect.__dict__)
    np.testing.assert_array_equal(rig.map_left, jrig.map_left)
    np.testing.assert_array_equal(rig.map_right, jrig.map_right)
    cam = rig.cam_rect
    R1, R2, _ = trectify._rect_rotations(R12, T12)
    rng = np.random.default_rng(3)
    pts_c1 = np.stack([rng.uniform(-2, 2, 64), rng.uniform(-1.5, 1.5, 64),
                       rng.uniform(4, 12, 64)], -1)
    pts_c2 = (pts_c1 - T12) @ R12
    uv_l = tcameras.project(cam, torch.from_numpy(pts_c1 @ R1.T)).numpy()
    uv_r = tcameras.project(cam, torch.from_numpy(pts_c2 @ R2.T)).numpy()
    np.testing.assert_allclose(uv_l[:, 1], uv_r[:, 1], atol=1e-3)
    np.testing.assert_allclose(uv_l[:, 0] - uv_r[:, 0], cam.bf / (pts_c1 @ R1.T)[:, 2], rtol=1e-4)


def test_remap_identity():
    """A distortion-free rig with identity extrinsics leaves the image
    almost unchanged; the remap equals the JAX package's."""
    intr = dict(fx=400.0, fy=400.0, cx=376.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    rig = trectify.build_rectifier(intr, intr, np.eye(3), np.array([0.11, 0.0, 0.0]), 752, 480)
    img = np.random.default_rng(0).random((480, 752)).astype(np.float32) * 255
    out_l, out_r = rig.rectify(img, img, device="cpu")
    assert out_l.shape == img.shape and out_l.dtype == torch.float32
    assert np.abs(out_l.numpy()[50:-50, 50:-50] - img[50:-50, 50:-50]).mean() < 20.0
    jl, jr = jrectify.StereoRectifier(rig.cam_rect, rig.map_left, rig.map_right).rectify(img, img)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(jl), rtol=0, atol=REMAP_ATOL)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(jr), rtol=0, atol=REMAP_ATOL)


def test_remap_raw_rig_matches_jax():
    """The EuRoC rig's maps (sources off the image clamp to its border) on
    a rendered frame, and a tensor input stays on its device."""
    rig = trectify.build_rectifier(INTR1, INTR2, R12, T12, 752, 480)
    cam = tcameras.euroc_cam0()
    img = tsynthetic.render_image(tsynthetic.make_textured_scene(3), cam,
                                  *tsynthetic.circular_trajectory(10)[2])
    out = trectify.remap_bilinear(torch.from_numpy(img), torch.from_numpy(rig.map_right))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jrectify.remap_bilinear(jnp.asarray(img), jnp.asarray(rig.map_right))),
        rtol=0, atol=REMAP_ATOL)
    l, _ = rig.rectify(torch.from_numpy(img), torch.from_numpy(img))
    assert l.device == torch.device("cpu")
    assert torch.equal(l, trectify.remap_bilinear(torch.from_numpy(img),
                                                  torch.from_numpy(rig.map_left)))


def _clahe_both(img):
    t = tclahe.clahe(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(t, np.asarray(jclahe.clahe(jnp.asarray(img))), rtol=0,
                               atol=CLAHE_ATOL)
    return t


def test_uniform_stays_uniform():
    out = _clahe_both(np.full((480, 752), 100.0, np.float32))
    assert out.std() < 3.0
    assert 0.0 <= out.min() and out.max() <= 255.0


def test_stretches_low_contrast():
    img = (np.random.default_rng(1).random((480, 752)) * 20 + 118).astype(np.float32)
    out = _clahe_both(img)
    assert out.std() > 2.5 * img.std(), (img.std(), out.std())
    assert out.max() <= 255.0 and out.min() >= 0.0


def test_improves_fast_detection_in_dark():
    """A dark render yields more valid FAST keypoints after CLAHE, in the
    port's extractor as in the JAX package's."""
    cam = tcameras.euroc_cam0()
    img = tsynthetic.render_image(tsynthetic.make_textured_scene(5), cam,
                                  *tsynthetic.circular_trajectory(4)[0]) * np.float32(0.12)
    eq = _clahe_both(img)
    n0 = int(tbatched.extract_batched(torch.from_numpy(img), n_features=512).valid.sum())
    n1 = int(tbatched.extract_batched(torch.from_numpy(eq), n_features=512).valid.sum())
    assert n1 > n0, (n0, n1)
    j1 = int(np.asarray(jbatched.extract_batched(jnp.asarray(eq), n_features=512).valid).sum())
    assert abs(n1 - j1) <= 0.02 * j1
