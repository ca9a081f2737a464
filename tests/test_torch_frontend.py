"""The port's ORB front end against the JAX package on rendered 752x480
EuRoC-cam0 frames of the synthetic two-plane scene.

Static tables are equal exactly. Level 0 is the integer input image, so
its FAST responses and keypoints are equal exactly. Higher pyramid levels
and the in-patch blur are float sums taken in another order, so a value on
a .5 boundary of round() can move a keypoint or flip a descriptor bit: the
agreement share and the bit-mismatch rate are asserted against bounds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_comments_ghr_tpu.frontend import batched as jbatched, brief as jbrief
from orb_slam3_comments_ghr_tpu.frontend import fast as jfast, pyramid as jpyramid
from orb_slam3_comments_ghr_tpu.frontend import select as jselect, types as jtypes
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched, brief as tbrief
from orb_slam3_comments_ghr_torch.frontend import fast as tfast, pyramid as tpyramid
from orb_slam3_comments_ghr_torch.frontend import select as tselect, types as ttypes
from orb_slam3_comments_ghr_torch import convert

torch.set_num_threads(1)

# measured on this frame: every keypoint and every descriptor bit agree
# (angles to 5e-5 rad). The bounds leave room for a few .5-boundary flips
# in the f32 pyramid/blur sums, which run in another order than XLA's.
MIN_KEYPOINT_SHARE = 0.98
MAX_BIT_MISMATCH = 1e-3


@pytest.fixture(scope="module")
def frame():
    cam = jcameras.euroc_cam0()
    scene = jsynthetic.make_textured_scene(7)
    R, t = jsynthetic.circular_trajectory(300)[5]
    img = jsynthetic.render_image(scene, cam, R, t)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def test_static_tables_equal():
    np.testing.assert_array_equal(tbrief.PATTERN.numpy(), np.asarray(jbrief.PATTERN))
    np.testing.assert_array_equal(tbatched._rotation_tables(), jbatched._rotation_tables())
    np.testing.assert_array_equal(tbatched._blur_valid().numpy(), np.asarray(jbatched._blur_valid()))
    for t, j in zip(tbatched._moment_kernels(), jbatched._moment_kernels()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for n_out, n_in in [(400, 480), (627, 752), (333, 400), (8, 11), (480, 400)]:
        np.testing.assert_array_equal(tpyramid._interp_matrix(n_out, n_in).numpy(),
                                      np.asarray(jpyramid._interp_matrix(n_out, n_in)))
    assert (tbatched.PATCH_SIDE, tbatched.N_ROT_BINS, tbatched.PATCH_IN) == \
        (jbatched.PATCH_SIDE, jbatched.N_ROT_BINS, jbatched.PATCH_IN)
    assert tfast.RING == jfast.RING and tfast._ARC_MASKS == jfast._ARC_MASKS


@pytest.mark.parametrize("n_features,n_levels,scale", [(1024, 8, 1.2), (500, 4, 1.5), (77, 8, 1.2)])
def test_level_shapes_and_quotas(n_features, n_levels, scale):
    assert tselect.level_quotas(n_features, n_levels, scale) == \
        jselect.level_quotas(n_features, n_levels, scale)
    assert tpyramid.level_shapes(480, 752, n_levels, scale) == \
        [tuple(s) for s in jpyramid.level_shapes(480, 752, n_levels, scale)]


def test_build_pyramid(frame):
    img = frame.astype(np.float32)
    for t, j in zip(tpyramid.build_pyramid(torch.from_numpy(img)),
                    jpyramid.build_pyramid(jnp.asarray(img))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-3)


def test_dual_threshold_response_level0(frame):
    img = frame.astype(np.float32)
    t = tfast.dual_threshold_response(torch.from_numpy(img))
    j = jax.jit(jfast.dual_threshold_response)(jnp.asarray(img))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_nms3_with_ties():
    rng = np.random.default_rng(0)
    resp = rng.integers(0, 4, (3, 40, 50)).astype(np.float32)  # many ties
    np.testing.assert_array_equal(tfast.nms3(torch.from_numpy(resp)).numpy(),
                                  np.asarray(jfast.nms3(jnp.asarray(resp))))


def test_batched_select_equal_on_same_response(frame):
    # one response stack into both selections: checks the tie order of the
    # stable sort against lax.top_k and the coarse-champion construction
    P, shapes = jbatched._padded_pyramid(jnp.asarray(frame.astype(np.float32)), 8, 1.2)
    resp = np.array(jax.jit(jfast.dual_threshold_response)(P))
    quotas = tuple(jselect.level_quotas(1024, 8, 1.2))
    j = jax.jit(jbatched._batched_select, static_argnums=(1, 2))(jnp.asarray(resp), quotas, 19)
    t = tbatched._batched_select(torch.from_numpy(resp), quotas, border=19)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_extract_batched(frame):
    t = convert.to_numpy(tbatched.extract_batched(torch.from_numpy(frame)))
    j = {k: np.asarray(v) for k, v in jbatched.extract_batched(jnp.asarray(frame))._asdict().items()}
    for k in ("u_right", "depth"):
        np.testing.assert_array_equal(t[k], j[k])
    lvl0 = j["valid"] & (j["level"] == 0)
    assert lvl0.sum() > 200
    assert (t["valid"] == j["valid"]).all()
    np.testing.assert_array_equal(t["xy"][lvl0], j["xy"][lvl0])
    np.testing.assert_array_equal(t["level"][lvl0], j["level"][lvl0])
    same = (t["xy"] == j["xy"]).all(-1) & (t["level"] == j["level"]) & j["valid"]
    share = same.sum() / j["valid"].sum()
    assert share >= MIN_KEYPOINT_SHARE, share
    np.testing.assert_allclose(t["angle"][same], j["angle"][same], rtol=0, atol=1e-3)
    bits = np.unpackbits((t["desc"][same] ^ j["desc"][same]).view(np.uint8))
    assert bits.mean() <= MAX_BIT_MISMATCH, bits.mean()
    np.testing.assert_allclose(t["response"][same], j["response"][same], rtol=1e-5)


def test_extract_rejects_bad_images():
    with pytest.raises(ValueError):
        tbatched.extract_batched(torch.zeros(480, 752, 3))
    with pytest.raises(ValueError):
        tbatched.extract_batched(torch.zeros(40, 752))


def test_empty_features():
    t = ttypes.empty_features(16, device="cpu")
    j = jtypes.empty_features(16)
    for k, v in convert.to_numpy(t).items():
        ref = np.asarray(getattr(j, k))
        np.testing.assert_array_equal(v, ref)
        assert v.dtype == ref.dtype, k
