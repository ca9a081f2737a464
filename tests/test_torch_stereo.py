"""The port's stereo front end against the JAX package: the row matcher
(`frontend/stereo.stereo_match`) on a shifted pair and on a rendered
rectified pair, its median-deviation pass in both of its branches, the
RGB-D conversion `depth_to_stereo`, and the stereo per-frame program
`extract_and_track_stereo` against a local map.

The matcher tests hand both packages the same features (extracted by the
JAX package, carried across by `convert`) and the same images, so they test
the function alone. Bounds: the coarse match is decided on integer Hamming
distances and the SAD sums of uint8 (or float) patches agree, so the matched
set and `u_right` are bit-equal; values divided by bf (`depth = bf /
disparity`, RGB-D's `u - bf / depth`) agree to 1e-6 relative: XLA's
float32 division can round one ulp away. The per-frame
program extracts in each package (keypoints equal on >= 98 % of slots), so
it takes the bounds of `test_torch_programs.py`: R and t within 1e-4,
`match_feat` equal on >= 99 % of rows, `n_inliers` within 3."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.frontend import Features as JFeatures, extract as jextract, stereo as jstereo
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched, stereo as tstereo
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
DIV_RTOL = 1e-6
POSE_ATOL = 1e-4
MIN_MATCH_SHARE = 0.99
INLIER_MARGIN = 3


def _u8(img):
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _to_torch(feats):
    return convert.features_from_numpy({k: np.asarray(v) for k, v in feats._asdict().items()},
                                       device="cpu")


def _match_both(fl, fr, img_l, img_r):
    """stereo_match of both packages on the same JAX features and images;
    returns ((u_right, depth) of the port, the same of JAX) as numpy."""
    img_l, img_r = (np.asarray(a, np.float32) for a in (img_l, img_r))
    ur_j, d_j = jstereo.stereo_match(JCAM, fl, fr, jnp.asarray(img_l), jnp.asarray(img_r))
    ur_t, d_t = tstereo.stereo_match(TCAM, _to_torch(fl), _to_torch(fr),
                                     torch.from_numpy(img_l), torch.from_numpy(img_r))
    return (ur_t.numpy(), d_t.numpy()), (np.asarray(ur_j), np.asarray(d_j))


def _assert_same(t, j):
    (ur_t, d_t), (ur_j, d_j) = t, j
    np.testing.assert_array_equal(ur_t >= 0, ur_j >= 0)
    np.testing.assert_array_equal(ur_t, ur_j)
    np.testing.assert_allclose(d_t, d_j, rtol=DIV_RTOL, atol=0)


def test_shifted_pair_matches_jax():
    """The pair of `test_stereo.test_known_disparity`: the right image is
    the left rolled 12 px."""
    scene = jsynthetic.make_textured_scene(11)
    img_l = jsynthetic.render_image(scene, JCAM, *jsynthetic.circular_trajectory(4)[0])
    img_r = np.roll(img_l, -12, axis=1)
    fl = jextract(jnp.asarray(img_l), n_features=512)
    fr = jextract(jnp.asarray(img_r), n_features=512)
    t, j = _match_both(fl, fr, img_l, img_r)
    _assert_same(t, j)
    ok = t[0] >= 0
    assert ok.sum() > 100
    disp = np.asarray(fl.xy)[ok, 0] - t[0][ok]
    assert abs(np.median(disp) - 12) < 0.75


def _rendered_pair(frame: int):
    """uint8 left and right views of `make_textured_scene(7)` at pose
    `frame` of the 300-frame arc: the right camera sits b to the right
    (t_r = t - [b, 0, 0], a rectified rig)."""
    scene = tsynthetic.make_textured_scene(7)
    R, t = tsynthetic.circular_trajectory(300)[frame]
    b = TCAM.bf / TCAM.fx
    return (_u8(tsynthetic.render_image(scene, TCAM, R, t)),
            _u8(tsynthetic.render_image(scene, TCAM, R, t - np.array([b, 0.0, 0.0], np.float32))))


def test_rendered_pair_matches_jax():
    img_l, img_r = _rendered_pair(5)
    fl, fr = jextract(jnp.asarray(img_l)), jextract(jnp.asarray(img_r))
    t, j = _match_both(fl, fr, img_l, img_r)
    _assert_same(t, j)
    ok = t[0] >= 0
    assert ok.sum() > 500
    # the scene's two planes lie 8-14 m from the arc: depths in that band
    assert np.percentile(t[1][ok], 5) > 5.0 and np.percentile(t[1][ok], 95) < 20.0


def _planted_pair(all_valid: bool):
    """64 left features on a random texture, each with a partner 10 px to
    the left in a copy rolled by 10 px, its descriptor with 2-4 bits flipped
    (or 20 bits on every fifth). Every slot valid and matched (the median
    pass is on), or one slot invalid (the pass is off)."""
    rng = np.random.default_rng(5)
    img_l = (rng.random((480, 752)) * 255).astype(np.float32)
    img_r = np.roll(img_l, -10, axis=1)
    n = 64
    xy = np.stack([rng.uniform(40, 700, n), rng.uniform(20, 460, n)], -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    flips = np.where(np.arange(n) % 5 == 0, 20, rng.integers(2, 5, n))
    desc_r = desc.copy()
    for i, k in enumerate(flips):
        for bit in rng.choice(256, k, replace=False):
            desc_r[i, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    valid = np.ones(n, bool)
    if not all_valid:
        valid[7] = False

    def feats(xy_, desc_, valid_):
        return JFeatures(
            xy=jnp.asarray(xy_), level=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n),
            response=jnp.ones(n), desc=jnp.asarray(desc_), valid=jnp.asarray(valid_),
            u_right=jnp.full(n, -1.0), depth=jnp.full(n, -1.0))

    fl = feats(xy, desc, valid)
    fr = feats(xy - np.array([10.0, 0.0], np.float32), desc_r, np.ones(n, bool))
    return fl, fr, img_l, img_r, flips


@pytest.mark.parametrize("all_valid", [True, False], ids=["pass-on", "pass-off"])
def test_median_pass_matches_jax(all_valid):
    """The median-deviation pass acts only when every slot matched: then
    the 20-bit matches (over 1.5 * 1.4 * the median of 2-4 bits) are culled;
    with one unmatched slot the median is NaN and every match stays."""
    fl, fr, img_l, img_r, flips = _planted_pair(all_valid)
    t, j = _match_both(fl, fr, img_l, img_r)
    _assert_same(t, j)
    matched = t[0] >= 0
    expect = np.asarray(fl.valid) & ((flips < 20) if all_valid else True)
    np.testing.assert_array_equal(matched, expect)
    # the parabola over an uncorrelated texture moves the peak by < 0.05 px
    np.testing.assert_allclose(np.asarray(fl.xy)[matched, 0] - t[0][matched], 10.0, atol=0.05)


def test_depth_to_stereo_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    xy = np.stack([rng.uniform(-3, 760, n), rng.uniform(-3, 490, n)], -1).astype(np.float32)
    valid = rng.random(n) > 0.1
    depth_map = (rng.random((480, 752)) * 10).astype(np.float32)
    depth_map[rng.random((480, 752)) < 0.2] = 0.0
    jf = JFeatures(
        xy=jnp.asarray(xy), level=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n),
        response=jnp.ones(n), desc=jnp.zeros((n, 8), jnp.uint32), valid=jnp.asarray(valid),
        u_right=jnp.full(n, -1.0), depth=jnp.full(n, -1.0))
    ur_j, d_j = jstereo.depth_to_stereo(JCAM, jf, jnp.asarray(depth_map))
    ur_t, d_t = tstereo.depth_to_stereo(TCAM, _to_torch(jf), torch.from_numpy(depth_map))
    np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur_j), rtol=DIV_RTOL, atol=0)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert 0.5 * n < int((d_t > 0).sum()) < n


@pytest.fixture(scope="module")
def local_map():
    """A 4096-point local map of `make_textured_scene(7)` from keyframes
    0/10/20/30 of the 300-frame arc, with exact depth (as in
    `test_torch_programs.py`)."""
    scene = tsynthetic.make_textured_scene(7)
    poses = tsynthetic.circular_trajectory(300)
    kfs = (0, 10, 20, 30)
    feats = [tbatched.extract_batched(torch.from_numpy(
        _u8(tsynthetic.render_image(scene, TCAM, *poses[i])))) for i in kfs]
    return tsynthetic.local_points_from_keyframes(
        TCAM, feats, [poses[i] for i in kfs],
        [tsynthetic.depth_map(scene, TCAM, *poses[i]) for i in kfs], cap=4096), poses


def test_extract_and_track_stereo_matches_jax(local_map):
    pts, poses = local_map
    img_l, img_r = _rendered_pair(1)
    R0, t0 = poses[0]
    t_feats, t_res = tprograms.extract_and_track_stereo(
        TCAM, TCAM, torch.from_numpy(img_l), torch.from_numpy(img_r), pts,
        torch.from_numpy(R0), torch.from_numpy(t0))
    jpts = jprograms.LocalPoints(**{k: jnp.asarray(v) for k, v in convert.to_numpy(pts).items()})
    j_feats, j_res = jprograms.extract_and_track_stereo(
        JCAM, JCAM, jnp.asarray(img_l), jnp.asarray(img_r), jpts, jnp.asarray(R0), jnp.asarray(t0))
    t_f = convert.to_numpy(t_feats)
    j_f = {k: np.asarray(v) for k, v in j_feats._asdict().items()}
    same_kp = (t_f["xy"] == j_f["xy"]).all(-1)
    assert same_kp.mean() >= 0.98
    # stereo depth on most keypoints, and the same where both extractions agree
    assert (t_f["depth"] > 0).sum() > 500
    agree = ((t_f["u_right"] >= 0) == (j_f["u_right"] >= 0))[same_kp & j_f["valid"]]
    assert agree.mean() >= 0.98
    np.testing.assert_allclose(t_res.R.numpy(), np.asarray(j_res.R), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t_res.t.numpy(), np.asarray(j_res.t), rtol=0, atol=POSE_ATOL)
    share = (t_res.match_feat.numpy() == np.asarray(j_res.match_feat)).mean()
    assert share >= MIN_MATCH_SHARE, share
    np.testing.assert_array_equal(t_res.visible.numpy(), np.asarray(j_res.visible))
    assert abs(int(t_res.n_inliers) - int(j_res.n_inliers)) <= INLIER_MARGIN
    R_gt, t_gt = poses[1]
    R, t = t_res.R.numpy().astype(np.float64), t_res.t.numpy().astype(np.float64)
    assert np.linalg.norm(R.T @ t - R_gt.T @ t_gt) < 0.01
    assert int(t_res.n_inliers) >= 300


def test_stereo_fisheye_undistortion_not_ported():
    """`undistort` was refused until the fisheye slice (ROADMAP A7); now the
    stereo extraction maps the left keypoints through the camera's
    `undistort_points` after the row matcher, and leaves the rest as is."""
    kb8 = dataclasses.replace(TCAM, kind=tcameras.KANNALA_BRANDT8, k1=0.01, k2=-0.002)
    img_l, img_r = (torch.from_numpy(a) for a in _rendered_pair(5))
    plain = tprograms.extract_stereo_only(kb8, img_l, img_r)
    undist = tprograms.extract_stereo_only(kb8, img_l, img_r, undistort=True)
    assert torch.equal(undist.xy, tcameras.undistort_points(kb8, plain.xy))
    for name in ("level", "desc", "valid", "u_right", "depth"):
        assert torch.equal(getattr(undist, name), getattr(plain, name)), name
