"""The port's per-frame tracking program against the JAX package.

`track_against_points` runs on the synthetic features and local map of
`__graft_entry__._synth_track_inputs` (512 features, 1024 points). The
whole slice, `extract_and_track`, runs on three rendered 752x480 frames of
the synthetic two-plane scene against a 4096-point map from keyframes
0/10/20/30, the same map handed to both packages through `convert`.

Bounds: the pose LM sums in another order than XLA (f32), so R and t agree
to 1e-4; a matched feature can change only where two Hamming distances tie
or a chi2 sits on its gate, so `match_feat` agrees on >= 99 % of rows and
`n_inliers` within 3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _synth_track_inputs
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, matching as jmatching
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, matching as tmatching
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

POSE_ATOL = 1e-4
MIN_MATCH_SHARE = 0.99
INLIER_MARGIN = 3


def _jax_numpy(container):
    return {k: np.asarray(v) for k, v in container._asdict().items()}


def _compare(t_res, j_res):
    np.testing.assert_allclose(t_res.R.numpy(), np.asarray(j_res.R), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t_res.t.numpy(), np.asarray(j_res.t), rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(t_res.visible.numpy(), np.asarray(j_res.visible))
    share = (t_res.match_feat.numpy() == np.asarray(j_res.match_feat)).mean()
    assert share >= MIN_MATCH_SHARE, share
    assert abs(int(t_res.n_inliers) - int(j_res.n_inliers)) <= INLIER_MARGIN


def test_track_against_points_synthetic_features():
    cam, feats, lp, R0, t0 = _synth_track_inputs(512, 1024)
    j_res = jprograms.track_against_points(cam, feats, lp, R0, t0)
    t_res = tprograms.track_against_points(
        convert.camera_from_jax(cam), convert.features_from_numpy(_jax_numpy(feats), device="cpu"),
        convert.local_points_from_numpy(_jax_numpy(lp), device="cpu"),
        torch.tensor(np.asarray(R0)), torch.tensor(np.asarray(t0)))
    _compare(t_res, j_res)
    assert int(t_res.n_inliers) > 300


def test_frustum_gate_matches_jax():
    cam, _, lp, R0, t0 = _synth_track_inputs(512, 1024)
    j = jprograms._frustum_gate(cam, R0, t0, lp, 8, 1.2)
    t = tprograms._frustum_gate(
        convert.camera_from_jax(cam), torch.tensor(np.asarray(R0)),
        torch.tensor(np.asarray(t0)), convert.local_points_from_numpy(_jax_numpy(lp), device="cpu"), 8, 1.2)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    vis = np.asarray(j[0])
    np.testing.assert_allclose(t[1].numpy()[vis], np.asarray(j[1])[vis], rtol=1e-5)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-6)


def _match_inputs(seed, n=600, m=300):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, n).astype(np.int32)
    dist = rng.integers(0, 40, n).astype(np.int32)   # many equal distances
    valid = rng.random(n) > 0.3
    ang_a = (rng.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    ang_b = (rng.random(m) * 2 * np.pi - np.pi).astype(np.float32)
    ang_a[: n // 2] = ang_b[idx[: n // 2]] + np.float32(0.3)  # a dominant rotation
    second = dist + rng.integers(-5, 30, n).astype(np.int32)
    return idx, dist, valid, ang_a, ang_b, second


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_reductions_match_jax(seed):
    idx, dist, valid, ang_a, ang_b, second = _match_inputs(seed)
    T = torch.from_numpy
    np.testing.assert_array_equal(
        tmatching.resolve_duplicates(T(idx), T(dist), T(valid), 300).numpy(),
        np.asarray(jmatching.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid), 300)))
    np.testing.assert_array_equal(
        tmatching.rotation_consistency(T(ang_a), T(ang_b), T(idx), T(valid)).numpy(),
        np.asarray(jmatching.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                                  jnp.asarray(idx), jnp.asarray(valid))))
    np.testing.assert_array_equal(
        tmatching.ratio_test(T(dist), T(second), tmatching.TH_HIGH, 0.8).numpy(),
        np.asarray(jmatching.ratio_test(jnp.asarray(dist), jnp.asarray(second), jmatching.TH_HIGH, 0.8)))


@pytest.fixture(scope="module")
def sequence():
    """Frames 0..3 and the 4096-point keyframe map of the chip smoke run."""
    cam = tcameras.euroc_cam0()
    scene = tsynthetic.make_textured_scene(7)
    poses = tsynthetic.circular_trajectory(300)

    def frame(i):
        img = tsynthetic.render_image(scene, cam, *poses[i])
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    kfs = (0, 10, 20, 30)
    feats = [tbatched.extract_batched(torch.from_numpy(frame(i))) for i in kfs]
    pts = tsynthetic.local_points_from_keyframes(
        cam, feats, [poses[i] for i in kfs],
        [tsynthetic.depth_map(scene, cam, *poses[i]) for i in kfs], cap=4096)
    return cam, [frame(i) for i in range(4)], pts, poses


@pytest.mark.parametrize("i", [1, 2, 3])
def test_extract_and_track_slice(sequence, i):
    cam, frames, pts, poses = sequence
    assert int(pts.valid.sum()) == 4096
    jpts = jprograms.LocalPoints(**{k: jnp.asarray(v) for k, v in convert.to_numpy(pts).items()})
    R0, t0 = poses[i - 1]
    t_feats, t_res = tprograms.extract_and_track(
        cam, cam, torch.from_numpy(frames[i]), pts, torch.from_numpy(R0), torch.from_numpy(t0))
    jcam = jcameras.euroc_cam0()
    j_feats, j_res = jprograms.extract_and_track(
        jcam, jcam, jnp.asarray(frames[i]), jpts, jnp.asarray(R0), jnp.asarray(t0))
    t_f, j_f = convert.to_numpy(t_feats), _jax_numpy(j_feats)
    assert (t_f["xy"] == j_f["xy"]).all(-1).mean() >= 0.98
    _compare(t_res, j_res)
    # the tracked camera centre is within 1 cm of ground truth
    R, t = t_res.R.numpy().astype(np.float64), t_res.t.numpy().astype(np.float64)
    R_gt, t_gt = poses[i]
    assert np.linalg.norm(R.T @ t - R_gt.T @ t_gt) < 0.01
    assert int(t_res.n_inliers) >= 300


def test_fisheye_undistortion_not_ported(sequence):
    """`undistort` was refused until the fisheye slice (ROADMAP A7); now a
    pinhole camera's keypoints pass through it unchanged."""
    cam, frames, _, _ = sequence
    img = torch.from_numpy(frames[1])
    plain = tprograms.extract_only(cam, img)
    for a, b in zip(tprograms.extract_only(cam, img, undistort=True), plain):
        assert torch.equal(a, b)
