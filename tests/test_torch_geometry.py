"""The port's geometry against the JAX package on the same seeded inputs:
SO(3)/quaternion additions, DLT triangulation, the two-view reconstruction
(model fits, scores, CheckRT and the whole RANSAC with the minimal sets JAX
drew) and PnP RANSAC (with the hypotheses JAX drew).

Bounds: float32 throughout. SVD null vectors have a free sign (and scale),
so fitted models are compared after normalising both; scores sum a few
hundred float32 terms in another order (rtol 1e-4); a point exactly on a
chi2 gate may fall either side, so masks agree on >= 99 % of rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie, triangulate as jtri
from orb_slam3_comments_ghr_tpu.optim import pnp as jpnp, twoview as jtwoview
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie, triangulate as ttri
from orb_slam3_comments_ghr_torch.optim import pnp as tpnp, twoview as ttwoview

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
MASK_SHARE = 0.99


def _rot(phi):
    return np.asarray(jlie.so3_exp(jnp.asarray(phi, jnp.float32)))


def two_view(seed, n=300, planar=False, baseline=0.3, noise=0.5, outliers=0.0):
    """Matched pixels of two views with known motion, from numpy."""
    rng = np.random.default_rng(seed)
    uv = rng.random((n, 2)) * [TCAM.width - 40.0, TCAM.height - 40.0] + 20.0
    rays = np.stack([(uv[:, 0] - TCAM.cx) / TCAM.fx, (uv[:, 1] - TCAM.cy) / TCAM.fy, np.ones(n)], -1)
    z = 8.0 / rays[:, 2:3] if planar else rng.random((n, 1)) * 8.0 + 4.0
    pts = rays * z
    R = _rot([0.01, 0.03, 0.005])
    t = np.array([-baseline, 0.02, 0.01])
    pts2 = pts @ R.T + t

    def proj(p):
        return np.stack([TCAM.fx * p[:, 0] / p[:, 2] + TCAM.cx, TCAM.fy * p[:, 1] / p[:, 2] + TCAM.cy], -1)

    uv1 = proj(pts) + rng.normal(0, noise, (n, 2))
    uv2 = proj(pts2) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] = rng.random((int(bad.sum()), 2)) * 400 + 30
    valid = (uv1.min(1) > 5) & (uv2.min(1) > 5) & (uv1[:, 0] < TCAM.width - 5) & (uv2[:, 0] < TCAM.width - 5)
    f = np.float32
    return uv1.astype(f), uv2.astype(f), valid, R.astype(f), t.astype(f), pts.astype(f)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def test_lie_additions_match_jax():
    rng = np.random.default_rng(0)
    phi = (rng.normal(0, 1.0, (64, 3))).astype(np.float32)
    phi[:4] *= 1e-7   # the small-angle branch
    phi[4:8] *= np.pi / np.linalg.norm(phi[4:8], axis=-1, keepdims=True) * 0.999  # near pi
    R = _rot(phi)
    np.testing.assert_allclose(tlie.mat_to_quat(T(R)).numpy(), np.asarray(jlie.mat_to_quat(J(R))), atol=1e-6)
    np.testing.assert_allclose(tlie.so3_log(T(R)).numpy(), np.asarray(jlie.so3_log(J(R))), atol=1e-5)
    np.testing.assert_array_equal(tlie.vee(T(R)).numpy(), np.asarray(jlie.vee(J(R))))
    t = rng.normal(size=(64, 3)).astype(np.float32)
    for a, b in zip(tlie.se3_inv(T(R), T(t)), jlie.se3_inv(J(R), J(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_triangulate_matches_jax():
    uv1, uv2, valid, R, t, pts = two_view(1, noise=0.3)
    K = np.asarray(JCAM.K)
    P1j, P2j = jtri.projection_matrix(J(K), jnp.eye(3), jnp.zeros(3)), jtri.projection_matrix(J(K), J(R), J(t))
    P1t, P2t = ttri.projection_matrix(T(K), torch.eye(3), torch.zeros(3)), ttri.projection_matrix(T(K), T(R), T(t))
    np.testing.assert_allclose(P2t.numpy(), np.asarray(P2j), rtol=1e-6)
    Xj = np.asarray(jtri.triangulate(P1j, P2j, J(uv1), J(uv2)))
    Xt = ttri.triangulate(P1t, P2t, T(uv1), T(uv2)).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=1e-4)
    assert np.median(np.abs(Xt - pts)) < 0.2  # and near the truth under 0.3 px noise


def _normalized_sets(seed, n, size):
    rng = np.random.default_rng(seed)
    uv1, uv2, valid, *_ = two_view(seed, n=n)
    idx = np.stack([rng.choice(np.nonzero(valid)[0], size, replace=False) for _ in range(16)])
    x1n, _ = jtwoview._normalize(J(uv1), J(valid))
    x2n, _ = jtwoview._normalize(J(uv2), J(valid))
    return np.asarray(x1n)[idx], np.asarray(x2n)[idx], uv1, uv2, valid


def _same_up_to_scale(a, b, atol):
    a = a / np.linalg.norm(a.reshape(len(a), -1), axis=1)[:, None, None]
    b = b / np.linalg.norm(b.reshape(len(b), -1), axis=1)[:, None, None]
    sign = np.sign(np.sum(a * b, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(a * sign, b, atol=atol)


def test_normalize_matches_jax():
    uv1, _, valid, *_ = two_view(2)
    for a, b in zip(ttwoview._normalize(T(uv1), T(valid)), jtwoview._normalize(J(uv1), J(valid))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,size", [("homography", 4), ("fundamental", 8)])
def test_model_fits_match_jax_up_to_scale(model, size):
    x1, x2, *_ = _normalized_sets(3, 200, size)
    jfit = getattr(jtwoview, f"_fit_{model}")
    ours = getattr(ttwoview, f"_fit_{model}")(T(x1), T(x2)).numpy()
    ref = np.stack([np.asarray(jfit(J(a), J(b))) for a, b in zip(x1, x2)])
    _same_up_to_scale(ours, ref, atol=2e-4)


@pytest.mark.parametrize("model", ["homography", "fundamental"])
def test_scores_match_jax(model):
    uv1, uv2, valid, R, t, _ = two_view(4, outliers=0.2)
    x1, x2, *_ = _normalized_sets(4, 300, 4 if model == "homography" else 8)
    # a fitted model (denormalized) and the true one
    x1n, T1 = jtwoview._normalize(J(uv1), J(valid))
    x2n, T2 = jtwoview._normalize(J(uv2), J(valid))
    if model == "homography":
        M = np.asarray(jnp.linalg.inv(T2) @ jtwoview._fit_homography(J(x1[0]), J(x2[0])) @ T1)
    else:
        M = np.asarray(T2.T @ jtwoview._fit_fundamental(J(x1[0]), J(x2[0])) @ T1)
    js, jok = getattr(jtwoview, f"_score_{model}")(J(M), J(uv1), J(uv2), J(valid))
    ts, tok = getattr(ttwoview, f"_score_{model}")(T(M), T(uv1), T(uv2), T(valid))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
    assert (tok.numpy() == np.asarray(jok)).mean() >= MASK_SHARE


def test_check_rt_matches_jax():
    uv1, uv2, valid, R, t, _ = two_view(5)
    K = np.asarray(JCAM.K)
    t_dir = (t / np.linalg.norm(t)).astype(np.float32)
    Rs = np.stack([R, R, R.T]).astype(np.float32)
    ts = np.stack([t_dir, -t_dir, t_dir]).astype(np.float32)
    n_t, par_t, X_t, good_t = ttwoview._check_rt(T(Rs), T(ts), T(K), T(uv1), T(uv2), T(valid))
    for i in range(3):
        n_j, par_j, X_j, good_j = jtwoview._check_rt(J(Rs[i]), J(ts[i]), J(K), J(uv1), J(uv2), J(valid))
        assert (good_t[i].numpy() == np.asarray(good_j)).mean() >= MASK_SHARE
        assert abs(int(n_t[i]) - int(n_j)) <= 3
        np.testing.assert_allclose(float(par_t[i]), float(par_j), atol=1e-5)
        g = np.asarray(good_j) & good_t[i].numpy()
        np.testing.assert_allclose(X_t[i].numpy()[g], np.asarray(X_j)[g], atol=1e-3, rtol=1e-4)
    assert int(n_t[0]) > 200 and int(n_t[1]) == 0  # the true motion wins, the flipped one sees nothing


def _jax_sets(key, valid):
    """The minimal sets `twoview.reconstruct` draws from `key`."""
    k_h, k_f = jax.random.split(key)
    n = valid.shape[0]
    return (np.asarray(jtwoview._sample_minimal(k_h, n, J(valid), jtwoview.RANSAC_ITERS, 4)),
            np.asarray(jtwoview._sample_minimal(k_f, n, J(valid), jtwoview.RANSAC_ITERS, 8)))


@pytest.mark.parametrize("seed,kwargs,expect_h", [
    (0, {}, False),
    (1, {"planar": True}, True),
    (2, {"outliers": 0.25}, False),
    (3, {"baseline": 0.0, "noise": 0.3}, None),  # pure rotation: must fail
])
def test_reconstruct_with_jax_sets(seed, kwargs, expect_h):
    uv1, uv2, valid, R, t, _ = two_view(10 + seed, **kwargs)
    key = jax.random.PRNGKey(42 + seed)
    j = jtwoview.reconstruct(JCAM, J(uv1), J(uv2), J(valid), key)
    idx_h, idx_f = _jax_sets(key, valid)
    r = ttwoview._reconstruct_body(TCAM, T(uv1), T(uv2), T(valid), T(idx_h), T(idx_f))
    assert bool(r.success) == bool(j.success)
    if expect_h is None:
        assert not bool(r.success)
        return
    assert bool(r.success)
    assert bool(r.used_homography) == bool(j.used_homography) == expect_h
    np.testing.assert_allclose(r.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(r.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert (r.good.numpy() == np.asarray(j.good)).mean() >= MASK_SHARE
    # and the recovered motion is the true one
    assert np.linalg.norm(tlie.so3_log(r.R @ T(R).T).numpy()) < 0.03
    assert abs(float(r.t @ T(t / np.linalg.norm(t)))) > 0.95


def test_reconstruct_samples_from_generator():
    uv1, uv2, valid, R, t, _ = two_view(20)
    gen = torch.Generator().manual_seed(7)
    a = ttwoview.reconstruct(TCAM, T(uv1), T(uv2), T(valid), gen)
    b = ttwoview.reconstruct(TCAM, T(uv1), T(uv2), T(valid), torch.Generator().manual_seed(7))
    assert bool(a.success) and torch.equal(a.R, b.R) and torch.equal(a.good, b.good)
    idx = ttwoview._sample_minimal(torch.Generator().manual_seed(1), T(valid), 50, 8)
    assert idx.shape == (50, 8) and bool(T(valid)[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)


def test_pnp_with_jax_hypotheses():
    rng = np.random.default_rng(30)
    n = 200
    X = (rng.random((n, 3)) * [6, 4, 6] + [-3, -2, 5]).astype(np.float32)
    R = _rot([0.05, -0.1, 0.02]).astype(np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    pc = X @ R.T + t
    x = np.stack([TCAM.fx * pc[:, 0] / pc[:, 2] + TCAM.cx, TCAM.fy * pc[:, 1] / pc[:, 2] + TCAM.cy], -1)
    x = (x + rng.normal(0, 0.5, x.shape)).astype(np.float32)
    bad = rng.random(n) < 0.3
    x[bad] = (rng.random((int(bad.sum()), 2)) * 500).astype(np.float32)
    valid = rng.random(n) > 0.05
    key = jax.random.PRNGKey(3)
    g = jax.random.gumbel(key, (jpnp.N_HYPOTHESES, n)) + jnp.where(J(valid), 0.0, -1e9)[None]
    idx = np.asarray(jax.lax.top_k(g, jpnp.MIN_SET)[1])
    Rj, tj, inl_j, n_j = jpnp.pnp_ransac(JCAM, J(X), J(x), J(valid), key)
    Rt, tt, inl_t, n_t = tpnp._pnp_body(TCAM, T(X), T(x), T(valid), T(idx))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 100
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), R, atol=5e-3)
    # and the generator-driven entry runs the same body
    R2, t2, _, n2 = tpnp.pnp_ransac(TCAM, T(X), T(x), T(valid), torch.Generator().manual_seed(0))
    assert int(n2) >= int(n_t) - 2
