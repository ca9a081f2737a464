"""Two-view reconstruction for monocular map initialization.

Port of `orb_slam3_comments_ghr_tpu/optim/twoview.py`
(TwoViewReconstruction, reference src/TwoViewReconstruction.cc): all 200
homography and 200 fundamental RANSAC hypotheses are fitted and scored as
one batch, the model is chosen by the score ratio RH > 0.5, and the 8
homography motions (Faugeras) and 4 essential motions are checked for
cheirality and parallax (CheckRT).

`jax.vmap` over hypotheses and motions becomes a leading batch axis. The
minimal sets are drawn by Gumbel top-k, as in the JAX package, from a
`torch.Generator`; `_reconstruct_body` takes the drawn index sets, so a test
can hand it the sets that JAX drew.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import cameras, triangulate

RANSAC_ITERS = 200
SIGMA = 1.0
TH_F = 3.841
TH_H = 5.991
SCORE_TH = 5.991  # both models accumulate (SCORE_TH - chi2), ref :481,:559
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization (TwoViewReconstruction::Normalize, :753)."""
    n = torch.clamp_min(valid.sum(), 1)
    mean = torch.where(valid[:, None], pts, 0.0).sum(0) / n
    meandev = torch.where(valid[:, None], torch.abs(pts - mean), 0.0).sum(0) / n
    s = 1.0 / torch.clamp_min(meandev, 1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * s, T


def _sample_minimal(generator: torch.Generator, valid: torch.Tensor, n_sets: int, set_size: int):
    """(n_sets, set_size) indices drawn from the valid matches: Gumbel
    noise plus a -1e9 logit on invalid rows, top set_size per set (stable
    descending sort: ties go to the lowest index, as lax.top_k)."""
    n = valid.shape[0]
    u = torch.rand((n_sets, n), generator=generator, device=valid.device)
    u = torch.clamp(u, torch.finfo(torch.float32).tiny, 1.0)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)[None]
    return torch.sort(g, dim=-1, descending=True, stable=True)[1][:, :set_size]


def _fit_homography(x1, x2):
    """4+-point DLT: x1, x2 (...,S,2) normalized -> H (...,3,3), x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zeros, ones = torch.zeros_like(u1), torch.ones_like(u1)
    rows_a = torch.stack([zeros, zeros, zeros, -u1, -v1, -ones, v2 * u1, v2 * v1, v2], -1)
    rows_b = torch.stack([u1, v1, ones, zeros, zeros, zeros, -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([rows_a, rows_b], dim=-2)  # (...,2S,9)
    return torch.linalg.svd(A, full_matrices=True).Vh[..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _fit_fundamental(x1, x2):
    """8-point: A f = 0, then rank 2 enforced."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)
    F = torch.linalg.svd(A, full_matrices=True).Vh[..., 8, :].reshape(A.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vh


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _score_homography(H, x1, x2, valid):
    """Symmetric transfer error score (CheckHomography, :414). H (...,3,3)
    against all N matches; returns (score (...,), ok (...,N))."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def transfer(M, a, b):
        p = _homog(a) @ M.transpose(-1, -2)
        w = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        return torch.sum((b - p[..., :2] / w[..., None]) ** 2, dim=-1) / (SIGMA * SIGMA)

    c1 = transfer(H, x1, x2)
    c2 = transfer(Hinv, x2, x1)
    ok = valid & (c1 < TH_H) & (c2 < TH_H)
    score = torch.sum(
        torch.where(valid & (c1 < TH_H), SCORE_TH - c1, 0.0)
        + torch.where(valid & (c2 < TH_H), SCORE_TH - c2, 0.0), dim=-1)
    return score, ok


def _score_fundamental(F, x1, x2, valid):
    """Epipolar distance score (CheckFundamental, :558)."""
    p1, p2 = _homog(x1), _homog(x2)
    l2 = p1 @ F.transpose(-1, -2)  # epipolar line in image 2
    l1 = p2 @ F
    num = torch.sum(p2 * l2, dim=-1)
    d2 = num * num / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12) / (SIGMA * SIGMA)
    num1 = torch.sum(p1 * l1, dim=-1)
    d1 = num1 * num1 / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12) / (SIGMA * SIGMA)
    ok = valid & (d1 < TH_F) & (d2 < TH_F)
    score = torch.sum(
        torch.where(valid & (d2 < TH_F), SCORE_TH - d2, 0.0)
        + torch.where(valid & (d1 < TH_F), SCORE_TH - d1, 0.0), dim=-1)
    return score, ok


def _check_rt(R, t, K, x1, x2, inliers):
    """Triangulate all matches under each motion (R (...,3,3), t (...,3))
    and count good points (CheckRT, :905): cheirality in both views, finite,
    parallax, reprojection < 4 sigma^2. Returns (n_good, median-ish parallax
    cosine, points, good mask), each with the motions' batch shape."""
    dev = K.device
    P1 = triangulate.projection_matrix(K, torch.eye(3, device=dev), torch.zeros(3, device=dev))
    P2 = triangulate.projection_matrix(K, R, t)
    X = triangulate.triangulate(P1, P2[..., None, :, :], x1, x2)  # (...,N,3), cam1 frame
    finite = torch.isfinite(X).all(-1)

    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # cam2 centre in cam1 frame
    n2 = X - C2[..., None, :]
    cosp = torch.sum(X * n2, -1) / torch.clamp_min(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), 1e-12)
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    good_depth = (X[..., 2] > 0) & (Xc2[..., 2] > 0)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj(Xc, x):
        z = torch.clamp_min(Xc[..., 2], 1e-9)
        u = fx * Xc[..., 0] / z + cx
        v = fy * Xc[..., 1] / z + cy
        return (u - x[..., 0]) ** 2 + (v - x[..., 1]) ** 2

    th2 = 4.0 * SIGMA * SIGMA
    good = (inliers & finite & good_depth & (reproj(X, x1) < th2)
            & (reproj(Xc2, x2) < th2) & (cosp < 0.99998))
    n_good = good.sum(-1, dtype=torch.int32)
    # a mid-quantile cosine, as the reference takes the 50th-best parallax
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1)[0]
    k = torch.clamp(n_good - 1, 0, 49)
    parallax_cos = torch.gather(cos_sorted, -1, k[..., None].long())[..., 0]
    return n_good, parallax_cos, X, good


def _motions_from_f(F, K):
    """E = K^T F K -> 4 candidate (R, t) (DecomposeE, :1079)."""
    E = K.T @ F @ K
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=F.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    t = t / torch.clamp_min(torch.linalg.norm(t), 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H, K):
    """Faugeras SVD decomposition of a calibrated homography -> 8 candidate
    motions (ReconstructH, :661). A = K^-1 H K = d R + t n^T."""
    A = torch.linalg.inv_ex(K)[0] @ H @ K
    U, w, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = w[0], w[1], w[2]
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], device=H.device)

    den = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den, 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den, 0.0))
    x1v = torch.stack([aux1, aux1, -aux1, -aux1])
    x3v = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def motion(Rp, tp):
        R = s * U @ Rp @ Vh
        t = U @ tp
        return R, t / torch.clamp_min(torch.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    # case d' > 0
    sin_t = root / torch.clamp_min((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, 1e-12)
    for i in range(4):
        st = signs[i] * sin_t
        Rp = torch.stack([torch.stack([cos_t, zero, -st]), torch.stack([zero, one, zero]),
                          torch.stack([st, zero, cos_t])])
        R, t = motion(Rp, torch.stack([x1v[i], zero, -x3v[i]]) * (d1 - d3))
        Rs.append(R)
        ts.append(t)
    # case d' < 0
    sin_p = root / torch.clamp_min((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3) * d2, 1e-12)
    for i in range(4):
        sp = signs[i] * sin_p
        Rp = torch.stack([torch.stack([cos_p, zero, sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cos_p])])
        R, t = motion(Rp, torch.stack([x1v[i], zero, x3v[i]]) * (d1 + d3))
        Rs.append(R)
        ts.append(t)
    return torch.stack(Rs), torch.stack(ts)


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # bool
    R: torch.Tensor                # (3,3) cam1->cam2
    t: torch.Tensor                # (3,) unit norm
    points: torch.Tensor           # (N,3) in cam1 frame
    good: torch.Tensor             # (N,) triangulated-point mask
    used_homography: torch.Tensor  # bool


def reconstruct(cam: cameras.Camera, uv1, uv2, valid, generator: torch.Generator) -> TwoViewResult:
    """uv1/uv2: (N,2) matched pixels in frames 1/2; valid: (N,) mask; the
    RANSAC sets are drawn from `generator` (on the inputs' device).
    Mirrors TwoViewReconstruction::Reconstruct (:81)."""
    idx_h = _sample_minimal(generator, valid, RANSAC_ITERS, 4)
    idx_f = _sample_minimal(generator, valid, RANSAC_ITERS, 8)
    return _reconstruct_body(cam, uv1, uv2, valid, idx_h, idx_f)


def _reconstruct_body(cam, uv1, uv2, valid, idx_h, idx_f) -> TwoViewResult:
    """The reconstruction for given minimal sets idx_h (200,4), idx_f
    (200,8)."""
    K = cameras.camera_matrix(cam, uv1.device)
    x1n, T1 = _normalize(uv1, valid)
    x2n, T2 = _normalize(uv2, valid)
    idx_h, idx_f = idx_h.long(), idx_f.long()

    Hs = torch.linalg.inv_ex(T2)[0] @ _fit_homography(x1n[idx_h], x2n[idx_h]) @ T1
    Fs = T2.T @ _fit_fundamental(x1n[idx_f], x2n[idx_f]) @ T1
    h_scores, _ = _score_homography(Hs, uv1, uv2, valid)
    f_scores, _ = _score_fundamental(Fs, uv1, uv2, valid)
    bi_h = torch.argmax(h_scores)
    bi_f = torch.argmax(f_scores)
    SH, H = h_scores[bi_h], Hs[bi_h]
    SF, F = f_scores[bi_f], Fs[bi_f]
    _, inl_h = _score_homography(H, uv1, uv2, valid)
    _, inl_f = _score_fundamental(F, uv1, uv2, valid)

    prefer_h = SH / torch.clamp_min(SH + SF, 1e-9) > 0.50

    Rs_h, ts_h = _motions_from_h(H, K)
    Rs_f, ts_f = _motions_from_f(F, K)
    Rs = torch.cat([Rs_h, Rs_f])  # (12,3,3)
    ts = torch.cat([ts_h, ts_f])
    from_h = torch.arange(12, device=uv1.device) < 8
    # each candidate is checked against its own model's inlier set
    inl12 = torch.where(from_h[:, None], inl_h[None, :], inl_f[None, :])
    n_good, par_cos, X, good = _check_rt(Rs, ts, K, uv1, uv2, inl12)

    min_parallax_cos = math.cos(math.radians(MIN_PARALLAX_DEG))

    def family_pick(member_mask, inl):
        ng = torch.where(member_mask, n_good, -1)
        best = torch.argmax(ng)
        best_good = ng[best]
        second = torch.sort(ng)[0][-2]
        n_inl = inl.sum(dtype=torch.int32)
        min_good = torch.clamp_min((0.9 * n_inl.to(torch.float32)).to(torch.int32), MIN_TRIANGULATED)
        parallax_ok = par_cos[best] < min_parallax_cos
        unique = second.to(torch.float32) < 0.75 * best_good.to(torch.float32)
        return (best_good >= min_good) & unique & parallax_ok, best

    ok_h, best_h = family_pick(from_h, inl_h)
    ok_f, best_f = family_pick(~from_h, inl_f)
    # the preferred family, or the other one when the preferred one fails
    # its cheirality/parallax gates (both are already verified here)
    use_h = (prefer_h & ok_h) | (~prefer_h & ~ok_f & ok_h)
    best = torch.where(use_h, best_h, best_f)
    return TwoViewResult(
        success=ok_h | ok_f, R=Rs[best], t=ts[best], points=X[best], good=good[best],
        used_homography=use_h,
    )
