"""Sim(3) estimation between two keyframes' matched map-point sets.

Port of `orb_slam3_comments_ghr_tpu/optim/sim3.py` (Sim3Solver, reference
src/Sim3Solver.cc: Horn's closed-form 3-point similarity inside RANSAC,
scale fixed for stereo / RGB-D; and Optimizer::OptimizeSim3,
src/Optimizer.cc:4213: LM on the 7-dim tangent with reprojection residuals
both ways, chi2 10).

All RANSAC hypotheses are solved and scored as one batch. The JAX package
draws the minimal sets inside the jitted call (`jax.random.gumbel` and
`top_k`); here the draw is its own function on an explicit
`torch.Generator`, and `sim3_ransac` takes the (n_hyp, 3) index sets, so
that a test can feed it the JAX package's draws.

The rotation of Horn's method is U diag(1, 1, det(U V^T)) V^T for the SVD
M = U S V^T (the JAX package takes `jnp.linalg.svd`). That equals
u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T, which needs only the two leading
singular pairs; they come from a fixed number of cyclic Jacobi sweeps on
M^T M in float64, so no solver waits for the host to check its result. A
3-point set gives a rank-2 M, where this form stays exact.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..ops import cameras, lie
from ..utils.device import forward_ad_locked

RANSAC_ITERS = 256
CHI2_SIM3 = 10.0
_JACOBI_SWEEPS = 5


def _sym_eig3(A: torch.Tensor):
    """Eigenvalues (...,3) and eigenvectors (columns of (...,3,3)) of
    symmetric 3x3 matrices by cyclic Jacobi rotations (Numerical Recipes
    `jacobi`), a fixed number of sweeps."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = A[..., p, q]
            nz = apq != 0
            theta = (A[..., q, q] - A[..., p, p]) / (2.0 * torch.where(nz, apq, 1.0))
            sgn = torch.where(theta >= 0, 1.0, -1.0)
            t = torch.where(nz, sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0)), 0.0)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            J = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def _kabsch_rotation(M: torch.Tensor) -> torch.Tensor:
    """argmax over rotations R of tr(R^T M), for (...,3,3) M (float32
    in, float32 out; float64 inside)."""
    M64 = M.to(torch.float64)
    lam, V = _sym_eig3(M64.transpose(-1, -2) @ M64)
    order = torch.sort(lam, dim=-1, descending=True, stable=True).indices
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    v1, v2 = V[..., :, 0], V[..., :, 1]
    u1, u2 = lie._matvec(M64, v1), lie._matvec(M64, v2)
    u1 = u1 / torch.clamp_min(torch.linalg.norm(u1, dim=-1, keepdim=True), 1e-300)
    u2 = u2 / torch.clamp_min(torch.linalg.norm(u2, dim=-1, keepdim=True), 1e-300)
    u3, v3 = torch.linalg.cross(u1, u2), torch.linalg.cross(v1, v2)
    R = sum(u[..., :, None] * v[..., None, :] for u, v in ((u1, v1), (u2, v2), (u3, v3)))
    return R.to(M.dtype)


def _similarity(c1, c2, o1, o2, fix_scale: bool):
    """(s, R, t) from centred sets c1, c2 (...,S,3) and their centroids."""
    R = _kabsch_rotation(c1.transpose(-1, -2) @ c2)
    if fix_scale:
        s = torch.ones(c1.shape[:-2], dtype=c1.dtype, device=c1.device)
    else:
        num = torch.sum(c1 * (c2 @ R.transpose(-1, -2)), dim=(-1, -2))
        s = num / torch.clamp_min(torch.sum(c2 * c2, dim=(-1, -2)), 1e-12)
    return s, R, o1 - s[..., None] * lie._matvec(R, o2)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity p1 ~= s R p2 + t from >= 3 correspondences
    (Horn 1987, as Sim3Solver::ComputeSim3). p1, p2: (...,S,3)."""
    o1, o2 = p1.mean(-2), p2.mean(-2)
    return _similarity(p1 - o1[..., None, :], p2 - o2[..., None, :], o1, o2, fix_scale)


def draw_minimal_sets(valid: torch.Tensor, generator: torch.Generator,
                      n_hyp: int = RANSAC_ITERS) -> torch.Tensor:
    """(n_hyp, 3) indices: three distinct valid rows per hypothesis, drawn
    uniformly (the top 3 of uniform keys, the invalid rows' keys below
    every valid one), on `valid`'s device."""
    keys = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    return torch.topk(torch.where(valid[None], keys, -1.0), 3, dim=-1).indices


def sim3_ransac(cam: cameras.Camera, p1, p2, level1, level2, valid, idx,
                fix_scale: bool = False):
    """Returns (s12, R12, t12, inlier_mask, n_inliers): p1 ~= S12 p2, from
    the minimal sets `idx` (n_hyp, 3). The inlier check is
    Sim3Solver::CheckInliers: both directions projected, chi2 against
    9.21 sigma^2 per octave."""
    sig1 = 9.21 * (1.2 ** level1.to(torch.float32)) ** 2
    sig2 = 9.21 * (1.2 ** level2.to(torch.float32)) ** 2
    uv1 = cameras.project(cam, p1)
    uv2 = cameras.project(cam, p2)

    def check(s, R, t):
        p2_in_1 = s[..., None, None] * (p2 @ R.transpose(-1, -2)) + t[..., None, :]
        e1 = torch.sum((cameras.project(cam, p2_in_1) - uv1) ** 2, -1)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        p1_in_2 = si[..., None, None] * (p1 @ Ri.transpose(-1, -2)) + ti[..., None, :]
        e2 = torch.sum((cameras.project(cam, p1_in_2) - uv2) ** 2, -1)
        return valid & (e1 < sig1) & (e2 < sig2) & (p2_in_1[..., 2] > 0) & (p1_in_2[..., 2] > 0)

    idx = idx.long()
    ss, Rs, ts = horn_sim3(p1[idx], p2[idx], fix_scale)
    bad = (~torch.isfinite(ss)) | (ss <= 1e-3) | (ss > 1e3)
    scores = torch.where(bad, -1, check(ss, Rs, ts).sum(-1))
    best = torch.argmax(scores)  # the first of ties, as jnp.argmax
    s, R, t = ss[best], Rs[best], ts[best]
    # re-solve on all inliers of the best hypothesis (the usual polish)
    w = check(s, R, t).to(p1.dtype)[:, None]
    nw = torch.clamp_min(w.sum(), 3.0)
    o1 = (p1 * w).sum(0) / nw
    o2 = (p2 * w).sum(0) / nw
    s2, R2, t2 = _similarity((p1 - o1) * w, (p2 - o2) * w, o1, o2, fix_scale)
    ok = torch.isfinite(s2) & (s2 > 1e-3) & (s2 < 1e3)
    s, R, t = torch.where(ok, s2, s), torch.where(ok, R2, R), torch.where(ok, t2, t)
    inl = check(s, R, t)
    return s, R, t, inl, inl.sum()


def optimize_sim3(cam: cameras.Camera, s0, R0, t0, p1, uv1, level1, p2, uv2, level2, valid,
                  fix_scale: bool = False, iters: int = 10):
    """Gauss-Newton refinement of S12 with reprojection residuals both ways
    and chi2-10 gating (OptimizeSim3). The JAX package's `lax.scan` is a
    loop of `iters` steps; every step and its inlier verdicts stay on the
    device. Returns (s, R, t, inliers, n)."""
    info1 = torch.sqrt((1.2 ** level1.to(torch.float32)) ** -2)[:, None]
    info2 = torch.sqrt((1.2 ** level2.to(torch.float32)) ** -2)[:, None]

    def pose(xi):
        ds, dR, dt = lie.sim3_exp(xi)
        s, R, t = lie.sim3_mul(ds, dR, dt, s0, R0, t0)
        return (s0 if fix_scale else s), R, t

    def residuals(xi):
        s, R, t = pose(xi)
        r1 = (uv1 - cameras.project(cam, s * (p2 @ R.T) + t)) * info1
        si, Ri, ti = lie.sim3_inv(s, R, t)
        r2 = (uv2 - cameras.project(cam, si * (p1 @ Ri.T) + ti)) * info2
        return r1, r2

    def both(xi):
        r = residuals(xi)
        return r, r

    jac_and_value = forward_ad_locked(jacfwd(both, has_aux=True))
    eye7 = torch.eye(7, dtype=p1.dtype, device=p1.device)
    xi = torch.zeros(7, dtype=p1.dtype, device=p1.device)
    inlier = valid
    (J1, J2), (r1, r2) = jac_and_value(xi)
    for it in range(iters):
        w = inlier.to(p1.dtype)
        H = (torch.einsum("nri,n,nrj->ij", J1, w, J1)
             + torch.einsum("nri,n,nrj->ij", J2, w, J2))
        b = (torch.einsum("nri,n,nr->i", J1, w, r1)
             + torch.einsum("nri,n,nr->i", J2, w, r2))
        if fix_scale:
            H = H + 1e12 * eye7[6:7, :] * eye7[:, 6:7]
        xi = xi + torch.linalg.solve_ex(H + 1e-6 * eye7, -b)[0]
        # the next step's linearization gives the residuals at the new xi
        if it + 1 < iters:
            (J1, J2), (r1, r2) = jac_and_value(xi)
        else:
            r1, r2 = residuals(xi)
        inlier = (valid & (torch.sum(r1 * r1, -1) < CHI2_SIM3)
                  & (torch.sum(r2 * r2, -1) < CHI2_SIM3))
    s, R, t = pose(xi)
    return s, R, t, inlier, inlier.sum()
