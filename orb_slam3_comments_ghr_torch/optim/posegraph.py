"""Essential-graph (pose-graph) optimization over Sim(3) / 4-DoF poses.

Port of `orb_slam3_comments_ghr_tpu/optim/posegraph.py`
(Optimizer::OptimizeEssentialGraph, reference src/Optimizer.cc:4527 loop
variant, :5683 merge variant, :4870 the 4-DoF inertial variant). Vertices
are per-keyframe Sim(3) world->cam transforms; an edge carries the
measured relative Sim(3) S_ij = S_i S_j^-1. Each Gauss-Newton step takes the
edges' 7x7 Jacobian blocks by forward-mode AD (`torch.func.jacfwd` over the
edges, as `jax.jacfwd` under `vmap`), then either

- assembles the dense (7K, 7K) system by `index_add_` of the blocks into
  their (K*K) slots and solves it by a scaled Cholesky (`cholesky_ex`,
  no host check: a failed factor gives a NaN step, as a failed
  `cho_factor` does in the JAX package), or
- solves the same normal equations matrix-free by block-Jacobi
  preconditioned conjugate gradients, a fixed number of iterations.

`solve_pose_graph` picks by size. With dof4, roll, pitch and scale are held
by large diagonal priors on those tangent components; the perturbation is
right-multiplicative on Scw, so they are rotations about world axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops import lie
from ..utils.device import forward_ad_locked


class PoseGraphProblem(NamedTuple):
    """K vertices, E edges.

    s/R/t: (K,) (K,3,3) (K,3) initial Sim(3) world->cam per keyframe
    fixed: (K,) bool, the gauge anchors
    e_i, e_j: (E,) int vertex indices
    e_s/e_R/e_t: measured relative Sim(3) S_ij = S_i S_j^-1
    e_valid: (E,) bool
    e_weight: (E,) float, 1 for normal edges, larger for loop edges
    """

    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    fixed: torch.Tensor
    e_i: torch.Tensor
    e_j: torch.Tensor
    e_s: torch.Tensor
    e_R: torch.Tensor
    e_t: torch.Tensor
    e_valid: torch.Tensor
    e_weight: torch.Tensor


# keyframe count above which the dense (7K,7K) Cholesky gives way to CG
DENSE_MAX_K = 512


def _edge_residual(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """r = log_sim3(S_ij_meas^-1 (S_i exp(xi_i)) (S_j exp(xi_j))^-1)."""
    s_i, R_i, t_i = lie.sim3_mul(si, Ri, ti, *lie.sim3_exp(xi_i))
    s_j, R_j, t_j = lie.sim3_mul(sj, Rj, tj, *lie.sim3_exp(xi_j))
    rel = lie.sim3_mul(s_i, R_i, t_i, *lie.sim3_inv(s_j, R_j, t_j))
    return lie.sim3_log(*lie.sim3_mul(*lie.sim3_inv(ms, mR, mt), *rel))


def _residual_and_value(xi_i, xi_j, *args):
    r = _edge_residual(xi_i, xi_j, *args)
    return r, r


_edge_jacobians = forward_ad_locked(vmap(jacfwd(_residual_and_value, argnums=(0, 1),
                                                has_aux=True)))


def _edge_blocks(prob: PoseGraphProblem, s, R, t):
    """Per-edge GN blocks Hii / Hjj / Hij (E,7,7), bi / bj (E,7) and the
    weighted cost, invalid edges at weight 0."""
    ei, ej = prob.e_i.long(), prob.e_j.long()
    z = torch.zeros((ei.shape[0], 7), dtype=t.dtype, device=t.device)
    (Ji, Jj), r = _edge_jacobians(z, z, s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
                                  prob.e_s, prob.e_R, prob.e_t)
    w = torch.where(prob.e_valid, prob.e_weight, 0.0)
    Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
    Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
    Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
    bi = torch.einsum("eri,e,er->ei", Ji, w, r)
    bj = torch.einsum("eri,e,er->ei", Jj, w, r)
    return Hii, Hjj, Hij, bi, bj, torch.sum(w * torch.sum(r * r, -1))


def _vertex_prior(prob: PoseGraphProblem, dof4: bool) -> torch.Tensor:
    """(K,7,7) diagonal prior per vertex: gauge anchors, the frozen
    components of the 4-DoF variant, and a small ridge."""
    dtype, dev = prob.t.dtype, prob.t.device
    diag = torch.full((7,), 1e-8, dtype=dtype, device=dev)
    if dof4:  # roll (phi_x), pitch (phi_y) and scale
        diag[[3, 4, 6]] = 1e10
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    return torch.diag(diag)[None] + prob.fixed[:, None, None] * 1e12 * eye7 + 1e-6 * eye7


def _rhs(prob, bi, bj, K: int) -> torch.Tensor:
    b = torch.zeros((K, 7), dtype=bi.dtype, device=bi.device)
    return b.index_add_(0, prob.e_i.long(), bi).index_add_(0, prob.e_j.long(), bj)


def _apply_step(prob, s, R, t, dx):
    dx = torch.where(prob.fixed[:, None], 0.0, dx)
    return lie.sim3_mul(s, R, t, *lie.sim3_exp(dx))


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20, dof4: bool = False):
    """Dense path. Returns the corrected (s, R, t) per keyframe and the
    cost before each step (iters,)."""
    K = prob.s.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    k = torch.arange(K, device=ei.device)
    prior = _vertex_prior(prob, dof4)
    s, R, t = prob.s, prob.R, prob.t
    costs = []
    for _ in range(iters):
        Hii, Hjj, Hij, bi, bj, cost = _edge_blocks(prob, s, R, t)
        Hb = torch.zeros((K * K, 7, 7), dtype=t.dtype, device=t.device)
        Hb.index_add_(0, ei * K + ei, Hii).index_add_(0, ej * K + ej, Hjj)
        Hb.index_add_(0, ei * K + ej, Hij).index_add_(0, ej * K + ei, Hij.transpose(-1, -2))
        Hb.index_add_(0, k * K + k, prior)
        H = Hb.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        bd = _rhs(prob, bi, bj, K).reshape(7 * K)
        d = torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-12))
        L, info = torch.linalg.cholesky_ex(H / d[:, None] / d[None, :])
        dx = torch.cholesky_solve((-bd / d)[:, None], L)[:, 0] / d
        dx = torch.where(info == 0, dx, torch.nan).reshape(K, 7)
        s, R, t = _apply_step(prob, s, R, t, dx)
        costs.append(cost)
    return s, R, t, torch.stack(costs)


def optimize_pose_graph_cg(prob: PoseGraphProblem, iters: int = 20, dof4: bool = False,
                           cg_iters: int = 100):
    """Matrix-free path: the same GN linearization, the normal equations
    solved by block-Jacobi preconditioned CG with `cg_iters` iterations
    (O(E) memory: per-edge 7x7 blocks, not the (7K)^2 Hessian). Returns
    (s, R, t, costs) as `optimize_pose_graph`."""
    K = prob.s.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    prior = _vertex_prior(prob, dof4)
    s, R, t = prob.s, prob.R, prob.t
    costs = []
    for _ in range(iters):
        Hii, Hjj, Hij, bi, bj, cost = _edge_blocks(prob, s, R, t)
        D = torch.zeros((K, 7, 7), dtype=t.dtype, device=t.device)
        D = D.index_add_(0, ei, Hii).index_add_(0, ej, Hjj) + prior
        Dinv = torch.linalg.inv_ex(D)[0]
        HijT = Hij.transpose(-1, -2)

        def hmul(x):
            y = torch.zeros_like(x)
            y.index_add_(0, ei, lie._matvec(Hij, x[ej])).index_add_(0, ej, lie._matvec(HijT, x[ei]))
            return y + lie._matvec(D, x)

        r = -_rhs(prob, bi, bj, K)
        x = torch.zeros_like(r)
        z = lie._matvec(Dinv, r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            Ap = hmul(p)
            alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            z = lie._matvec(Dinv, r)
            rzn = torch.sum(r * z)
            p = z + (rzn / torch.clamp_min(rz, 1e-20)) * p
            rz = rzn
        s, R, t = _apply_step(prob, s, R, t, x)
        costs.append(cost)
    return s, R, t, torch.stack(costs)


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 20, dof4: bool = False):
    """Dense Cholesky for graphs up to DENSE_MAX_K keyframes, block-Jacobi
    CG above."""
    if prob.s.shape[0] <= DENSE_MAX_K:
        return optimize_pose_graph(prob, iters=iters, dof4=dof4)
    return optimize_pose_graph_cg(prob, iters=iters, dof4=dof4)
