"""Distributed bundle adjustment over the ranks of a `torch.distributed`
world.

Port of `orb_slam3_comments_ghr_tpu/parallel/dba.py` (SURVEY.md §2.3 P6,
§5.8). The landmark rows and their observations are sharded over the ranks
of a `distributed.Mesh`, each rank holding a contiguous slice; every rank
evaluates its observations and Schur-eliminates its own landmarks with the
single-device BA's pieces (`optim/ba.py`), then the reduced camera system
(small, dense) is summed over the ranks and solved replicated; the landmark
back-substitution is again local. The JAX package sums with five `psum`s
per LM iteration; here S, rhs, diag(H_cc) and the cost go in one flat
`all_reduce` and the trial cost in a second. The LM math and its
accept/reject (lam x 0.5 / x 5) are the JAX package's.

Every rank must see the same problem and leave with the same cameras:
`broadcast_problem` gives every rank rank 0's problem (float `index_add_`
on a card is not deterministic, so two ranks' maps may differ in their last
bits), the all-reduced sums are the same bits on every rank, so each rank
takes the same steps, and `gather_rows` assembles the whole point arrays
on every rank.

A mesh of one rank (a single process) runs the same code with no
collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import cameras, lie
from ..optim import ba
from .distributed import Mesh

_POINT_FIELDS = ("p", "p_valid", "obs_cam", "obs_uv", "obs_ur", "obs_level", "obs_valid",
                 "obs_rig")
_FLOAT_FIELDS = ("cam_R", "cam_t", "p", "obs_uv", "obs_ur", "rig_R", "rig_t")
_INT_FIELDS = ("cam_fixed", "p_valid", "obs_cam", "obs_level", "obs_valid", "obs_rig")


def _all_reduce(x: torch.Tensor, mesh: Mesh, op=None) -> torch.Tensor:
    if mesh.size > 1:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.group)
    return x


def shard_problem(prob: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """This rank's shard: the point-indexed arrays cut to its contiguous
    slice of P / mesh.size rows, the camera arrays whole. P must divide by
    the mesh's size."""
    P = prob.p.shape[0]
    if P % mesh.size:
        raise ValueError(f"{P} points do not divide over {mesh.size} ranks")
    n = P // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return prob._replace(**{f: getattr(prob, f)[rows] for f in _POINT_FIELDS
                            if getattr(prob, f) is not None})


def broadcast_problem(prob: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """Rank 0's problem on every rank, which must hold one of the same
    shapes: the float fields in one broadcast, the integer and boolean ones
    in another."""
    if mesh.size == 1:
        return prob
    out = {}
    for names, dtype in ((_FLOAT_FIELDS, prob.p.dtype), (_INT_FIELDS, torch.int32)):
        fields = [(f, getattr(prob, f)) for f in names if getattr(prob, f) is not None]
        flat = torch.cat([a.reshape(-1).to(dtype) for _, a in fields])
        dist.broadcast(flat, src=0, group=mesh.group)  # a mesh's first rank is rank 0
        at = 0
        for f, a in fields:
            out[f] = flat[at:at + a.numel()].reshape(a.shape).to(a.dtype)
            at += a.numel()
    return prob._replace(**out)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (P, ...) array on every rank from each rank's contiguous
    (P / size, ...) slice: an all_reduce of a zero-filled buffer that each
    rank fills in its own rows (x + 0 is exact; gloo's all_gather takes CPU
    tensors only)."""
    if mesh.size == 1:
        return x
    n = x.shape[0]
    full = torch.zeros((n * mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    full[mesh.rank * n:(mesh.rank + 1) * n] = x
    return _all_reduce(full, mesh)


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank when it is true on one (an all_reduce MAX)."""
    if mesh.size == 1:
        return bool(flag)
    x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    return bool(_all_reduce(x, mesh, dist.ReduceOp.MAX).item())


def same_on_all_ranks(values, mesh: Mesh, device) -> bool:
    """Whether the integers `values` are equal on every rank (one
    all_reduce MAX of the values and their negations)."""
    if mesh.size == 1:
        return True
    v = torch.tensor(list(values), dtype=torch.int64, device=device)
    both = _all_reduce(torch.cat([v, -v]), mesh, dist.ReduceOp.MAX)
    return bool(torch.equal(both[:len(v)], -both[len(v):]))


def bundle_adjust_sharded(cam: cameras.Camera, prob: ba.BAProblem, mesh: Mesh,
                          iters: int = 10, use_huber: bool = True, lam0=None):
    """Distributed LM with Schur reduction on this rank's shard
    (`shard_problem`). Same semantics as optim.ba.bundle_adjust, landmark
    work sharded over the mesh. Returns (cam_R, cam_t, p, inlier, cost,
    lam): the cameras, the total cost and lam the same on every rank, p and
    inlier this rank's rows; lam is threaded in and out so that the mapper
    can chain abortable bites as the single-device whole-map BA does
    (mbStopGBA, LoopClosing.cc:3067)."""
    K = prob.cam_R.shape[0]
    dt = prob.p.dtype
    R, t, p = prob.cam_R, prob.cam_t, prob.p
    lam = (torch.tensor(1e-4) if lam0 is None else lam0).to(dtype=dt, device=p.device)
    sizes = (36 * K * K, 6 * K, 6 * K, 1)
    for _ in range(iters):
        r, Jc, Jp, w, chi2, row_mask, delta2 = ba._obs_terms(cam, prob, R, t, p, use_huber)
        cost0 = ba._cost(chi2, delta2, prob.obs_valid, use_huber)
        H_pp, b_p, H_cc, b_c, W = ba._assemble(prob, r, Jc, Jp, w, row_mask, K)
        Hpp_inv = ba._point_blocks_inv(H_pp, prob.p_valid, lam)
        S, rhs = ba._reduced_system(prob.obs_cam, H_cc, b_c, W, Hpp_inv, b_p, K)
        diag = torch.diagonal(H_cc, dim1=-2, dim2=-1)
        # THE collective: the camera system summed over the landmark shards
        flat = _all_reduce(torch.cat([S.reshape(-1), rhs.reshape(-1), diag.reshape(-1),
                                      cost0.reshape(1)]), mesh)
        S, rhs, diag, cost0 = torch.split(flat, sizes)
        dxc = ba._solve_reduced(S.reshape(K, K, 6, 6), rhs.reshape(K, 6), prob.cam_fixed,
                                diag.reshape(K, 6), lam, K)
        dp = ba._backsubstitute(prob.obs_cam, W, Hpp_inv, b_p, prob.p_valid, dxc)
        R_new, t_new = lie.se3_mul(*lie.se3_exp(dxc), R, t)
        p_new = p + dp
        chi2_new = ba._obs_terms(cam, prob, R_new, t_new, p_new, use_huber)[4]
        cost1 = _all_reduce(ba._cost(chi2_new, delta2, prob.obs_valid, use_huber).reshape(1),
                            mesh)
        better = cost1[0] < cost0[0]
        R, t, p = (torch.where(better, R_new, R), torch.where(better, t_new, t),
                   torch.where(better, p_new, p))
        lam = torch.where(better, lam * 0.5, lam * 5.0)
    chi2, delta2 = ba._obs_terms(cam, prob, R, t, p, use_huber=False)[4::2]
    inlier = prob.obs_valid & (chi2 <= delta2)
    cost = _all_reduce(ba._cost(chi2, delta2, prob.obs_valid, False).reshape(1), mesh)[0]
    return R, t, p, inlier, cost, lam
