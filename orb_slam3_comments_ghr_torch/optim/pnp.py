"""Batched PnP RANSAC for relocalization.

Port of `orb_slam3_comments_ghr_tpu/optim/pnp.py` (MLPnPsolver's role in
Tracking::Relocalization, Tracking.cc:4508-4548): 256 minimal sets of 6
drawn at once by Gumbel top-k, a linear DLT PnP with orthogonality
projection per set, the best-scoring hypothesis polished by the pose LM.
The sets are drawn from a `torch.Generator`; `_pnp_body` takes them, so a
test can hand it the sets that JAX drew.
"""

from __future__ import annotations

import torch

from ..ops import cameras
from . import pose_opt
from .twoview import _sample_minimal

N_HYPOTHESES = 256
MIN_SET = 6


def _dlt_pnp(K_inv, X, x):
    """Linear PnP from 6+ correspondences, batched: X (...,S,3) world, x
    (...,S,2) pixels. Returns (R, t) world->cam."""
    xn = torch.cat([x, torch.ones_like(x[..., :1])], -1) @ K_inv.T
    u = xn[..., 0] / xn[..., 2]
    v = xn[..., 1] / xn[..., 2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)  # (...,S,4)
    z4 = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, z4, -u[..., None] * Xh], dim=-1)
    rows_v = torch.cat([z4, Xh, -v[..., None] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (...,2S,12)
    P = torch.linalg.svd(A, full_matrices=True).Vh[..., 11, :].reshape(A.shape[:-2] + (3, 4))
    # scale and sign: det(M) > 0 and unit-average singular value
    sgn = torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    U, S, Vh = torch.linalg.svd(P[..., :3])
    scale = S.mean(-1)
    return U @ Vh, P[..., 3] / torch.clamp_min(scale, 1e-12)[..., None]


def pnp_ransac(cam: cameras.Camera, X, x, valid, generator: torch.Generator,
               n_hyp: int = N_HYPOTHESES, inlier_th_px: float = 5.991 ** 0.5 * 2.0):
    """X (N,3) world points, x (N,2) observed pixels, valid (N,). Returns
    (R, t, inlier_mask, n_inliers): the best hypothesis refined by the pose
    LM (4 rounds x 5 iterations)."""
    return _pnp_body(cam, X, x, valid, _sample_minimal(generator, valid, n_hyp, MIN_SET), inlier_th_px)


def _pnp_body(cam, X, x, valid, idx, inlier_th_px: float = 5.991 ** 0.5 * 2.0):
    """The RANSAC for given minimal sets idx (n_hyp, 6)."""
    n = X.shape[0]
    idx = idx.long()
    K_inv = torch.linalg.inv_ex(cameras.camera_matrix(cam, X.device))[0]
    Rs, ts = _dlt_pnp(K_inv, X[idx], x[idx])            # (H,3,3), (H,3)
    pc = X @ Rs.transpose(-1, -2) + ts[:, None, :]      # (H,N,3)
    err = torch.sum((cameras.project(cam, pc) - x) ** 2, -1)
    inl = valid & (pc[..., 2] > 0) & (err < inlier_th_px ** 2)
    best = torch.argmax(inl.sum(-1, dtype=torch.int32))
    obs = pose_opt.PoseObs(
        p_world=X, uv=x, u_right=torch.full((n,), -1.0, device=X.device),
        level=torch.zeros((n,), dtype=torch.int32, device=X.device), valid=valid,
    )
    return pose_opt.optimize_pose(cam, Rs[best], ts[best], obs, iters_per_round=5)
