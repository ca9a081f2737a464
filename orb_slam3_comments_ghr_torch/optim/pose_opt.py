"""Motion-only pose optimization (the per-frame hot path).

Port of `orb_slam3_comments_ghr_tpu/optim/pose_opt.py`: Levenberg-Marquardt
on the SE3 world->camera pose with Huber weights, 4 rounds x
`iters_per_round` iterations, chi2 inlier re-classification between rounds,
Huber on in rounds 0-1 only (Optimizer::PoseOptimization).

The JAX version leaves a round early, through a `lax.while_loop`, once a
step both succeeds and moves less than 1e-6. Testing that flag on the host
would synchronise with the device in every iteration, so here every round
runs all its iterations and, once the flag is set, `torch.where` freezes the
whole carry: the same values as the early exit, with no host sync.

With no host sync in its 40 steps, the LM can be captured: `PoseLMGraph`
replays it from a CUDA graph on the card, as the tracker calls it on every
frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie
from ..utils.device import GraphCache
from . import robust


class PoseObs(NamedTuple):
    """Padded frame<->map matches for pose optimization.

    p_world: (N,3) map point positions
    uv:      (N,2) observed pixels
    u_right: (N,)  observed right-image u (stereo/RGB-D), <0 if mono obs
    level:   (N,)  keypoint octave (information ladder)
    valid:   (N,)  padding/match mask
    """

    p_world: torch.Tensor
    uv: torch.Tensor
    u_right: torch.Tensor
    level: torch.Tensor
    valid: torch.Tensor


def _residuals_jacobians(cam: cameras.Camera, R, t, obs: PoseObs):
    """Residual r (N,3), Jacobian J = dr/dxi (N,3,6) for the left update
    T <- exp(xi) T, the row mask and the stereo mask. Row 2 is the right-u
    residual, active only for stereo observations."""
    pc = lie.se3_apply(R, t, obs.p_world)
    z = torch.clamp_min(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)
    is_stereo = obs.u_right >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)

    r_uv = obs.uv - uv_hat
    r_ur = torch.where(is_stereo, obs.u_right - ur_hat, 0.0)
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)

    # d(pc)/dxi = [I | -hat(pc)]
    J_proj = cameras.project_jac(cam, pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc = torch.cat([eye, -lie.hat(pc)], dim=-1)
    J_uv = -(J_proj @ dpc)
    # right-u row: d(ur)/dpc = d(u)/dpc + [0, 0, bf/z^2]
    zero = torch.zeros_like(z)
    d_ur_dpc = J_proj[:, 0, :] + torch.stack([zero, zero, cam.bf / (z * z)], dim=-1)
    J_ur = -(d_ur_dpc.unsqueeze(1) @ dpc)
    J = torch.cat([J_uv, J_ur], dim=1)
    row_mask = torch.cat(
        [torch.ones_like(r[..., :2], dtype=torch.bool), is_stereo[:, None]], dim=-1
    )
    return r, J, row_mask, is_stereo


def _chi2(r, row_mask, info):
    return torch.sum(torch.where(row_mask, r * r, 0.0), dim=-1) * info


def optimize_pose(
    cam: cameras.Camera,
    R0: torch.Tensor,
    t0: torch.Tensor,
    obs: PoseObs,
    iters_per_round: int = 10,
):
    """Returns (R, t, inlier_mask, n_inliers)."""
    info = robust.inv_level_sigma2(obs.level)
    inlier = obs.valid
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)

    R, t = R0, t0
    r, J, row_mask, is_stereo = _residuals_jacobians(cam, R, t, obs)
    delta2 = torch.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    for rnd in range(4):
        use_huber = rnd < 2

        def cost_of(chi2):
            c = robust.huber_cost(chi2, delta2) if use_huber else chi2
            return torch.sum(torch.where(inlier, c, 0.0))

        lam = torch.full((), 1e-3, dtype=R0.dtype, device=R0.device)
        done = torch.zeros((), dtype=torch.bool, device=R0.device)
        for _ in range(iters_per_round):
            chi2 = _chi2(r, row_mask, info)
            w = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
            w = torch.where(inlier, w * info, 0.0)
            # H = J^T W J, b = J^T W r (rows masked)
            Jm = torch.where(row_mask[..., None], J, 0.0)
            rm = torch.where(row_mask, r, 0.0)
            Jw = (Jm * w[:, None, None]).reshape(-1, 6)
            H = Jw.T @ Jm.reshape(-1, 6)
            b = Jw.T @ rm.reshape(-1)
            cost0 = cost_of(chi2)
            # solve_ex: no error check, so no host sync
            dx = torch.linalg.solve_ex(H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6, -b)[0]
            dR, dt = lie.se3_exp(dx)
            R_new, t_new = lie.se3_mul(dR, dt, R, t)
            r2, J2, rm2, _ = _residuals_jacobians(cam, R_new, t_new, obs)
            better = cost_of(_chi2(r2, rm2, info)) < cost0
            # a finished round holds its carry (the JAX early exit)
            take = better & ~done
            R = torch.where(take, R_new, R)
            t = torch.where(take, t_new, t)
            r = torch.where(take, r2, r)
            J = torch.where(take, J2, J)
            row_mask = torch.where(take, rm2, row_mask)
            lam = torch.where(done, lam, torch.where(better, lam * 0.5, lam * 4.0))
            # |dx| < 1e-6: sub-micrometer / sub-microradian step
            done = done | (better & (torch.sum(dx * dx) < 1e-12))
        # chi2 re-classification from the carried linearization
        chi2 = _chi2(r, row_mask, info)
        inlier = obs.valid & (chi2 <= delta2)

    return R, t, inlier, torch.sum(inlier.to(torch.int32))


class PoseLMGraph(GraphCache):
    """`optimize_pose` as the frame program calls it on every frame
    (`programs.track_against_points`, whose rows are always the local-point
    cap), replayed from a CUDA graph. Eager, its 40 LM steps are ~9.4k small
    kernels whose launches bound the host (PERF.md section 5); a replay
    launches them all at once. One graph per camera, iterations and input
    shapes (`GraphCache`). The outputs are clones: a caller may hold one
    result (the deep pipeline's frames in flight, a re-track) while the next
    call runs. On CPU tensors it is `optimize_pose` itself."""

    def __call__(self, cam: cameras.Camera, R0: torch.Tensor, t0: torch.Tensor, obs: PoseObs,
                 iters_per_round: int = 10):
        out = super().__call__(lambda *a: optimize_pose(cam, *a, iters_per_round),
                               (cam, iters_per_round), R0, t0, obs)
        return out if R0.device.type != "cuda" else tuple(x.clone() for x in out)
