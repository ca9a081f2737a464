"""Windowed bundle adjustment: Levenberg-Marquardt with the landmarks
eliminated by Schur complement.

Port of the windowed path of `orb_slam3_comments_ghr_tpu/optim/ba.py`
(g2o BlockSolver_6_3 + Levenberg with marginalized landmarks, reference
src/Optimizer.cc:1758 LocalBundleAdjustment). The problem is the same padded
structure of arrays: K camera poses, P landmarks, a dense (P, D) table of
observations per point. Per LM iteration:

  residuals / Jacobians : closed forms over (P, D)
  H_pp (P,3,3), b_p     : sums over the D axis
  H_cc, b_c             : segment sums of the observation blocks by camera
                          (`index_add_`)
  Schur complement      : S = H_cc - sum_p W_p Hpp^-1 W_p^T. Each point's
                          coupling blocks are summed into its (P, K) camera
                          slots by `index_add_`; the cross term is then one
                          (6K, 3P) x (3P, 6K) product
  reduced solve         : scaled dense Cholesky of the (6K, 6K) system
  back-substitution     : dp = Hpp^-1 (b_p - W^T dxc), batched 3x3

The JAX package phrases the segment sums as one-hot einsums so that they run
on the TPU's matrix unit; on a GPU a scatter-add is the direct form. The LM
accept/reject test stays on the device (`torch.where`), so an iteration
never waits for the host.

Whole-map BA (`bundle_adjust_resumable`, the global BA after a loop
closure) runs the same LM in bites of a few iterations, so that the host can
stop between bites. Its camera system is assembled one point chunk at a
time, and its Schur cross term by observation pairs: each point's (D, D)
pairs of camera slots are summed by one `index_add_` into (K*K) 6x6 blocks,
which stays proportional to the observations where the windowed path's
(P, K) slots would grow with the whole map.

A fisheye rig adds a second camera rigidly mounted on the keyframe
(EdgeSE3ProjectXYZToBody, OptimizableTypes.h:96-160): `obs_rig` picks per
observation a rigid offset applied after the keyframe pose (slot 0 the
keyframe's own camera, slot 1 the right one), and the Jacobians chain
through it. Problems without a rig leave the three rig fields None.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie
from . import robust


class BAProblem(NamedTuple):
    """Padded BA problem. K cams, P points, D max obs per point.

    cam_R: (K,3,3) world->cam rotations; cam_t: (K,3)
    cam_fixed: (K,) bool (gauge / boundary cameras)
    p: (P,3) landmark positions; p_valid: (P,) bool
    obs_cam: (P,D) int camera index (0 if padded)
    obs_uv: (P,D,2) observed pixels
    obs_ur: (P,D) right-u, < 0 for mono observations
    obs_level: (P,D) keypoint octave
    obs_valid: (P,D) bool
    obs_rig: (P,D) int rig-camera slot, or None (single camera)
    rig_R: (S,3,3) camera-0 -> rig-camera rotations (rig_R[0] = I), or None
    rig_t: (S,3) the matching translations, or None
    """

    cam_R: torch.Tensor
    cam_t: torch.Tensor
    cam_fixed: torch.Tensor
    p: torch.Tensor
    p_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_level: torch.Tensor
    obs_valid: torch.Tensor
    obs_rig: torch.Tensor | None = None
    rig_R: torch.Tensor | None = None
    rig_t: torch.Tensor | None = None


FIXED_PRIOR = 1e12


def _obs_terms(cam: cameras.Camera, prob: BAProblem, R, t, p, use_huber: bool):
    """Per-observation residuals, Jacobians, robust weights. Returns r
    (P,D,3), Jc (P,D,3,6), Jp (P,D,3,3), w (P,D), chi2 (P,D), row_mask
    (P,D,3), delta2 (P,D)."""
    oc = prob.obs_cam.long()
    Ro = R[oc]                                    # (P,D,3,3)
    pc0 = (Ro @ p[:, None, :, None])[..., 0] + t[oc]  # the keyframe camera's frame
    A, pc = _rig_chain(prob, pc0)
    z = torch.clamp_min(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)
    is_stereo = prob.obs_ur >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)

    r_uv = prob.obs_uv - uv_hat
    r_ur = torch.where(is_stereo, prob.obs_ur - ur_hat, 0.0)
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)
    row_mask = torch.cat([prob.obs_valid[..., None].expand(r_uv.shape),
                          (prob.obs_valid & is_stereo)[..., None]], dim=-1)

    J_proj = cameras.project_jac(cam, pc)         # (P,D,2,3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -lie.hat(pc0)], dim=-1)  # (P,D,3,6)
    zero = torch.zeros_like(z)
    d_ur_dpc = J_proj[..., 0, :] + torch.stack([zero, zero, cam.bf / (z * z)], dim=-1)
    dh_dpc = torch.cat([J_proj, d_ur_dpc[..., None, :]], dim=-2)  # (P,D,3,3)
    if A is not None:  # the perturbation acts on camera 0: dpc = A dpc0
        dpc_dxi, Ro = A @ dpc_dxi, A @ Ro
    Jc = -(dh_dpc @ dpc_dxi)
    Jp = -(dh_dpc @ Ro)

    info = robust.inv_level_sigma2(prob.obs_level)
    chi2 = torch.sum(torch.where(row_mask, r * r, 0.0), dim=-1) * info
    delta2 = torch.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    w = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = torch.where(prob.obs_valid, w * info, 0.0)
    return r, Jc, Jp, w, chi2, row_mask, delta2


def _rig_chain(prob, pc0):
    """(A, pc): each observation's rig rotation A (P,D,3,3) and its point
    in the observing camera's frame, pc = A pc0 + b; (None, pc0) without a
    rig."""
    if prob.obs_rig is None:
        return None, pc0
    slot = prob.obs_rig.long()
    A = prob.rig_R[slot]
    return A, (A @ pc0[..., None])[..., 0] + prob.rig_t[slot]


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of x (E, ...) into n segments by seg (E,)."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def _assemble(prob: BAProblem, r, Jc, Jp, w, row_mask, K: int):
    """Normal-equation blocks and the coupling blocks of the Schur
    complement: H_pp (P,3,3), b_p (P,3), H_cc (K,6,6), b_c (K,6), W
    (P,D,6,3). b = -J^T W r, so H dx = b is the descent step."""
    P, D = prob.obs_cam.shape
    Jcm = torch.where(row_mask[..., None], Jc, 0.0)
    Jpm = torch.where(row_mask[..., None], Jp, 0.0)
    rm = torch.where(row_mask, r, 0.0)
    wJc = Jcm * w[..., None, None]
    wJp = Jpm * w[..., None, None]

    H_pp = (wJp.transpose(-1, -2) @ Jpm).sum(1)
    b_p = -(wJp.transpose(-1, -2) @ rm[..., None])[..., 0].sum(1)
    flat_cam = prob.obs_cam.reshape(P * D).long()
    H_cc = _segment_sum((wJc.transpose(-1, -2) @ Jcm).reshape(P * D, 6, 6), flat_cam, K)
    b_c = -_segment_sum((wJc.transpose(-1, -2) @ rm[..., None]).reshape(P * D, 6), flat_cam, K)
    W = wJc.transpose(-1, -2) @ Jpm  # (P,D,6,3)
    return H_pp, b_p, H_cc, b_c, W


def _point_blocks_inv(H_pp, p_valid, lam):
    """Damped inverse of the landmark 3x3 blocks."""
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    diag = torch.clamp_min(torch.diagonal(H_pp, dim1=-2, dim2=-1), 1e-6)
    H_pp_d = H_pp + lam * diag[..., None, :] * eye3
    H_pp_d = H_pp_d + (~p_valid)[:, None, None] * eye3
    return torch.linalg.inv_ex(H_pp_d + 1e-8 * eye3)[0]


def _reduced_system(obs_cam, H_cc, b_c, W, Hpp_inv, b_p, K: int):
    """Schur-reduced camera system: S (K,K,6,6) and rhs (K,6).

    rhs = b_c - sum_o W_o Hpp^-1 b_p, and S = H_cc on the diagonal minus,
    for every point and every pair of its cameras (k, l),
    (W_k Hpp^-1)(W_l)^T. Each point's blocks are first summed into its
    camera slots, T1[p, k] = sum_{d: cam=k} W_d Hpp^-1 and T2 likewise with
    W, by one scatter-add each; the cross term is then one product over
    (point, 3) pairs."""
    P, D = obs_cam.shape
    WG = W @ Hpp_inv[:, None]                     # (P,D,6,3)
    WHb = (WG @ b_p[:, None, :, None])[..., 0]    # (P,D,6)
    flat_cam = obs_cam.reshape(P * D).long()
    rhs = b_c - _segment_sum(WHb.reshape(P * D, 6), flat_cam, K)
    slot = (torch.arange(P, device=W.device)[:, None] * K + obs_cam.long()).reshape(P * D)
    T1 = _segment_sum(WG.reshape(P * D, 6, 3), slot, P * K).reshape(P, K, 6, 3)
    T2 = _segment_sum(W.reshape(P * D, 6, 3), slot, P * K).reshape(P, K, 6, 3)
    A1 = T1.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
    A2 = T2.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
    S = -(A1 @ A2.T).reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    k = torch.arange(K, device=W.device)
    S[k, k] += H_cc
    return S, rhs


def _solve_reduced(S, rhs, cam_fixed, H_cc_diag, lam, K: int):
    """Dense scaled-Cholesky solve of the reduced camera system. A factor
    that fails (not positive definite) gives a NaN step, which the LM test
    then rejects, as a failed `cho_factor` does in the JAX package."""
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    damp = lam * torch.clamp_min(H_cc_diag, 1e-6)[..., None, :] * eye6
    fixed = cam_fixed[:, None, None] * FIXED_PRIOR * eye6
    k = torch.arange(K, device=S.device)
    S = S.clone()
    S[k, k] += damp + fixed + 1e-6 * eye6
    S_dense = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    d = torch.sqrt(torch.clamp_min(torch.diagonal(S_dense), 1e-12))
    L, info = torch.linalg.cholesky_ex(S_dense / d[:, None] / d[None, :])
    dxc = torch.cholesky_solve((rhs.reshape(K * 6) / d)[:, None], L)[:, 0] / d
    dxc = torch.where(info == 0, dxc, torch.nan).reshape(K, 6)
    return torch.where(cam_fixed[:, None], 0.0, dxc)


def _backsubstitute(obs_cam, W, Hpp_inv, b_p, p_valid, dxc):
    """dp = Hpp_inv (b_p - sum_o W_o^T dxc_o)."""
    Wtdx = (W.transpose(-1, -2) @ dxc[obs_cam.long()][..., None])[..., 0].sum(1)  # (P,3)
    dp = (Hpp_inv @ (b_p - Wtdx)[..., None])[..., 0]
    return torch.where(p_valid[:, None], dp, 0.0)


def _schur_solve(prob: BAProblem, H_pp, b_p, H_cc, b_c, W, lam, K: int):
    """Form the reduced camera system and solve; back-substitute landmarks."""
    Hpp_inv = _point_blocks_inv(H_pp, prob.p_valid, lam)
    S, rhs = _reduced_system(prob.obs_cam, H_cc, b_c, W, Hpp_inv, b_p, K)
    H_cc_diag = torch.diagonal(H_cc, dim1=-2, dim2=-1)
    dxc = _solve_reduced(S, rhs, prob.cam_fixed, H_cc_diag, lam, K)
    dp = _backsubstitute(prob.obs_cam, W, Hpp_inv, b_p, prob.p_valid, dxc)
    return dxc, dp


def _cost(chi2, delta2, obs_valid, use_huber: bool):
    c = robust.huber_cost(chi2, delta2) if use_huber else chi2
    return torch.sum(torch.where(obs_valid, c, 0.0))


def _lm_iteration(cam, prob: BAProblem, R, t, p, lam, use_huber: bool):
    """One LM step, accepted only where it lowers the cost."""
    K = prob.cam_R.shape[0]
    r, Jc, Jp, w, chi2, row_mask, delta2 = _obs_terms(cam, prob, R, t, p, use_huber)
    cost0 = _cost(chi2, delta2, prob.obs_valid, use_huber)
    H_pp, b_p, H_cc, b_c, W = _assemble(prob, r, Jc, Jp, w, row_mask, K)
    dxc, dp = _schur_solve(prob, H_pp, b_p, H_cc, b_c, W, lam, K)
    dR, dt = lie.se3_exp(dxc)
    R_new, t_new = lie.se3_mul(dR, dt, R, t)
    p_new = p + dp
    chi2_new = _obs_terms(cam, prob, R_new, t_new, p_new, use_huber)[4]
    better = _cost(chi2_new, delta2, prob.obs_valid, use_huber) < cost0
    return (torch.where(better, R_new, R), torch.where(better, t_new, t),
            torch.where(better, p_new, p), torch.where(better, lam * 0.5, lam * 5.0))


def bundle_adjust_step(cam: cameras.Camera, prob: BAProblem, lam0: torch.Tensor,
                       iters: int = 2, use_huber: bool = True):
    """A bite of `iters` LM iterations with the damping threaded in and out,
    and no final classification. Returns (cam_R, cam_t, p, lam); chaining
    bites equals one `bundle_adjust` of the same total iterations."""
    R, t, p = prob.cam_R, prob.cam_t, prob.p
    lam = lam0.to(R.dtype)
    for _ in range(iters):
        R, t, p, lam = _lm_iteration(cam, prob, R, t, p, lam, use_huber)
    return R, t, p, lam


def classify_observations(cam: cameras.Camera, prob: BAProblem):
    """Final chi2 inlier classification (the post-BA outlier-erase pass,
    Optimizer.cc:2100-2160)."""
    chi2, delta2 = _obs_terms(cam, prob, prob.cam_R, prob.cam_t, prob.p, use_huber=False)[4::2]
    return prob.obs_valid & (chi2 <= delta2)


def bundle_adjust(cam: cameras.Camera, prob: BAProblem, iters: int = 10, use_huber: bool = True):
    """LM loop. Returns (cam_R, cam_t, points, obs_inlier_mask, final_cost)."""
    lam0 = torch.tensor(1e-4, dtype=prob.cam_R.dtype, device=prob.cam_R.device)
    R, t, p, _ = bundle_adjust_step(cam, prob, lam0, iters=iters, use_huber=use_huber)
    _, _, _, _, chi2, _, delta2 = _obs_terms(cam, prob, R, t, p, use_huber=False)
    inlier = prob.obs_valid & (chi2 <= delta2)
    return R, t, p, inlier, _cost(chi2, delta2, prob.obs_valid, False)


def _chunk_schur(prob_c, r, Jc, Jp, w, row_mask, lam, K: int):
    """One point chunk's share of the reduced camera system from its
    observation terms (residuals, camera and point Jacobians, weights):
    S (K,K,6,6), rhs (K,6), the diagonal of H_cc (K,6), and the chunk's W,
    Hpp^-1 and b_p for the back-substitution. The camera Jacobians may be
    any 6-wide pose perturbation (the visual-inertial BA passes the body
    frame's)."""
    P, D = prob_c.obs_cam.shape
    H_pp, b_p, H_cc, b_c, W = _assemble(prob_c, r, Jc, Jp, w, row_mask, K)
    Hpp_inv = _point_blocks_inv(H_pp, prob_c.p_valid, lam)
    oc = prob_c.obs_cam.long()
    WHinv = W @ Hpp_inv[:, None]                              # (P,D,6,3)
    WHb = (WHinv @ b_p[:, None, :, None])[..., 0]             # (P,D,6)
    rhs = b_c - _segment_sum(WHb.reshape(P * D, 6), oc.reshape(P * D), K)
    # S -= W_d Hpp^-1 W_e^T for every pair (d, e) of a point's observations
    S_pair = WHinv[:, :, None] @ W[:, None].transpose(-1, -2)  # (P,D,D,6,6)
    pair = (oc[:, :, None] * K + oc[:, None, :]).reshape(P * D * D)
    S = -_segment_sum(S_pair.reshape(P * D * D, 6, 6), pair, K * K).reshape(K, K, 6, 6)
    k = torch.arange(K, device=S.device)
    S[k, k] += H_cc
    return S, rhs, torch.diagonal(H_cc, dim1=-2, dim2=-1), W, Hpp_inv, b_p


def _camera_system_chunk(cam, prob_c: BAProblem, R, t, lam, K: int, use_huber: bool):
    """One point chunk's share of the reduced camera system: S (K,K,6,6),
    rhs (K,6), the diagonal of H_cc (K,6), the cost, and the chunk's W,
    Hpp^-1 and b_p for the back-substitution."""
    r, Jc, Jp, w, chi2, row_mask, delta2 = _obs_terms(cam, prob_c, R, t, prob_c.p, use_huber)
    cost = _cost(chi2, delta2, prob_c.obs_valid, use_huber)
    S, rhs, diag, W, Hpp_inv, b_p = _chunk_schur(prob_c, r, Jc, Jp, w, row_mask, lam, K)
    return S, rhs, diag, cost, W, Hpp_inv, b_p


def point_chunks(prob, p, point_chunk: int):
    """The problem's point chunks of `point_chunk` rows, each with the
    positions `p` in place of prob.p (observation tables and validity
    sliced alike)."""
    for c0 in range(0, prob.obs_cam.shape[0], point_chunk):
        sl = slice(c0, c0 + point_chunk)
        yield prob._replace(p=p[sl], p_valid=prob.p_valid[sl], obs_cam=prob.obs_cam[sl],
                            obs_uv=prob.obs_uv[sl], obs_ur=prob.obs_ur[sl],
                            obs_level=prob.obs_level[sl], obs_valid=prob.obs_valid[sl],
                            obs_rig=None if prob.obs_rig is None else prob.obs_rig[sl])


def bundle_adjust_resumable(cam: cameras.Camera, prob: BAProblem, lam0: torch.Tensor,
                            iters: int = 2, use_huber: bool = True, point_chunk: int = 2048):
    """A bite of `iters` LM iterations on a whole-map problem. Returns
    (cam_R, cam_t, p, lam) so that the host can chain bites and stop
    between them (mbStopGBA, LoopClosing.cc:3067). P must be a multiple of
    point_chunk (pad with invalid points)."""
    K = prob.cam_R.shape[0]
    dt = prob.p.dtype
    R, t, p, lam = prob.cam_R, prob.cam_t, prob.p, lam0.to(dt)
    for _ in range(iters):
        S = torch.zeros((K, K, 6, 6), dtype=dt, device=p.device)
        rhs = torch.zeros((K, 6), dtype=dt, device=p.device)
        diag = torch.zeros((K, 6), dtype=dt, device=p.device)
        cost0 = torch.zeros((), dtype=dt, device=p.device)
        Ws, Hinvs, b_ps = [], [], []
        for prob_c in point_chunks(prob, p, point_chunk):
            S_c, rhs_c, diag_c, cost_c, W, Hpp_inv, b_p = _camera_system_chunk(
                cam, prob_c, R, t, lam, K, use_huber)
            S, rhs, diag, cost0 = S + S_c, rhs + rhs_c, diag + diag_c, cost0 + cost_c
            Ws.append(W)
            Hinvs.append(Hpp_inv)
            b_ps.append(b_p)
        dxc = _solve_reduced(S, rhs, prob.cam_fixed, diag, lam, K)
        dp = _backsubstitute(prob.obs_cam, torch.cat(Ws), torch.cat(Hinvs), torch.cat(b_ps),
                             prob.p_valid, dxc)
        R_new, t_new = lie.se3_mul(*lie.se3_exp(dxc), R, t)
        p_new = p + dp
        chi2_new, delta2 = _obs_terms(cam, prob, R_new, t_new, p_new, use_huber)[4::2]
        better = _cost(chi2_new, delta2, prob.obs_valid, use_huber) < cost0
        R, t, p = (torch.where(better, R_new, R), torch.where(better, t_new, t),
                   torch.where(better, p_new, p))
        lam = torch.where(better, lam * 0.5, lam * 5.0)
    return R, t, p, lam
