"""Visual-inertial bundle adjustment over a keyframe window.

Port of the windowed path of `orb_slam3_comments_ghr_tpu/optim/vi_ba.py`
(Optimizer::LocalInertialBA, reference src/Optimizer.cc:2221, and the
FullInertialBA math of :3254 on a window): per keyframe a 15-dof body state
(pose 6, velocity 3, gyro and acc bias 6), the landmarks, reprojection
factors, preintegration factors between consecutive keyframes
(EdgeInertial), bias random-walk factors (EdgeGyroRW / EdgeAccRW) and Huber
weights.

The landmarks are Schur-eliminated with `optim/ba.py`'s pieces (the
reprojection factor touches only the 6 pose components, so that system
stays 6 wide); the inertial and walk factors are added to the 15-wide
reduced system, which one scaled dense Cholesky then solves. Each LM step
is accepted or rejected on the device.

The whole-map FullInertialBA (`vi_bundle_adjust_chunked`, the inertial GBA
after a loop closure) runs the same LM in bites with the visual Schur system
assembled one point chunk at a time (`optim/ba.py`'s `_chunk_schur`, fed the
body-frame Jacobians), so memory stays flat as the map grows and no landmark
is left out. A fisheye rig's right-camera observations chain through the
rig offset after the body -> camera-0 transform, as in `optim/ba.py`.

After a solve, `classify_observations` gives the visual rows that pass the
chi2 gate at the solved state (chunk by chunk on the whole-map path), so
that the mapper can erase the rest, as the reference's LocalInertialBA /
FullInertialBA do and the JAX package does not (ROADMAP C10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops import cameras, lie
from ..utils.device import forward_ad_locked
from . import ba, robust
from . import imu as imu_mod

CDIM = 15  # per-keyframe block: [phi(3), dp(3), dv(3), dbg(3), dba(3)]


class VIBAProblem(NamedTuple):
    """K body states, P landmarks, D observations per landmark, K-1
    inertial factors.

    Rwb/pwb/vel/bias: (K,...) body states (world frame)
    fixed: (K,) bool: the pose of these states is held
    Rcb/tcb: body->cam extrinsics (camera = Tcb * body)
    p, p_valid, obs_*: landmark and observation tables as in ba.BAProblem
                       (obs_cam indexes the K body states)
    pre: stacked Preintegrated (leading dim K-1) between consecutive states
    pre_valid: (K-1,) bool
    obs_rig/rig_R/rig_t: the second-camera rig slots of ba.BAProblem (the
                       offset applied after the body -> camera-0 chain), or
                       None
    """

    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    fixed: torch.Tensor
    Rcb: torch.Tensor
    tcb: torch.Tensor
    p: torch.Tensor
    p_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_level: torch.Tensor
    obs_valid: torch.Tensor
    pre: imu_mod.Preintegrated
    pre_valid: torch.Tensor
    obs_rig: torch.Tensor | None = None
    rig_R: torch.Tensor | None = None
    rig_t: torch.Tensor | None = None


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _camera_from_body(prob: VIBAProblem, Rwb, pwb):
    """Tcw per state: Rcw = Rcb Rbw, tcw = tcb - Rcw pwb."""
    Rcw = prob.Rcb @ Rwb.transpose(-1, -2)
    return Rcw, prob.tcb - _mv(Rcw, pwb)


def _vis_terms(cam, prob: VIBAProblem, Rwb, pwb, p, use_huber: bool):
    """Reprojection residuals and Jacobians with respect to the body's right
    perturbation [phi, dp] and the landmark: ba._obs_terms with the body
    chain rule, q = Rbw (x - pwb); dq/dphi = hat(q), dq/ddp = -Rbw,
    dq/dx = Rbw; a rig observation chains through its offset A (dpc =
    A dpc0)."""
    oc = prob.obs_cam.long()
    Rcw, tcw = _camera_from_body(prob, Rwb, pwb)
    Ro = Rcw[oc]                                       # (P,D,3,3)
    Rbw_o = Rwb.transpose(-1, -2)[oc]
    A_rig, pc = ba._rig_chain(prob, _mv(Ro, p[:, None, :]) + tcw[oc])
    z = torch.clamp_min(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)
    is_stereo = prob.obs_ur >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)
    r_uv = prob.obs_uv - uv_hat
    r_ur = torch.where(is_stereo, prob.obs_ur - ur_hat, 0.0)
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)
    row_mask = torch.cat([prob.obs_valid[..., None].expand(r_uv.shape),
                          (prob.obs_valid & is_stereo)[..., None]], dim=-1)
    J_proj = cameras.project_jac(cam, pc)
    zero = torch.zeros_like(z)
    d_ur_dpc = J_proj[..., 0, :] + torch.stack([zero, zero, cam.bf / (z * z)], dim=-1)
    dh_dpc = torch.cat([J_proj, d_ur_dpc[..., None, :]], dim=-2)  # (P,D,3,3)

    q = _mv(Rbw_o, p[:, None, :] - pwb[oc])
    A = prob.Rcb @ lie.hat(q)                          # dpc/dphi
    B = -(prob.Rcb @ Rbw_o)                            # dpc/ddp
    if A_rig is not None:
        A, B = A_rig @ A, A_rig @ B
    Jpose = -torch.cat([dh_dpc @ A, dh_dpc @ B], dim=-1)  # (P,D,3,6)
    Jp = dh_dpc @ B                                    # = -dh_dpc Rcb Rbw

    info = robust.inv_level_sigma2(prob.obs_level)
    chi2 = torch.sum(torch.where(row_mask, r * r, 0.0), dim=-1) * info
    delta2 = torch.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    w = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = torch.where(prob.obs_valid, w * info, 0.0)
    return r, Jpose, Jp, w, chi2, row_mask, delta2


def _factor_residual(xi, xj, Ri, pi, vi, bi, Rj, pj, vj, pre):
    """The preintegration residual between two states perturbed by xi, xj
    (right perturbation of the rotation, additive elsewhere)."""
    return imu_mod.inertial_residual(Ri @ lie.so3_exp(xi[..., :3]), pi + xi[..., 3:6],
                                     vi + xi[..., 6:9], Rj @ lie.so3_exp(xj[..., :3]),
                                     pj + xj[..., 3:6], vj + xj[..., 6:9], bi + xi[..., 9:15], pre)


def _inertial_terms(prob: VIBAProblem, Rwb, pwb, vel, bias, jacobians: bool = True):
    """Whitened 9-dim residuals of the consecutive-pair factors, (F,9), and
    with `jacobians` their Jacobians with respect to both 15-dim states,
    Ji and Jj (F,9,15)."""
    F = Rwb.shape[0] - 1
    z = torch.zeros((F, CDIM), dtype=Rwb.dtype, device=Rwb.device)
    args = (Rwb[:-1], pwb[:-1], vel[:-1], bias[:-1], Rwb[1:], pwb[1:], vel[1:], prob.pre)
    eye9 = torch.eye(9, dtype=Rwb.dtype, device=Rwb.device)
    Lt = torch.linalg.cholesky_ex(imu_mod.information(prob.pre) + 1e-8 * eye9)[0].transpose(-1, -2)
    m = prob.pre_valid.to(Rwb.dtype)
    r = _mv(Lt, _factor_residual(z, z, *args)) * m[:, None]
    if not jacobians:
        return r
    Ji, Jj = forward_ad_locked(vmap(jacfwd(_factor_residual, argnums=(0, 1))))(z, z, *args)
    return r, (Lt @ Ji) * m[:, None, None], (Lt @ Jj) * m[:, None, None]


def _walk_terms(prob: VIBAProblem, bias):
    """Bias random-walk factors between consecutive states: whitened
    residuals (F,6) and the square roots L^T (F,6,6)."""
    eye6 = torch.eye(6, dtype=bias.dtype, device=bias.device)
    info = torch.linalg.inv_ex(prob.pre.C[:, 9:15, 9:15] + 1e-9 * eye6)[0]
    Lt = torch.linalg.cholesky_ex(info + 1e-9 * eye6)[0].transpose(-1, -2)
    m = prob.pre_valid.to(bias.dtype)
    return _mv(Lt, bias[1:] - bias[:-1]) * m[:, None], Lt * m[:, None, None]


def _total_cost(cam, prob, Rwb, pwb, vel, bias, p, use_huber: bool):
    chi2, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, use_huber)[4::2]
    c_vis = ba._cost(chi2, delta2, prob.obs_valid, use_huber)
    r_imu = _inertial_terms(prob, Rwb, pwb, vel, bias, jacobians=False)
    r_walk = _walk_terms(prob, bias)[0]
    return c_vis + torch.sum(r_imu ** 2) + torch.sum(r_walk ** 2)


def _add_pair_blocks(S, rhs, Ji, Jj, r):
    """Add the factors (Ji, Jj, r) between states f and f+1 to the normal
    equations S (K,K,15,15), rhs (K,15)."""
    F = Ji.shape[0]
    i = torch.arange(F, device=S.device)
    j = i + 1
    Jit, Jjt = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    S[i, i] += Jit @ Ji
    S[j, j] += Jjt @ Jj
    S[i, j] += Jit @ Jj
    S[j, i] += Jjt @ Ji
    rhs[i] -= _mv(Jit, r)
    rhs[j] -= _mv(Jjt, r)


def _solve_body_system(prob: VIBAProblem, inertial, walk, S6, rhs6, lam):
    """Embed the visual reduced system (6 wide) into the 15-wide body
    system, add the inertial and bias-walk factors, damp and solve. Returns
    the (K,15) update, with the pose update of fixed states zeroed. A factor
    that fails gives a NaN step, which the LM test rejects. `inertial` and
    `walk` are what _inertial_terms and _walk_terms give."""
    K = S6.shape[0]
    dev, dt = S6.device, S6.dtype
    S = torch.zeros((K, K, CDIM, CDIM), dtype=dt, device=dev)
    S[:, :, :6, :6] = S6
    rhs = torch.zeros((K, CDIM), dtype=dt, device=dev)
    rhs[:, :6] = rhs6

    ri, Ji, Jj = inertial
    _add_pair_blocks(S, rhs, Ji, Jj, ri)
    # the bias random walk acts on components 9:15 of both states
    rw, Lts = walk
    Jw = torch.zeros((K - 1, 6, CDIM), dtype=dt, device=dev)
    Jw[:, :, 9:15] = Lts
    _add_pair_blocks(S, rhs, -Jw, Jw, rw)

    # damping and fixed priors: `fixed` pins only the pose components, the
    # velocity and biases of a fixed keyframe stay free (FullInertialBA
    # fixes VertexPose but not VertexVelocity, Optimizer.cc:3284-3320)
    k = torch.arange(K, device=dev)
    eye15 = torch.eye(CDIM, dtype=dt, device=dev)
    diag = torch.clamp_min(torch.diagonal(S[k, k], dim1=-2, dim2=-1), 1e-6)
    pose_mask = torch.arange(CDIM, device=dev) < 6
    fixed = prob.fixed[:, None, None] * ba.FIXED_PRIOR * torch.diag(pose_mask.to(dt))
    S[k, k] += lam * diag[..., None, :] * eye15 + fixed + 1e-5 * eye15

    Sd = S.permute(0, 2, 1, 3).reshape(K * CDIM, K * CDIM)
    d = torch.sqrt(torch.clamp_min(torch.diagonal(Sd), 1e-12))
    L, info = torch.linalg.cholesky_ex(Sd / d[:, None] / d[None, :])
    dx = torch.cholesky_solve((rhs.reshape(K * CDIM) / d)[:, None], L)[:, 0] / d
    dx = torch.where(info == 0, dx, torch.nan).reshape(K, CDIM)
    return torch.where(prob.fixed[:, None] & pose_mask[None, :], 0.0, dx)


def _lm_accept(cam, prob: VIBAProblem, state, dx, dp_pts, cost0, lam):
    """The LM test on the device: the states (Rwb, pwb, vel, bias, p) moved
    by the step (dx, dp_pts) where that lowers the total cost below cost0,
    and the damping halved there, else multiplied by 5."""
    Rwb, pwb, vel, bias, p = state
    Rwb_n = Rwb @ lie.so3_exp(dx[:, :3])
    pwb_n, vel_n, bias_n = pwb + dx[:, 3:6], vel + dx[:, 6:9], bias + dx[:, 9:15]
    p_n = p + dp_pts
    better = _total_cost(cam, prob, Rwb_n, pwb_n, vel_n, bias_n, p_n, True) < cost0
    return (torch.where(better, Rwb_n, Rwb), torch.where(better, pwb_n, pwb),
            torch.where(better, vel_n, vel), torch.where(better, bias_n, bias),
            torch.where(better, p_n, p), torch.where(better, lam * 0.5, lam * 5.0))


def _vi_ba_loop(cam, prob: VIBAProblem, lam, iters: int):
    K = prob.Rwb.shape[0]
    Rwb, pwb, vel, bias, p = prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p
    lam = lam.to(pwb.dtype)
    for _ in range(iters):
        r, Jpose, Jp, w, chi2, row_mask, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, True)
        inertial = _inertial_terms(prob, Rwb, pwb, vel, bias)
        walk = _walk_terms(prob, bias)
        cost0 = (ba._cost(chi2, delta2, prob.obs_valid, True)
                 + torch.sum(inertial[0] ** 2) + torch.sum(walk[0] ** 2))
        # the visual blocks (6 wide) and Schur pieces of optim.ba
        H_pp, b_p, H_cc6, b_c6, W = ba._assemble(prob, r, Jpose, Jp, w, row_mask, K)
        Hpp_inv = ba._point_blocks_inv(H_pp, prob.p_valid, lam)
        S6, rhs6 = ba._reduced_system(prob.obs_cam, H_cc6, b_c6, W, Hpp_inv, b_p, K)
        dx = _solve_body_system(prob, inertial, walk, S6, rhs6, lam)
        dp_pts = ba._backsubstitute(prob.obs_cam, W, Hpp_inv, b_p, prob.p_valid, dx[:, :6])
        Rwb, pwb, vel, bias, p, lam = _lm_accept(cam, prob, (Rwb, pwb, vel, bias, p), dx,
                                                 dp_pts, cost0, lam)
    return Rwb, pwb, vel, bias, p, lam


def vi_bundle_adjust_step(cam: cameras.Camera, prob: VIBAProblem, lam0: torch.Tensor,
                          iters: int = 2):
    """A bite of `iters` VI-LM iterations with the damping threaded in and
    out, and no final classification; chained bites equal one
    `vi_bundle_adjust` of the same total. Returns (Rwb, pwb, vel, bias, p,
    lam)."""
    return _vi_ba_loop(cam, prob, lam0, iters)


def vi_bundle_adjust(cam: cameras.Camera, prob: VIBAProblem, iters: int = 10):
    """LM over (body states, landmarks), Huber-weighted. Returns (Rwb, pwb,
    vel, bias, p, obs_inlier, cost)."""
    lam0 = torch.full((), 1e-4, dtype=prob.pwb.dtype, device=prob.pwb.device)
    Rwb, pwb, vel, bias, p, _ = _vi_ba_loop(cam, prob, lam0, iters)
    chi2, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, False)[4::2]
    inlier = prob.obs_valid & (chi2 <= delta2)
    return Rwb, pwb, vel, bias, p, inlier, _total_cost(cam, prob, Rwb, pwb, vel, bias, p, False)


def classify_observations(cam: cameras.Camera, prob: VIBAProblem, Rwb, pwb, p,
                          point_chunk: int | None = None):
    """(P,D) bool: the valid visual rows whose chi2 at the state (Rwb, pwb,
    p) passes the gate (chi2 <= 5.991 mono, 7.815 stereo), as
    `vi_bundle_adjust` classifies them; with `point_chunk`, chunk by chunk
    (`ba.point_chunks`), so that no whole-map Jacobian table is built."""
    if point_chunk is None:
        chi2, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, False)[4::2]
        return prob.obs_valid & (chi2 <= delta2)
    return torch.cat([classify_observations(cam, prob_c, Rwb, pwb, prob_c.p)
                      for prob_c in ba.point_chunks(prob, p, point_chunk)])


def _vi_vis_chunk(cam, prob_c: VIBAProblem, Rwb, pwb, lam, K: int):
    """One point chunk's share of the 6-wide reduced body system: S
    (K,K,6,6), rhs (K,6), the chunk's robust visual cost, and its W, Hpp^-1
    and b_p for the back-substitution."""
    r, Jpose, Jp, w, chi2, row_mask, delta2 = _vis_terms(cam, prob_c, Rwb, pwb, prob_c.p, True)
    cost = ba._cost(chi2, delta2, prob_c.obs_valid, True)
    S, rhs, _, W, Hpp_inv, b_p = ba._chunk_schur(prob_c, r, Jpose, Jp, w, row_mask, lam, K)
    return S, rhs, cost, W, Hpp_inv, b_p


def vi_bundle_adjust_chunked(cam: cameras.Camera, prob: VIBAProblem, lam0: torch.Tensor,
                             iters: int = 2, point_chunk: int = 2048):
    """A bite of `iters` whole-map VI-LM iterations with the damping
    threaded in and out, the visual Schur system summed over point chunks.
    P must be a multiple of point_chunk (pad with invalid points). Returns
    (Rwb, pwb, vel, bias, p, lam), so that the host can chain bites and
    stop between them (mbStopGBA, LoopClosing.cc:3067)."""
    K = prob.Rwb.shape[0]
    dev, dt = prob.pwb.device, prob.pwb.dtype
    Rwb, pwb, vel, bias, p = prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p
    lam = lam0.to(dt)
    for _ in range(iters):
        S6 = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
        rhs6 = torch.zeros((K, 6), dtype=dt, device=dev)
        cost0 = torch.zeros((), dtype=dt, device=dev)
        Ws, Hinvs, b_ps = [], [], []
        for prob_c in ba.point_chunks(prob, p, point_chunk):
            S_c, rhs_c, cost_c, W, Hpp_inv, b_p = _vi_vis_chunk(cam, prob_c, Rwb, pwb, lam, K)
            S6, rhs6, cost0 = S6 + S_c, rhs6 + rhs_c, cost0 + cost_c
            Ws.append(W)
            Hinvs.append(Hpp_inv)
            b_ps.append(b_p)
        inertial = _inertial_terms(prob, Rwb, pwb, vel, bias)
        walk = _walk_terms(prob, bias)
        cost0 = cost0 + torch.sum(inertial[0] ** 2) + torch.sum(walk[0] ** 2)
        dx = _solve_body_system(prob, inertial, walk, S6, rhs6, lam)
        dp_pts = ba._backsubstitute(prob.obs_cam, torch.cat(Ws), torch.cat(Hinvs),
                                    torch.cat(b_ps), prob.p_valid, dx[:, :6])
        Rwb, pwb, vel, bias, p, lam = _lm_accept(cam, prob, (Rwb, pwb, vel, bias, p), dx,
                                                 dp_pts, cost0, lam)
    return Rwb, pwb, vel, bias, p, lam
