"""Inertial-only optimizations and visual-inertial pose tracking.

Port of `orb_slam3_comments_ghr_tpu/optim/inertial.py`:

  inertial_init         : Optimizer::InertialOptimization (Optimizer.cc:3706),
                          gravity direction (2 dof), monocular scale, shared
                          gyro / acc bias, per-KF velocities; poses fixed
  scale_gravity_refine  : the scale + gravity overload (Optimizer.cc:4085)
  pose_inertial_optimize: PoseInertialOptimizationLastKeyFrame (Optimizer.cc:435)
                          with the marginalization-prior chain of ...LastFrame
                          (:1002, Marginalize :1663); without a prior, as the
                          tracker runs it, replayed from a CUDA graph on the
                          card (PoseInertialGraph)

Small dense Gauss-Newton / LM problems with forward-mode Jacobians
(`torch.func.jacfwd`, where the JAX package uses `jax.jacfwd`). Every
accept/reject stays on the device (`torch.where`), and the factorizations use
the `_ex` forms, which do not stop to check their result on the host. The
one host sync left is `pose_inertial_optimize`'s eigendecomposition of the
prior, taken once per call that has a prior: the JAX package recomputes it
inside every residual evaluation, but the prior does not depend on the
increment.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..ops import cameras, lie
from ..utils.device import GraphCache, forward_ad_locked
from . import imu as imu_mod
from . import robust


class InertialWindow(NamedTuple):
    """K keyframes with stacked preintegrations between consecutive pairs.

    Rwb: (K,3,3) body-in-world rotations; pwb: (K,3) positions (fixed)
    vel0: (K,3) initial velocity estimates
    pre: Preintegrated with leading dim (K-1,) on every field
    valid: (K-1,) mask of the consecutive-pair factors
    """

    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel0: torch.Tensor
    pre: imu_mod.Preintegrated
    valid: torch.Tensor


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _info_sqrt(pre: imu_mod.Preintegrated) -> torch.Tensor:
    """(..., 9, 9) upper square roots L^T of the information matrices."""
    info = imu_mod.information(pre)
    eye = torch.eye(9, dtype=info.dtype, device=info.device)
    return torch.linalg.cholesky_ex(info + 1e-8 * eye)[0].transpose(-1, -2)


def gravity_seed(win: InertialWindow) -> torch.Tensor:
    """The rotation taking (0,0,-1) onto dirG = -sum_i Rwb_i dV_i, the
    gravity direction the preintegrated velocities imply
    (LocalMapping.cc:1604-1656)."""
    dirG = -torch.sum(_mv(win.Rwb[:-1], win.pre.dV) * win.valid[:, None], dim=0)
    dirG = dirG / torch.clamp_min(torch.linalg.norm(dirG), 1e-9)
    gI = imu_mod._pair(0.0, -1.0, 2, dirG)[:3]
    v = torch.linalg.cross(gI, dirG)
    s = torch.linalg.norm(v)
    ang = torch.atan2(s, torch.dot(gI, dirG))
    axis = v / torch.clamp_min(s, 1e-9)
    return lie.so3_exp(torch.where(s < 1e-6, torch.zeros_like(axis), axis * ang))


def _pair_residuals(win: InertialWindow, vel, bias, Rwg, s, info_sqrt):
    """Whitened residuals of the K-1 consecutive-pair factors, (K-1, 9)."""
    r = imu_mod.inertial_residual(win.Rwb[:-1], win.pwb[:-1], vel[:-1], win.Rwb[1:], win.pwb[1:],
                                  vel[1:], bias, win.pre, Rwg=Rwg, scale=s)
    return _mv(info_sqrt, r) * win.valid[:, None]


def _jac_and_value(f):
    """x -> (df/dx, f(x)) in one forward-mode pass: the value is the primal
    the Jacobian's pass computes anyway (the JAX package evaluates f again,
    and XLA merges the two)."""
    def both(x):
        r = f(x)
        return r, r

    return forward_ad_locked(jacfwd(both, has_aux=True))


def _solve(H, b, damp):
    """(H + damp) dx = -b without a host check (solve_ex)."""
    return torch.linalg.solve_ex(H + damp, -b)[0]


def inertial_init(win: InertialWindow, prior_g: float, prior_a: float,
                  optimize_scale: bool = True):
    """Returns (Rwg (3,3), scale (), bias (6,), vel (K,3), final cost).

    x = [phi_xy (2) gravity, log_s (1), bg (3), ba (3), vel (3K)]; the
    gravity rotation is seeded from the preintegrated velocity deltas, so
    large tilts converge. 30 LM steps."""
    K = win.Rwb.shape[0]
    dev, dt = win.Rwb.device, win.Rwb.dtype
    Rwg0 = gravity_seed(win)
    info_sqrt = _info_sqrt(win.pre)
    zero1 = torch.zeros(1, dtype=dt, device=dev)
    prior_w = imu_mod._pair(prior_g ** 0.5, prior_a ** 0.5, 3, win.pwb)

    def unpack(x):
        Rwg = Rwg0 @ lie.so3_exp(torch.cat([x[:2], zero1]))
        s = torch.exp(x[2]) if optimize_scale else torch.ones((), dtype=dt, device=dev)
        return Rwg, s, x[3:9], x[9:].reshape(K, 3)

    def residuals(x):
        Rwg, s, bias, vel = unpack(x)
        r_pairs = _pair_residuals(win, vel, bias, Rwg, s, info_sqrt).reshape(-1)
        return torch.cat([r_pairs, prior_w * bias])

    x = torch.cat([torch.zeros(9, dtype=dt, device=dev), win.vel0.reshape(-1)])
    lam = torch.full((), 1e-2, dtype=dt, device=dev)
    eye = torch.eye(x.shape[0], dtype=dt, device=dev)
    for _ in range(30):
        J, r = _jac_and_value(residuals)(x)
        H = J.T @ J
        x_new = x + _solve(H, J.T @ r, lam * torch.diag(torch.diag(H)) + 1e-9 * eye)
        better = torch.sum(residuals(x_new) ** 2) < torch.sum(r ** 2)
        x = torch.where(better, x_new, x)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    Rwg, s, bias, vel = unpack(x)
    return Rwg, s, bias, vel, torch.sum(residuals(x) ** 2)


def scale_gravity_refine(win: InertialWindow, bias: torch.Tensor):
    """Scale and gravity direction only (Optimizer.cc:4085), 20 Gauss-Newton
    steps: bias and velocities held. Returns (Rwg, scale)."""
    dev, dt = win.Rwb.device, win.Rwb.dtype
    info_sqrt = _info_sqrt(win.pre)
    zero1 = torch.zeros(1, dtype=dt, device=dev)

    def residuals(x):
        Rwg = lie.so3_exp(torch.cat([x[:2], zero1]))
        return _pair_residuals(win, win.vel0, bias, Rwg, torch.exp(x[2]), info_sqrt).reshape(-1)

    x = torch.zeros(3, dtype=dt, device=dev)
    eye = torch.eye(3, dtype=dt, device=dev)
    for _ in range(20):
        J, r = _jac_and_value(residuals)(x)
        x = x + _solve(J.T @ J, J.T @ r, 1e-6 * eye)
    return lie.so3_exp(torch.cat([x[:2], zero1])), torch.exp(x[2])


class VIState(NamedTuple):
    """Body state for VI tracking: Rwb, pwb, vel, bias[6]."""

    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor


class VIPrior(NamedTuple):
    """Marginalization prior from the previous frame (ConstraintPoseImu,
    G2oTypes.h:820): mean state and 15x15 information."""

    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    H: torch.Tensor
    valid: torch.Tensor  # () bool


def empty_prior(device="cuda") -> VIPrior:
    """No prior (valid False): the first frame after a keyframe or reset."""
    z = dict(dtype=torch.float32, device=device)
    return VIPrior(Rwb=torch.eye(3, **z), pwb=torch.zeros(3, **z), vel=torch.zeros(3, **z),
                   bias=torch.zeros(6, **z), H=torch.zeros((15, 15), **z),
                   valid=torch.zeros((), dtype=torch.bool, device=device))


def pose_inertial_optimize(cam: cameras.Camera, state0: VIState, prev: VIState,
                           pre: imu_mod.Preintegrated, obs, Tcb: tuple, prior: VIPrior | None):
    """Optimize the current frame's 15-dof state against the reprojections
    `obs` (a pose_opt.PoseObs), the preintegration from `prev` (fixed), the
    bias random walk and the prior: 2 rounds of 5 LM steps, the inliers
    re-classified between them. Returns (state, inliers, n_inliers,
    next_prior). With `prior` None there is no prior factor and no next
    prior (None): PoseInertialOptimizationLastKeyFrame, as the tracker runs
    it."""
    Rcb, tcb = Tcb
    dev, dt = state0.pwb.device, state0.pwb.dtype
    eye = lambda n: torch.eye(n, dtype=dt, device=dev)
    info9_sqrt = torch.linalg.cholesky_ex(imu_mod.information(pre) + 1e-8 * eye(9))[0].T
    info_level = robust.inv_level_sigma2(obs.level)
    # bias random-walk information (EdgeGyroRW / EdgeAccRW) from the walk
    # covariance accumulated over the preintegration window
    walk_info = torch.linalg.inv_ex(pre.C[9:15, 9:15] + 1e-9 * eye(6))[0]
    walk_sqrt = torch.linalg.cholesky_ex(walk_info + 1e-9 * eye(6))[0].T
    if prior is not None:
        # square root of the prior by eigen-clipping (H may be only PSD). A
        # prior with a NaN gives a NaN root, as in the JAX package (whose eigh
        # returns NaN where torch's raises)
        Hp = torch.where(prior.valid, prior.H, torch.zeros_like(prior.H))
        finite = torch.isfinite(Hp).all()
        evals, evecs = torch.linalg.eigh(torch.where(finite, Hp, 0.0) + 1e-9 * eye(15))
        prior_sqrt = torch.where(finite, (evecs * torch.sqrt(torch.clamp_min(evals, 0.0))) @ evecs.T,
                                 torch.nan)
    is_stereo = obs.u_right >= 0
    delta2 = torch.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def unpack(x):
        return VIState(state0.Rwb @ lie.so3_exp(x[:3]), state0.pwb + x[3:6],
                       state0.vel + x[6:9], state0.bias + x[9:15])

    def vis_residuals(st: VIState):
        # camera from body: Tcw = Tcb * Twb^-1
        Rcw = Rcb @ st.Rwb.T
        tcw = tcb - Rcw @ st.pwb
        pc = obs.p_world @ Rcw.T + tcw
        z = torch.clamp_min(pc[..., 2], 1e-6)
        uv_hat = cameras.project(cam, pc)
        ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)
        r_ur = torch.where(is_stereo, obs.u_right - ur_hat, 0.0)
        r = torch.cat([obs.uv - uv_hat, r_ur[..., None]], -1)  # (N,3)
        return r, torch.sum(r * r, -1) * info_level

    def full_residuals(x, inlier):
        st = unpack(x)
        r_vis, chi2 = vis_residuals(st)
        w = torch.where(inlier, robust.huber_weight(chi2, delta2) * info_level, 0.0)
        # a row of weight 0 adds exactly 0 to the residual and the Jacobian:
        # sqrt is taken only where w > 0, since its forward derivative at 0 is
        # NaN, which would make every step NaN (the JAX package keeps that
        # fault, ROADMAP C1)
        sqrt_w = torch.where(w > 0, torch.sqrt(torch.clamp_min(w, torch.finfo(dt).tiny)), 0.0)
        r_imu = imu_mod.inertial_residual(prev.Rwb, prev.pwb, prev.vel, st.Rwb, st.pwb,
                                          st.vel, prev.bias, pre)
        rs = [(r_vis * sqrt_w[:, None]).reshape(-1), info9_sqrt @ r_imu,
              walk_sqrt @ (st.bias - prev.bias)]
        if prior is not None:
            rs.append(prior_sqrt @ torch.cat([lie.so3_log(prior.Rwb.T @ st.Rwb), st.pwb - prior.pwb,
                                              st.vel - prior.vel, st.bias - prior.bias]))
        return torch.cat(rs)

    inlier = obs.valid
    x = torch.zeros(15, dtype=dt, device=dev)
    for _ in range(2):
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        f = lambda xx: full_residuals(xx, inlier)
        for _ in range(5):
            J, r = _jac_and_value(f)(x)
            H = J.T @ J
            x_new = x + _solve(H, J.T @ r, lam * torch.diag(torch.diag(H)) + 1e-9 * eye(15))
            better = torch.sum(f(x_new) ** 2) < torch.sum(r ** 2)
            x = torch.where(better, x_new, x)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
        _, chi2 = vis_residuals(unpack(x))
        inlier = obs.valid & (chi2 <= delta2)

    st = unpack(x)
    if prior is None:
        return st, inlier, inlier.sum(), None
    # the next frame's prior: J^T J of all factors at the solution
    J = forward_ad_locked(jacfwd(lambda xx: full_residuals(xx, inlier)))(x)
    next_prior = VIPrior(Rwb=st.Rwb, pwb=st.pwb, vel=st.vel, bias=st.bias, H=J.T @ J,
                         valid=torch.ones((), dtype=torch.bool, device=dev))
    return st, inlier, inlier.sum(), next_prior


class PoseInertialGraph(GraphCache):
    """`pose_inertial_optimize` without a prior, as the tracker calls it on
    every IMU-ready frame, replayed from a CUDA graph. Its 10 LM steps of
    forward-mode Jacobians are ~11k small kernels whose launches bound the
    host (PERF.md section 5); a replay issues them at once. One graph per
    camera and input shapes (`GraphCache`). The raw IMU samples are not
    read by the optimization and vary in number, so they are left out. The
    outputs are the graph's own tensors, overwritten by the next call. On
    CPU tensors it is `pose_inertial_optimize` itself."""

    def __call__(self, cam: cameras.Camera, state0: VIState, prev: VIState,
                 pre: imu_mod.Preintegrated, obs, Tcb: tuple):
        pre = pre._replace(acc=pre.acc[:0], gyr=pre.gyr[:0], dts=pre.dts[:0])
        return super().__call__(lambda *a: pose_inertial_optimize(cam, *a, None), cam,
                                state0, prev, pre, obs, tuple(Tcb))
