"""IMU preintegration and state prediction.

Port of `orb_slam3_comments_ghr_tpu/optim/imu.py` (IMU::Preintegrated,
reference src/ImuTypes.cc, IntegrateNewMeasurement at :246-328): the
per-sample forward integration with the 15x15 covariance propagation and the
bias Jacobians, reintegration with a new bias by running it again over the
raw samples the result carries.

The JAX package runs a `lax.scan` over a power-of-two padded chunk, where a
row with dt = 0 leaves the carry as it was. Here the loop runs over the rows
it is given, and the front end gives only the live ones. A row with dt = 0
is still an exact no-op (every increment is multiplied by dt, and the bias
walk is masked), so padded input gives the same result.

State layout as the reference: [dR(0:3), dV(3:6), dP(6:9), bg(9:12),
ba(12:15)]; gravity 9.81 (ImuTypes.h:44).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..utils.profiling import GLOBAL_TIMER

GRAVITY = 9.81


def _pair(a: float, b: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """(a,)*n + (b,)*n, made on like's device by fill kernels: a tensor built
    from a Python list, or an element set from a Python number, is copied
    from the host, and on a GPU that copy waits for the device."""
    out = torch.full((2 * n,), a, dtype=like.dtype, device=like.device)
    out[n:].fill_(b)
    return out


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -g) with the dtype and device of `like`."""
    return _pair(0.0, -GRAVITY, 2, like)[:3]


class ImuCalib(NamedTuple):
    """IMU noise model and extrinsics (IMU::Calib, ImuTypes.h:70).

    Rbc (3,3), tbc (3,): camera-to-body transform, host numpy or tensors.
    noise_g/a: continuous-time densities discretized by the caller as
    sigma*sqrt(freq); walk_g/a as sigma/sqrt(freq) (Tracking.cc:680-681)."""

    Rbc: object
    tbc: object
    noise_g: float
    noise_a: float
    walk_g: float
    walk_a: float


def default_calib() -> ImuCalib:
    # EuRoC ADIS16448: noise sigma*sqrt(rate), walk sigma/sqrt(rate)
    return ImuCalib(
        Rbc=np.eye(3, dtype=np.float32),
        tbc=np.zeros(3, np.float32),
        noise_g=1.7e-4 * (200.0 ** 0.5),
        noise_a=2.0e-3 * (200.0 ** 0.5),
        walk_g=1.9e-5 / (200.0 ** 0.5),
        walk_a=3.0e-3 / (200.0 ** 0.5),
    )


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement between two frames / keyframes.

    dT: () total time; dR (3,3); dV, dP (3,)
    C: (15,15) covariance [phi, v, p, bg, ba]
    J_rg, J_vg, J_va, J_pg, J_pa: (3,3) bias Jacobians
    bias: (6,) [bg, ba] used during integration
    acc, gyr (T,3), dts (T,): the raw samples integrated (for
    reintegration and merging); rows with dt = 0 are padding
    """

    dT: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    C: torch.Tensor
    J_rg: torch.Tensor
    J_vg: torch.Tensor
    J_va: torch.Tensor
    J_pg: torch.Tensor
    J_pa: torch.Tensor
    bias: torch.Tensor
    acc: torch.Tensor
    gyr: torch.Tensor
    dts: torch.Tensor


def _noise_diag(calib: ImuCalib, like: torch.Tensor):
    nga = _pair(calib.noise_g**2, calib.noise_a**2, 3, like)
    return nga, torch.diag(_pair(calib.walk_g**2, calib.walk_a**2, 3, like))


def _integrate(carry, acc, gyr, dts, bias, calib: ImuCalib) -> Preintegrated:
    """IntegrateNewMeasurement over each row of (acc, gyr, dts) from the
    state `carry` = (dR, dV, dP, C, J_rg, J_vg, J_va, J_pg, J_pa, dT)."""
    dR, dV, dP, C, J_rg, J_vg, J_va, J_pg, J_pa, dT = carry
    nga, walk = _noise_diag(calib, acc)
    eye3 = torch.eye(3, dtype=acc.dtype, device=acc.device)
    z3 = torch.zeros((3, 3), dtype=acc.dtype, device=acc.device)
    bg, ba = bias[:3], bias[3:]
    # dt <= 0 is padding: with dt = 0 every increment below vanishes
    # exactly; only the per-sample bias walk needs the mask
    dts_eff = torch.clamp_min(dts, 0.0)
    live = (dts > 0).to(acc.dtype)
    a_all, w_all = acc - ba, gyr - bg
    dRi_all = lie.so3_exp(w_all * dts_eff[:, None])
    rightJ_all = lie.so3_right_jacobian(w_all * dts_eff[:, None])
    Wacc_all = lie.hat(a_all)
    for i in range(acc.shape[0]):
        dt, a, Wacc, dRi, rightJ = dts_eff[i], a_all[i], Wacc_all[i], dRi_all[i], rightJ_all[i]
        dRdt = dR * dt
        dRdt2 = 0.5 * dRdt * dt
        Ra = dR @ a
        # position / velocity first, with the pre-update dR (ImuTypes.cc:275-277)
        dP = dP + dV * dt + 0.5 * Ra * dt * dt
        dV = dV + Ra * dt
        # bias Jacobians with the pre-update dR and J (ImuTypes.cc:292-296)
        RW = dRdt @ Wacc
        J_pa = J_pa + J_va * dt - dRdt2
        J_pg = J_pg + J_vg * dt - 0.5 * RW * dt @ J_rg
        J_va = J_va - dRdt
        J_vg = J_vg - RW @ J_rg
        # covariance of [phi, v, p] (A C A^T + B N B^T) and the bias walk,
        # which grows per sample with no dt factor (ImuTypes.cc:312)
        A = torch.cat([
            torch.cat([dRi.T, z3, z3], 1),
            torch.cat([-RW, eye3, z3], 1),
            torch.cat([-0.5 * RW * dt, eye3 * dt, eye3], 1),
        ], 0)
        B = torch.cat([
            torch.cat([rightJ * dt, z3], 1),
            torch.cat([z3, dRdt], 1),
            torch.cat([z3, dRdt2], 1),
        ], 0)
        C9 = A @ C[:9, :9] @ A.T + (B * nga) @ B.T
        C = torch.cat([torch.cat([C9, C[:9, 9:]], 1),
                       torch.cat([C[9:, :9], C[9:, 9:] + walk * live[i]], 1)], 0)
        J_rg = dRi.T @ J_rg - rightJ * dt
        dR = dR @ dRi
        dT = dT + dt
    return Preintegrated(
        dT=dT, dR=lie.normalize_rotation(dR), dV=dV, dP=dP, C=C,
        J_rg=J_rg, J_vg=J_vg, J_va=J_va, J_pg=J_pg, J_pa=J_pa,
        bias=bias, acc=acc, gyr=gyr, dts=dts,
    )


def preintegrate(acc: torch.Tensor, gyr: torch.Tensor, dts: torch.Tensor,
                 bias: torch.Tensor, calib: ImuCalib) -> Preintegrated:
    """acc / gyr: (T,3) samples; dts: (T,) per-sample dt (0 = padding);
    bias: (6,) [bg, ba]. Runs where the samples lie; an `imu_integration`
    span."""
    with GLOBAL_TIMER.stage("imu_integration"):
        z3 = torch.zeros(3, dtype=acc.dtype, device=acc.device)
        zm = torch.zeros((3, 3), dtype=acc.dtype, device=acc.device)
        init = (torch.eye(3, dtype=acc.dtype, device=acc.device), z3, z3,
                torch.zeros((15, 15), dtype=acc.dtype, device=acc.device),
                zm, zm, zm, zm, zm, torch.zeros((), dtype=acc.dtype, device=acc.device))
        return _integrate(init, acc, gyr, dts, bias, calib)


def preintegrate_continue(pre: Preintegrated, acc: torch.Tensor, gyr: torch.Tensor,
                          dts: torch.Tensor, calib: ImuCalib) -> Preintegrated:
    """Integrate a new sample chunk onto an existing preintegration (the
    per-frame accumulation of mpImuPreintegratedFromLastKF, Tracking.cc:1883),
    with pre.bias. The raw samples of the result hold only the new chunk. An
    `imu_integration` span."""
    with GLOBAL_TIMER.stage("imu_integration"):
        init = (pre.dR, pre.dV, pre.dP, pre.C, pre.J_rg, pre.J_vg, pre.J_va, pre.J_pg,
                pre.J_pa, pre.dT)
        return _integrate(init, acc, gyr, dts, pre.bias, calib)


def empty_preintegrated(capacity: int, device="cuda") -> Preintegrated:
    """The preintegration of no samples (a link that carries none), with
    `capacity` padding rows."""
    z = dict(dtype=torch.float32, device=device)
    zm = torch.zeros((3, 3), **z)
    return Preintegrated(
        dT=torch.zeros((), **z), dR=torch.eye(3, **z), dV=torch.zeros(3, **z),
        dP=torch.zeros(3, **z), C=torch.eye(15, **z) * 1e-9,
        J_rg=zm, J_vg=zm, J_va=zm, J_pg=zm, J_pa=zm, bias=torch.zeros(6, **z),
        acc=torch.zeros((capacity, 3), **z), gyr=torch.zeros((capacity, 3), **z),
        dts=torch.zeros((capacity,), **z),
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def delta_with_bias(pre: Preintegrated, new_bias: torch.Tensor):
    """First-order bias-corrected deltas (GetDeltaRotation / Velocity /
    Position, ImuTypes.h:189-204). Broadcasts over leading dims."""
    dbg = new_bias[..., :3] - pre.bias[..., :3]
    dba = new_bias[..., 3:] - pre.bias[..., 3:]
    dR = pre.dR @ lie.so3_exp(_mv(pre.J_rg, dbg))
    dV = pre.dV + _mv(pre.J_vg, dbg) + _mv(pre.J_va, dba)
    dP = pre.dP + _mv(pre.J_pg, dbg) + _mv(pre.J_pa, dba)
    return dR, dV, dP


def predict_state(Rwb, pwb, vwb, bias, pre: Preintegrated):
    """Dead-reckoning from a previous body state (Tracking::PredictStateIMU,
    Tracking.cc:1929)."""
    dR, dV, dP = delta_with_bias(pre, bias)
    t = pre.dT
    g = gravity_vec(Rwb)
    Rwb2 = lie.normalize_rotation(Rwb @ dR)
    vwb2 = vwb + g * t + _mv(Rwb, dV)
    pwb2 = pwb + vwb * t + 0.5 * g * t * t + _mv(Rwb, dP)
    return Rwb2, pwb2, vwb2


def inertial_residual(R1, p1, v1, R2, p2, v2, bias, pre: Preintegrated, Rwg=None, scale=None):
    """9-dim preintegration residual [er, ev, ep] (EdgeInertial::computeError,
    G2oTypes.cc; EdgeInertialGS with gravity direction Rwg and scale s for
    the initialization). Poses are body-in-world; broadcasts over leading
    dims (a batch of factors)."""
    dR, dV, dP = delta_with_bias(pre, bias)
    t = pre.dT[..., None]
    g = gravity_vec(R1)
    if Rwg is not None:
        g = _mv(Rwg, g)
    s = 1.0 if scale is None else scale
    R1t = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1t @ R2)
    ev = _mv(R1t, s * (v2 - v1) - g * t) - dV
    ep = _mv(R1t, s * (p2 - p1 - v1 * t) - 0.5 * g * t * t) - dP
    return torch.cat([er, ev, ep], dim=-1)


def information(pre: Preintegrated) -> torch.Tensor:
    """9x9 information of [er, ev, ep]: the inverse of the covariance's
    top-left block (EdgeInertial ctor). Broadcasts over leading dims."""
    C9 = pre.C[..., :9, :9]
    eye = torch.eye(9, dtype=C9.dtype, device=C9.device)
    return torch.linalg.inv_ex(0.5 * (C9 + C9.transpose(-1, -2)) + eye * 1e-9)[0]
