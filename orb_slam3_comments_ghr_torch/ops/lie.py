"""SO(3) / SE(3) / Sim(3) operations.

Port of `orb_slam3_comments_ghr_tpu/ops/lie.py`: the SO(3)/SE(3) and
quaternion part, the right Jacobians and the rotation re-projection that
IMU preintegration needs, and the Sim(3) group of loop closing.
Rotations are (...,3,3) matrices, translations (...,3) vectors, Sim(3)
scales (...,) tensors; every function broadcasts over leading batch dims.
The se3 tangent is ordered [rho (translation), phi (rotation)], as g2o's
SE3Quat; the sim3 tangent is [rho, phi, sigma] (sigma = log scale), as
g2o's Sim3.
"""

from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: v (...,3) -> skew-symmetric (...,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs_sq(t2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) from t2 = t^2,
    with the Taylor branch below t2 = 1e-8 (the sqrt runs on a clamped
    value so the branch not taken never produces NaN).

    Callers keep a trailing axis on t2 (keepdim): in torch 2.13 forward-mode
    AD (`torch.func.jacfwd`) gives a 0-dim tensor times a Python float a
    float64 tangent, which then breaks the first matmul."""
    small = t2 < 1e-8
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (safe_t - torch.sin(safe_t)) / safe_t**3)
    return A, B, C


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) tangent -> (...,3,3) rotation."""
    t2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs_sq(t2)
    K = hat(phi)
    return _eye_like(K) + A[..., None] * K + B[..., None] * (K @ K)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi): (...,3) -> (...,3,3)."""
    t2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    _, B, C = _sinc_coeffs_sq(t2)
    K = hat(phi)
    return _eye_like(K) + B[..., None] * K + C[..., None] * (K @ K)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_r(phi) = J_l(-phi) (IMU::RightJacobianSO3, ImuTypes.h:258)."""
    return so3_left_jacobian(-phi)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """J_r^{-1}(phi), closed form (IMU::InverseRightJacobianSO3)."""
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    t2 = theta * theta
    small = theta < 1e-4
    one = torch.ones_like(theta)
    safe_t = torch.where(small, one, theta)
    # 1/t^2 - (1 + cos t) / (2 t sin t)
    coef = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / (safe_t * safe_t)
        - (1.0 + torch.cos(safe_t)) / (2.0 * safe_t * torch.sin(torch.where(small, one, safe_t))),
    )
    K = hat(phi)
    return _eye_like(K) + 0.5 * K + coef[..., None] * (K @ K)


def _inv_transpose3(X: torch.Tensor) -> torch.Tensor:
    """X^{-T} of (...,3,3) matrices by cofactors (no solver, no host sync)."""
    c0, c1, c2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    cof = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], dim=-2)
    det = torch.sum(c0 * cof[..., 0, :], dim=-1)
    return cof / det[..., None, None]


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """The rotation nearest a near-rotation matrix (IMU::NormalizeRotation).

    The JAX package takes it from an SVD, U diag(1, 1, det(U V^T)) V^T. For
    det(R) > 0, which every product of rotations has, that is the
    orthogonal polar factor of R, and Newton's iteration X <- (X + X^{-T})/2
    reaches it quadratically: from a matrix a few float32 steps off SO(3),
    three steps land within rounding of the SVD's answer. On a GPU an SVD
    waits for the host to check its result; these cofactor products do
    not."""
    X = R
    for _ in range(3):
        X = 0.5 * (X + _inv_transpose3(X))
    return X


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def se3_exp(xi: torch.Tensor):
    """(...,6) tangent [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), _matvec(so3_left_jacobian(phi), rho)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_apply(R, t, p):
    """Transform points p (...,3)."""
    return _matvec(R, p) + t


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w,x,y,z), branch-free Shepperd method,
    w >= 0."""
    # entries keep a trailing axis (see _sinc_coeffs_sq)
    m00, m01, m02 = R[..., 0, 0:1], R[..., 0, 1:2], R[..., 0, 2:3]
    m10, m11, m12 = R[..., 1, 0:1], R[..., 1, 1:2], R[..., 1, 2:3]
    m20, m21, m22 = R[..., 2, 0:1], R[..., 2, 1:2], R[..., 2, 2:3]
    tr = m00 + m11 + m22
    # four candidate quaternions (up to scale), one per Shepperd case
    qw = torch.cat([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.cat([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.cat([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.cat([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cases = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4,4)
    scores = torch.cat([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)  # first of ties, as jnp.argmax
    q = torch.gather(cases, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z), normalized first -> rotation matrix (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (...,3,3) -> (...,3) through the quaternion (stable near pi)."""
    q = mat_to_quat(R)
    w, v = q[..., :1], q[..., 1:]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    safe_n = torch.where(small, torch.ones_like(n), n)
    return torch.where(small, 2.0 / torch.clamp_min(w, 1e-6), theta / safe_n) * v


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    return so3_right_jacobian_inv(-phi)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (...,6) tangent [rho, phi]."""
    phi = so3_log(R)
    return torch.cat([_matvec(_left_jacobian_inv(phi), t), phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3): (s, R, t) acts as p -> s R p + t (g2o::Sim3). Inside, the scale and
# the angle keep a trailing axis (see _sinc_coeffs_sq).
# ---------------------------------------------------------------------------


def _sim3_W(theta: torch.Tensor, sigma: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'W' matrix coupling translation with rotation and scale
    (Eade; Strasdat's thesis). theta, sigma: (...,1)."""
    eps = 1e-5
    s = torch.exp(sigma)
    t2 = theta * theta
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    safe_sig = torch.where(sig_small, torch.ones_like(sigma), sigma)
    safe_th = torch.where(th_small, torch.ones_like(theta), theta)
    t2c = torch.clamp_min(t2, eps**2)

    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sig)
    # theta small & sigma small
    A_ss = 0.5 + sigma / 6.0
    B_ss = 1.0 / 6.0 + sigma / 24.0
    # theta small, sigma general
    A_sg = ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig) * torch.ones_like(theta)
    B_sg = (s * (safe_sig * safe_sig / 2.0 - safe_sig + 1.0) - 1.0) / safe_sig**3
    # theta general, sigma small
    A_gs = (1.0 - torch.cos(safe_th)) / t2c
    B_gs = (safe_th - torch.sin(safe_th)) / safe_th**3
    # general / general
    a = s * torch.sin(safe_th)
    b = s * torch.cos(safe_th)
    c2 = safe_th * safe_th + safe_sig * safe_sig
    A_gg = (a * safe_sig + (1.0 - b) * safe_th) / (safe_th * c2)
    B_gg = (C - ((b - 1.0) * safe_sig + a * safe_th) / c2) / t2c

    A = torch.where(th_small, torch.where(sig_small, A_ss, A_sg), torch.where(sig_small, A_gs, A_gg))
    B = torch.where(th_small, torch.where(sig_small, B_ss, B_sg), torch.where(sig_small, B_gs, B_gg))
    K = hat(phi)
    return C[..., None] * _eye_like(K) + A[..., None] * K + B[..., None] * (K @ K)


def sim3_exp(xi: torch.Tensor):
    """(...,7) [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    t = _matvec(_sim3_W(theta, sigma, phi), rho)
    return torch.exp(sigma)[..., 0], so3_exp(phi), t


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(s, R, t) -> (...,7) [rho, phi, sigma]. W is inverted by cofactors
    (the JAX package solves; the same 3x3 system)."""
    sigma = torch.log(s)[..., None]
    phi = so3_log(R)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    W = _sim3_W(theta, sigma, phi)
    rho = _matvec(_inv_transpose3(W).transpose(-1, -2), t)
    return torch.cat([rho, phi, sigma], dim=-1)


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): p -> sa Ra (sb Rb p + tb) + ta."""
    return sa * sb, Ra @ Rb, sa[..., None] * _matvec(Ra, tb) + ta


def sim3_inv(s, R, t):
    s_inv = 1.0 / s[..., None]
    Rt = R.transpose(-1, -2)
    return s_inv[..., 0], Rt, -s_inv * _matvec(Rt, t)


def sim3_apply(s, R, t, p):
    return s[..., None] * _matvec(R, p) + t
