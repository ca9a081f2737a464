"""The plain references that decide `correct`, and the roofline arithmetic.

Plain PyTorch and NumPy, written for this benchmark. Nothing here imports the
program, and nothing takes what the program made except the values that
the references judge (see PERF.md, "How correct is decided"). Every
reference takes a `dtype`: float64 for the reference itself, bfloat16 for
the control (the reference put in the program's place one precision below
the float32 the configuration states: residuals, Jacobians, their products
and the normal equations' terms in bfloat16; the small solves, which torch
has no bfloat16 solver for, in float64 on those terms).

- `rpe`: relative pose error of a trajectory against the generated motion
  over pairs of frames a fixed time apart (Sim(3) scale first for mono).
- `window_match`: the best, its index and the second best Hamming distance
  of each query among the targets inside its window and octave band.
- `pose_lm`: ORB-SLAM's motion-only PoseOptimization (4 rounds of 10 LM
  iterations, Huber in the first two, chi2 re-classification between).
- `viba_lm`: the inertial local BA, LM with the points eliminated.
- `vi_refine_lm`: the VI refinement of a tracked frame's body state.
- `preintegrate`: the IMU increments dR, dV, dP of one sample chunk.
- `window_match_bound`: the least time of one window match on the card.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
BIG = 1 << 20
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and 32-bit integer ops/s taken
# at the float32 vector rate
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


# --------------------------------------------------------------- trajectory
def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """s, R, t minimising ||s R model + t - data|| over (N,3) rows."""
    mu_m, mu_d = model.mean(0), data.mean(0)
    mc, dc = model - mu_m, data - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ mc)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = float((S * np.diag(D)).sum() / max((mc ** 2).sum(), 1e-12)) if with_scale else 1.0
    return s, R, mu_d - s * (R @ mu_m)


def rpe(est_wc: np.ndarray, gt_wc: np.ndarray, times: np.ndarray, delta_s: float,
        with_scale: bool) -> tuple[float, int]:
    """RMSE (in the ground truth's units) of the translation of
    (Q_i^-1 Q_j)^-1 (P_i^-1 P_j) over every pair of rows j > i whose times
    lie `delta_s` apart (to 1 ms); P are the estimate's T_wc (N,4,4), Q the
    truth's. With `with_scale` the estimate's positions are first scaled by
    the Sim(3) fit of its positions onto the truth's. Returns (rmse, pairs)."""
    P = np.array(est_wc, np.float64, copy=True)
    if with_scale and len(P) >= 3:
        s, _, _ = horn_align(P[:, :3, 3], gt_wc[:, :3, 3], True)
        P[:, :3, 3] *= s
    j = np.searchsorted(times, times + delta_s - 1e-3)
    keep = (j < len(times))
    i = np.nonzero(keep)[0]
    j = j[keep]
    ok = np.abs(times[j] - times[i] - delta_s) < 1e-3
    i, j = i[ok], j[ok]
    if len(i) == 0:
        return float("inf"), 0
    inv = np.linalg.inv
    E = inv(inv(gt_wc[i]) @ gt_wc[j]) @ (inv(P[i]) @ P[j])
    err = np.linalg.norm(E[:, :3, 3], axis=1)
    return float(np.sqrt((err ** 2).mean())), len(i)


# ------------------------------------------------------------- window match
def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    return sum(((x >> b) & 1) for b in range(32))


def _inside(args, dtype):
    """(N,M) in-window mask of one launch's arguments, the window test
    |du| < r, |dv| < r computed in `dtype`."""
    _, q_uv, r, lo, hi, _, t_xy, t_level, t_valid = args
    q_uv, r, t_xy = q_uv.to(dtype), r.to(dtype), t_xy.to(dtype)
    return ((torch.abs(q_uv[:, None, 0] - t_xy[None, :, 0]) < r[:, None])
            & (torch.abs(q_uv[:, None, 1] - t_xy[None, :, 1]) < r[:, None])
            & (t_valid[None, :] > 0) & (t_level[None, :] >= lo[:, None])
            & (t_level[None, :] <= hi[:, None]))


def window_match(args, dtype=F64):
    """(idx, best, second, dist) for one launch's arguments (qdesc, q_uv,
    q_radius, q_lvl_lo, q_lvl_hi, tdesc, t_xy, t_level, t_valid); the
    window test in `dtype`; `dist` the (N,M) distances with BIG outside
    the windows."""
    qdesc, tdesc = args[0], args[5]
    inside = _inside(args, dtype)
    qi, tj = inside.nonzero(as_tuple=True)
    dist = torch.full(inside.shape, BIG, dtype=torch.int64, device=inside.device)
    dist[qi, tj] = _popcount(qdesc[qi] ^ tdesc[tj]).sum(-1)
    if dist.shape[1] == 0:
        big = torch.full((dist.shape[0],), BIG, dtype=torch.int64, device=dist.device)
        return torch.zeros_like(big), big, big.clone(), dist
    best, idx = dist.min(dim=1)
    second = dist.scatter(1, idx[:, None], BIG).amin(dim=1)
    return idx, best, second, dist


def window_match_mismatches(out, ref) -> int:
    """Rows where a launch's (idx, best, second) disagrees with the
    reference's: best or second differs, or idx names a column whose
    in-window distance is not best (any column of a tie is right); a row
    with no candidate must give idx 0."""
    idx, best, second = (x.long() for x in out)
    _, r_best, r_second, dist = ref
    bad = (best != r_best) | (second != r_second)
    hit = r_best < BIG
    picked = dist.gather(1, idx.clamp(0, max(dist.shape[1] - 1, 0))[:, None])[:, 0] \
        if dist.shape[1] else torch.full_like(best, BIG)
    bad |= hit & (picked != r_best)
    bad |= ~hit & (idx != 0)
    return int(bad.sum())


def window_match_bound(args, pairs: int) -> tuple[float, str]:
    """(seconds, what sets it) of the least time of one window match: each
    input read once and each output (three int32 per query) written once at
    the HBM rate, and 8 XOR, 8 POPC and 8 adds for each of `pairs`
    in-window pairs at the 32-bit ALU rate."""
    n = args[0].shape[0]
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * 4 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 24 * pairs / ALU_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def window_pairs(args) -> int:
    """In-window (query, target) pairs of one launch (float32 test, as the
    kernel makes it)."""
    return int(_inside(args, torch.float32).sum())


# ------------------------------------------------------------------ geometry
def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1).reshape(v.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, in float64 whatever the input."""
    w = w.to(F64)
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _hat(w)
    small = th < 1e-8
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - th ** 2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    return torch.eye(3, dtype=F64, device=w.device) + a * K + b * (K @ K)


def se3_exp(xi: torch.Tensor):
    """(R, t) of exp of the twist (..., 6) = [rho, phi], in float64: t is
    the left Jacobian of phi times rho."""
    xi = xi.to(F64)
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.norm(phi, dim=-1)[..., None, None]
    K = _hat(phi)
    small = th < 1e-8
    ths = torch.where(small, 1.0, th)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    c = torch.where(small, 1.0 / 6 - th ** 2 / 120, (ths - torch.sin(ths)) / ths ** 3)
    V = torch.eye(3, dtype=F64, device=xi.device) + b * K + c * (K @ K)
    return so3_exp(phi), (V @ rho[..., None])[..., 0]


def _project(cam: dict, pc: torch.Tensor):
    """Pixel (u, v) and the right image's u of camera-frame points."""
    z = torch.clamp_min(pc[..., 2], 1e-6)
    u = cam["fx"] * pc[..., 0] / z + cam["cx"]
    v = cam["fy"] * pc[..., 1] / z + cam["cy"]
    return u, v, u - cam["bf"] / z, z


def _residual_jac(cam: dict, pc: torch.Tensor, uv, ur):
    """Residual (…,3) (observed minus predicted; the third row only where
    ur >= 0), the row mask, and d(residual)/d(pc) (…,3,3)."""
    u, v, u_r, z = _project(cam, pc)
    stereo = ur >= 0
    r = torch.stack([uv[..., 0] - u, uv[..., 1] - v, torch.where(stereo, ur - u_r, 0.0)], -1)
    x, y = pc[..., 0], pc[..., 1]
    zero = torch.zeros_like(z)
    du = torch.stack([cam["fx"] / z, zero, -cam["fx"] * x / z ** 2], -1)
    dv = torch.stack([zero, cam["fy"] / z, -cam["fy"] * y / z ** 2], -1)
    dur = du + torch.stack([zero, zero, cam["bf"] / z ** 2], -1)
    J = -torch.stack([du, dv, dur], -2)
    mask = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo), stereo], -1)
    return torch.where(mask, r, 0.0), mask, J


def _huber(chi2, delta2, on: bool):
    if not on:
        return chi2, torch.ones_like(chi2)
    cost = torch.where(chi2 <= delta2, chi2,
                       2 * torch.sqrt(delta2) * torch.sqrt(torch.clamp_min(chi2, 1e-12)) - delta2)
    w = torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)))
    return cost, w


# ------------------------------------------------------------------ pose LM
def pose_lm(cam: dict, R0, t0, p_world, uv, ur, level, valid, dtype=F64,
            iters_per_round: int = 10):
    """Motion-only pose optimisation of T_cw from (R0, t0) over the
    matches `valid`, each step T <- exp(xi) T: 4 rounds of LM (start
    damping 1e-3, halved on an accepted step, x4 on a rejected one, a round
    ends once an accepted step is under 1e-6), Huber (chi2 5.991 mono / 7.815 stereo) in rounds 0-1,
    information 1.2^(-2 level), re-classification chi2 <= threshold after
    each round. Residuals, Jacobians and normal equations in `dtype`.
    Returns (R, t) in float64."""
    cv = lambda x: x.to(dtype)
    dev = R0.device
    R, t = R0.to(F64), t0.to(F64)
    P, uv, ur = cv(p_world), cv(uv), cv(ur)
    info = cv(torch.pow(1.2, -2.0 * level.to(F64)))
    delta2 = cv(torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO).to(F64))
    inlier = valid.clone()

    def terms(R, t, huber):
        pc = P @ cv(R).T + cv(t)
        r, mask, Jp = _residual_jac(cam, pc, uv, ur)
        chi2 = (r * r).sum(-1) * info
        cost, w = _huber(chi2, delta2, huber)
        return pc, r, mask, Jp, chi2, cost, w

    for rnd in range(4):
        huber = rnd < 2
        lam = 1e-3
        for _ in range(iters_per_round):
            pc, r, mask, Jp, chi2, cost, w = terms(R, t, huber)
            w = torch.where(inlier, w * info, 0.0)
            # d(pc)/d(xi) = [I | -hat(pc)] for T <- exp(xi) T
            dxi = torch.cat([torch.eye(3, dtype=dtype, device=pc.device).expand(pc.shape[:-1]
                                                                               + (3, 3)),
                             -_hat(pc)], -1)
            J = (Jp @ dxi) * mask[..., None]
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = torch.einsum("nri,nr->i", Jw, r)
            cost0 = torch.where(inlier, cost, 0.0).sum()
            H = H.to(F64)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * torch.eye(6, dtype=F64, device=dev)
            dx = torch.linalg.solve(Hd, -b.to(F64))
            dR, dt = se3_exp(dx)
            R_new, t_new = dR @ R, dR @ t + dt
            cost1 = torch.where(inlier, terms(R_new, t_new, huber)[5], 0.0).sum()
            if bool(cost1 < cost0):
                R, t, lam = R_new, t_new, lam * 0.5
                if float((dx * dx).sum()) < 1e-12:
                    break
            else:
                lam = lam * 4.0
        chi2 = terms(R, t, False)[4]
        inlier = valid & (chi2 <= delta2)
    return R, t


# --------------------------------------------------------------- inertial BA
GRAVITY = 9.81


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of R (angles well below pi), by the angle and the
    skew part: differentiable, in R's dtype."""
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    sn = torch.linalg.norm(s, dim=-1, keepdim=True)
    th = torch.atan2(sn, c[..., None])
    small = sn < 1e-4
    k = torch.where(small, 1.0 + th * th / 6, th / torch.where(small, 1.0, sn))
    return k * s


def _exp_dtype(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues in w's dtype, differentiable at 0."""
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, 1.0, t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(th)) / t2s)
    K = _hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _inertial_residual(xi, xj, Ri, pi, vi, bi, Rj, pj, vj, pre, dtype):
    """The 9-dim preintegration residual [er, ev, ep] of one link (ORB-SLAM3's
    EdgeInertial) with both body states moved by xi, xj (15: rotation on
    the right, then position, velocity, gyro and acc bias added); the
    increments corrected to first order for the first state's bias."""
    cv = lambda x: x.to(dtype)
    Ri = Ri @ _exp_dtype(xi[:3])
    pi, vi, bi = pi + xi[3:6], vi + xi[6:9], bi + xi[9:15]
    Rj = Rj @ _exp_dtype(xj[:3])
    pj, vj = pj + xj[3:6], vj + xj[6:9]
    dbg, dba = bi[:3] - cv(pre["bias"][:3]), bi[3:] - cv(pre["bias"][3:])
    dR = cv(pre["dR"]) @ _exp_dtype(cv(pre["J_rg"]) @ dbg)
    dV = cv(pre["dV"]) + cv(pre["J_vg"]) @ dbg + cv(pre["J_va"]) @ dba
    dP = cv(pre["dP"]) + cv(pre["J_pg"]) @ dbg + cv(pre["J_pa"]) @ dba
    t = cv(pre["dT"])
    g = torch.zeros(3, dtype=dtype, device=Ri.device)
    g[2] = -GRAVITY
    er = so3_log(dR.T @ Ri.T @ Rj)
    ev = Ri.T @ (vj - vi - g * t) - dV
    ep = Ri.T @ (pj - pi - vi * t - 0.5 * g * t * t) - dP
    return torch.cat([er, ev, ep])


def _link_info(pre: dict, k: int):
    """(9x9 information of the residual, 6x6 of the bias walk) of link k,
    in float64, from the preintegration's covariance."""
    C = pre["C"][k].to(F64)
    C9 = 0.5 * (C[:9, :9] + C[:9, :9].T)
    e = lambda n: torch.eye(n, dtype=F64, device=C.device)
    return torch.linalg.inv(C9 + 1e-9 * e(9)), torch.linalg.inv(C[9:15, 9:15] + 1e-9 * e(6))


def _viba_visual(cam: dict, prob: dict, st, dtype):
    """Reprojection terms of every observation at the state st = (Rwb, pwb,
    vel, bias, p): residual, row mask, Huber cost and IRLS weight times the
    octave information, and the Jacobians of the residual with respect to
    the observing body's [rotation, position] (P,D,3,6) and the point."""
    cv = lambda x: x.to(dtype)
    Rwb, pwb, p = cv(st[0]), cv(st[1]), cv(st[4])
    Rcb, tcb = cv(prob["Rcb"]), cv(prob["tcb"])
    oc = prob["obs_cam"].long()
    Rbw = Rwb.transpose(-1, -2)[oc]                                     # (P,D,3,3)
    q = (Rbw @ (p[:, None, :] - pwb[oc])[..., None])[..., 0]            # body frame
    pc = q @ Rcb.T + tcb
    r, mask, Jpc = _residual_jac(cam, pc, cv(prob["obs_uv"]), cv(prob["obs_ur"]))
    RcbRbw = Rcb @ Rbw
    # q = Rwb^T (x - pwb); Rwb <- Rwb Exp(phi): dq/dphi = hat(q)
    Jb = torch.cat([Jpc @ (Rcb @ _hat(q)), -(Jpc @ RcbRbw)], -1)
    Jx = Jpc @ RcbRbw
    info = cv(torch.pow(1.2, -2.0 * prob["obs_level"].to(F64)))
    delta2 = cv(torch.where(prob["obs_ur"] >= 0, CHI2_STEREO, CHI2_MONO).to(F64))
    valid = prob["obs_valid"] & prob["p_valid"][:, None]
    chi2 = (r * r).sum(-1) * info
    cost, w = _huber(chi2, delta2, True)
    return (r, mask, torch.where(valid, cost, 0.0), torch.where(valid, w * info, 0.0),
            Jb * mask[..., None], Jx * mask[..., None], oc)


def viba_cost(cam: dict, prob: dict, st, dtype=F64) -> float:
    """The cost the inertial local BA minimises at st = (Rwb, pwb, vel,
    bias, p): Huber reprojection terms, plus r^T Info r of each link's
    preintegration residual and of its bias random walk."""
    total = _viba_visual(cam, prob, st, dtype)[2].to(F64).sum()
    pre, ok = prob["pre"], prob["pre_valid"]
    z = torch.zeros(15, dtype=dtype, device=st[1].device)
    for k in range(st[0].shape[0] - 1):
        if not bool(ok[k]):
            continue
        info9, info6 = _link_info(pre, k)
        link = [st[m][k + d].to(dtype) for d in (0, 1) for m in range(4)]
        r = _inertial_residual(z, z, *link[:4], *link[4:7], {n: v[k] for n, v in pre.items()},
                               dtype).to(F64)
        rb = (st[3][k + 1] - st[3][k]).to(dtype).to(F64)
        total = total + r @ info9 @ r + rb @ info6 @ rb
    return float(total)


def viba_lm(cam: dict, prob: dict, iters: int = 10, dtype=F64):
    """ORB-SLAM3's LocalInertialBA over a keyframe chain: per keyframe a
    15-dof body state (rotation on the right, position, velocity, gyro and
    acc bias), the points; reprojection factors (Huber, octave
    information), a preintegration factor and a bias random-walk factor
    (information from the covariance) per valid link; the poses of `fixed`
    keyframes held. Levenberg-Marquardt: start damping 1e-4 on the
    diagonals (floored at 1e-6) of the point blocks and of the
    point-reduced keyframe system, halved on an accepted step, x5 on a
    rejected one; the link Jacobians by autograd. Terms in `dtype`, the
    dense solves in float64. Returns (Rwb, pwb, vel, bias, p) in float64."""
    st = [prob[k].to(F64) for k in ("Rwb", "pwb", "vel", "bias", "p")]
    dev = st[1].device
    K, P = st[0].shape[0], st[4].shape[0]
    z = dict(dtype=F64, device=dev)
    pre = prob["pre"]
    links = [k for k in range(K - 1) if bool(prob["pre_valid"][k])]
    infos = {k: _link_info(pre, k) for k in links}
    lam = 1e-4
    for _ in range(iters):
        cost0 = viba_cost(cam, prob, st, dtype)
        r, _, _, w, Jb, Jx, oc = _viba_visual(cam, prob, st, dtype)
        wr = w[..., None, None]
        Hbb_o = ((Jb * wr).transpose(-1, -2) @ Jb).to(F64)                # (P,D,6,6)
        bb_o = -((Jb * wr).transpose(-1, -2) @ r[..., None])[..., 0].to(F64)
        Hxx = ((Jx * wr).transpose(-1, -2) @ Jx).sum(1).to(F64)            # (P,3,3)
        bx = -((Jx * wr).transpose(-1, -2) @ r[..., None])[..., 0].sum(1).to(F64)
        Wo = ((Jb * wr).transpose(-1, -2) @ Jx).to(F64)                    # (P,D,6,3)
        eye3 = torch.eye(3, **z)
        Hxx_diag = torch.clamp_min(torch.diagonal(Hxx, dim1=-2, dim2=-1), 1e-6)
        Hxx_d = Hxx + lam * Hxx_diag[..., None, :] * eye3
        Hxx_d = Hxx_d + (~prob["p_valid"])[:, None, None] * eye3 + 1e-8 * eye3
        Hinv = torch.linalg.inv(Hxx_d)
        slot = (torch.arange(P, device=dev)[:, None] * K + oc).reshape(-1)
        Wk = torch.zeros((P * K, 6, 3), **z).index_add_(0, slot, Wo.reshape(-1, 6, 3))
        Wk = Wk.reshape(P, K, 6, 3)
        WkH = Wk @ Hinv[:, None]
        N = 15 * K
        S = torch.zeros((N, N), **z)
        rhs = torch.zeros(N, **z)
        pose = (torch.arange(K, device=dev)[:, None] * 15 + torch.arange(6, device=dev)).reshape(-1)
        S6 = -torch.einsum("pkac,plbc->kalb", WkH, Wk).reshape(6 * K, 6 * K)
        flat = oc.reshape(-1)
        Hbb = torch.zeros((K, 6, 6), **z).index_add_(0, flat, Hbb_o.reshape(-1, 6, 6))
        bb = torch.zeros((K, 6), **z).index_add_(0, flat, bb_o.reshape(-1, 6))
        S6 = S6 + torch.block_diag(*Hbb)
        S[pose[:, None], pose[None, :]] = S6
        rhs[pose] = (bb - torch.einsum("pkac,pc->ka", WkH, bx)).reshape(-1)
        for k in links:
            info9, info6 = infos[k]
            link = [st[m][k + d].to(dtype) for d in (0, 1) for m in range(4)]
            pk = {n: v[k] for n, v in pre.items()}
            x0 = torch.zeros(30, dtype=dtype, device=dev)
            fn = lambda x: _inertial_residual(x[:15], x[15:], *link[:4], *link[4:7], pk, dtype)
            J = torch.autograd.functional.jacobian(fn, x0, vectorize=True).to(F64)   # (9,30)
            ri = fn(x0).detach().to(F64)
            idx = torch.arange(15 * k, 15 * k + 30, device=dev)
            S[idx[:, None], idx[None, :]] += J.T @ info9 @ J
            rhs[idx] -= J.T @ info9 @ ri
            # the bias walk b_{k+1} - b_k
            Jw = torch.zeros((6, 30), **z)
            Jw[:, 9:15] = -torch.eye(6, **z)
            Jw[:, 24:30] = torch.eye(6, **z)
            rw = (st[3][k + 1] - st[3][k]).to(dtype).to(F64)
            S[idx[:, None], idx[None, :]] += Jw.T @ info6 @ Jw
            rhs[idx] -= Jw.T @ info6 @ rw
        d = torch.clamp_min(torch.diagonal(S), 1e-6)
        S = S + torch.diag(lam * d) + 1e-5 * torch.eye(N, **z)
        held = torch.zeros((K, 15), dtype=torch.bool, device=dev)
        held[:, :6] = prob["fixed"][:, None]
        free = torch.nonzero(~held.reshape(-1))[:, 0]
        dx = torch.zeros(N, **z)
        dx[free] = torch.linalg.solve(S[free][:, free], rhs[free])
        dx = dx.reshape(K, 15)
        Wdx = (Wk.transpose(-1, -2) @ dx[None, :, :6, None])[..., 0].sum(1)
        dp = (Hinv @ (bx - Wdx)[..., None])[..., 0]
        dp = torch.where(prob["p_valid"][:, None], dp, 0.0)
        new = [st[0] @ so3_exp(dx[:, :3]), st[1] + dx[:, 3:6], st[2] + dx[:, 6:9],
               st[3] + dx[:, 9:15], st[4] + dp]
        cost1 = viba_cost(cam, prob, new, dtype)
        if np.isfinite(cost1) and cost1 < cost0:
            st, lam = new, lam * 0.5
        else:
            lam *= 5.0
    return tuple(st)


def vi_refine_lm(cam: dict, state0: dict, prev: dict, pre: dict, obs: dict, Tcb, dtype=F64):
    """ORB-SLAM3's PoseInertialOptimizationLastKeyFrame without a prior: the
    current frame's 15-dof body state (rotation on the right, position,
    velocity, gyro and acc bias) from `state0`, against the matches `obs`
    (p_world, uv, u_right, level, valid) as Huber-weighted reprojections
    (octave information), the preintegration `pre` from the last
    keyframe's state `prev` (fixed; the increments corrected for its
    bias) and the bias random walk. 2 rounds of 5 LM steps (start damping
    1e-3 on the diagonal, halved on an accepted step, x4 on a rejected
    one), the inliers re-classified by chi2 between rounds; the Jacobian of
    the whitened residual vector by autograd, through the Huber weights.
    Terms in `dtype`, the 15x15 solves in float64. Returns (Rwb, pwb, vel,
    bias) in float64."""
    cv = lambda x: x.to(dtype)
    dev = state0["pwb"].device
    Rcb, tcb = cv(Tcb[0]), cv(Tcb[1])
    info9, info6 = _link_info({"C": pre["C"][None]}, 0)
    L9 = cv(torch.linalg.cholesky(info9 + 1e-8 * torch.eye(9, dtype=F64, device=dev)).T)
    L6 = cv(torch.linalg.cholesky(info6 + 1e-9 * torch.eye(6, dtype=F64, device=dev)).T)
    P, uv, ur = cv(obs["p_world"]), cv(obs["uv"]), cv(obs["u_right"])
    info = cv(torch.pow(1.2, -2.0 * obs["level"].to(F64)))
    delta2 = cv(torch.where(obs["u_right"] >= 0, CHI2_STEREO, CHI2_MONO).to(F64))
    s0 = [cv(state0[k]) for k in ("Rwb", "pwb", "vel", "bias")]
    pv = [cv(prev[k]) for k in ("Rwb", "pwb", "vel", "bias")]
    z15 = torch.zeros(15, dtype=dtype, device=dev)

    def state(x):
        return s0[0] @ _exp_dtype(x[:3]), s0[1] + x[3:6], s0[2] + x[6:9], s0[3] + x[9:15]

    def visual(x):
        Rwb, pwb = state(x)[:2]
        Rcw = Rcb @ Rwb.T
        pc = P @ Rcw.T + (tcb - Rcw @ pwb)
        u, v, u_r, _ = _project(cam, pc)
        r = torch.stack([uv[:, 0] - u, uv[:, 1] - v, torch.where(ur >= 0, ur - u_r, 0.0)], -1)
        r = torch.where(obs["valid"][:, None], r, 0.0)
        return r, (r * r).sum(-1) * info

    def residuals(x, inlier):
        r, chi2 = visual(x)
        _, w = _huber(chi2, delta2, True)
        w = torch.where(inlier, w * info, 0.0)
        sw = torch.where(w > 0, torch.sqrt(torch.clamp_min(w, torch.finfo(dtype).tiny)), 0.0)
        st = state(x)
        r_imu = _inertial_residual(z15, x, *pv, *s0[:3], pre, dtype)
        return torch.cat([(r * sw[:, None]).reshape(-1), L9 @ r_imu, L6 @ (st[3] - pv[3])])

    inlier = obs["valid"].clone()
    x = torch.zeros(15, dtype=F64, device=dev)
    eye = torch.eye(15, dtype=F64, device=dev)
    for _ in range(2):
        lam = 1e-3
        f = lambda xx: residuals(xx, inlier)
        for _ in range(5):
            J = torch.autograd.functional.jacobian(f, cv(x), vectorize=True,
                                                   strategy="forward-mode").to(F64)
            r = f(cv(x)).detach().to(F64)
            H = J.T @ J
            x_new = x + torch.linalg.solve(H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye,
                                           -(J.T @ r))
            if bool((f(cv(x_new)).detach().to(F64) ** 2).sum() < (r ** 2).sum()):
                x, lam = x_new, lam * 0.5
            else:
                lam *= 4.0
        inlier = obs["valid"] & (visual(cv(x))[1] <= delta2)
    Rwb, pwb, vel, bias = (t.detach().to(F64) for t in state(cv(x)))
    return Rwb, pwb, vel, bias


# ------------------------------------------------------------- preintegration
def preintegrate(acc, gyr, dts, bias, dtype=F64):
    """dR, dV, dP of a sample chunk with the bias [bg, ba] removed: per
    sample dP += dV dt + R a dt^2 / 2, dV += R a dt, R <- R Exp(w dt),
    the products in `dtype`. Returns float64 (dR, dV, dP)."""
    cv = lambda x: x.to(dtype)
    a_all = cv(acc) - cv(bias[3:])
    w_all = cv(gyr) - cv(bias[:3])
    dts = cv(torch.clamp_min(dts, 0.0))
    dR = torch.eye(3, dtype=dtype, device=acc.device)
    dV = torch.zeros(3, dtype=dtype, device=acc.device)
    dP = torch.zeros(3, dtype=dtype, device=acc.device)
    for i in range(acc.shape[0]):
        dt = dts[i]
        Ra = dR @ a_all[i]
        dP = dP + dV * dt + 0.5 * Ra * dt * dt
        dV = dV + Ra * dt
        dR = dR @ cv(so3_exp(w_all[i] * dt))
    return dR.to(F64), dV.to(F64), dP.to(F64)


def preint_gap(ref, got) -> float:
    """The largest relative gap of (dR, dV, dP) `got` against `ref`: the
    rotation angle between them over the reference's angle (at least 1e-3
    rad), the velocity and position gaps over the reference's norms (at
    least 1e-3 m/s and 1e-4 m)."""
    dR, dV, dP = ref
    gR, gV, gP = (x.to(F64) for x in got)
    def angle(M):
        # atan2 of the skew part against the trace: arccos of the trace
        # alone reads a float32 matrix's round-off as ~5e-4 rad
        s = 0.5 * torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
        c = (torch.diagonal(M).sum() - 1) / 2
        return float(torch.atan2(torch.linalg.norm(s), c))
    a = angle(dR.T @ gR) / max(angle(dR), 1e-3)
    v = float(torch.linalg.norm(gV - dV)) / max(float(torch.linalg.norm(dV)), 1e-3)
    p = float(torch.linalg.norm(gP - dP)) / max(float(torch.linalg.norm(dP)), 1e-4)
    return max(a, v, p)


