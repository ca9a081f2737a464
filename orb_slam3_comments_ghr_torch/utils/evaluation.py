"""Trajectory evaluation: Horn alignment + ATE RMSE.

Re-implementation of the reference's offline metric harness
(reference: evaluation/evaluate_ate_scale.py:50-118 `align`, and
evaluation/associate.py timestamp matching). Same math: SVD-based Horn
alignment with optional similarity scale, RMSE of translational residuals.

Copied unchanged from `orb_slam3_comments_ghr_tpu/utils/evaluation.py`, so
the port needs no JAX.
"""

from __future__ import annotations

import numpy as np


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (associate.py defaults)."""
    ia, ib = [], []
    used = set()
    for i, ta in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - ta)))
        if abs(t_b[j] - ta) <= max_dt and j not in used:
            ia.append(i)
            ib.append(j)
            used.add(j)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """Align `model` (N,3) onto `data` (N,3): find s, R, t minimizing
    ||s R model + t - data||. Returns (s, R, t, rmse). Mirrors
    evaluate_ate_scale.py's `align` (which aligns column-major; same result)."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc**2).sum()
        s = float((S * np.diag(D)).sum() / max(var_m, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * (R @ mu_m)
    aligned = s * (model @ R.T) + t
    err = aligned - data
    rmse = float(np.sqrt((err**2).sum(-1).mean()))
    return s, R, t, rmse


def ate_rmse(
    est: list[tuple[float, np.ndarray]],
    gt: list[tuple[float, np.ndarray]],
    with_scale: bool = True,
    max_dt: float = 0.02,
) -> float:
    """est/gt: lists of (timestamp, 4x4 T_cw). Returns RMSE ATE in the gt
    units after Horn alignment (the reference's headline metric)."""
    t_e = np.array([t for t, _ in est])
    t_g = np.array([t for t, _ in gt])
    ia, ib = associate(t_e, t_g, max_dt)
    if len(ia) < 3:
        return float("inf")
    pe = np.stack([np.linalg.inv(est[i][1])[:3, 3] for i in ia])
    pg = np.stack([np.linalg.inv(gt[j][1])[:3, 3] for j in ib])
    _, _, _, rmse = horn_align(pe, pg, with_scale)
    return rmse
