"""DLT triangulation (batched).

Port of `orb_slam3_comments_ghr_tpu/ops/triangulate.py` (GeometricTools::
Triangulate, reference src/GeometricTools.cc:62): the 4x4 design matrix of
each point is solved by batched SVD, in float32 as the JAX package's
`_triangulate_f32` (TF32 is off for the whole port, so these small products
run in full float32 on the card too).
"""

from __future__ import annotations

import torch


def triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """P1, P2: (3,4) or (...,3,4) projection matrices; x1, x2: (...,2)
    pixel coordinates matching P's convention. Returns (...,3) Euclidean
    points."""
    return dlt_point(torch.linalg.svd(dlt_rows(P1, P2, x1, x2)).Vh)


def dlt_rows(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The (...,4,4) design matrices of `triangulate`: a batch of P2 (e.g.
    candidate motions) against one P1 broadcasts."""
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    return torch.stack(torch.broadcast_tensors(*rows), dim=-2)


def dlt_point(Vh: torch.Tensor):
    """The Euclidean points from the design matrices' right singular
    vectors Vh (...,4,4): the smallest one, whose sign cancels in the
    division. The SVD between `dlt_rows` and this waits on the host (its
    error check), so a CUDA graph may hold either side but not it."""
    X = Vh[..., 3, :]
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """(3,4) P = K [R|t] (world->cam)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)
