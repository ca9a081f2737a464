"""Frame feature container (padded, fixed capacity).

Port of `orb_slam3_comments_ghr_tpu/frontend/types.py`. Descriptors are
(N,8) int32 words, bit-identical to the JAX package's uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    """Per-image ORB features, padded to a static capacity N.

    xy:       (N, 2) float32 — keypoint position in level-0 pixel coords
    level:    (N,)   int32   — pyramid octave (0..n_levels-1)
    angle:    (N,)   float32 — orientation in radians
    response: (N,)   float32 — corner response (selection score)
    desc:     (N, 8) int32   — 256-bit rBRIEF descriptor, bit-packed
    valid:    (N,)   bool    — padding mask
    u_right:  (N,)   float32 — right-image u for stereo/RGB-D, -1 if none
    depth:    (N,)   float32 — metric depth, -1 if unknown
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    u_right: torch.Tensor
    depth: torch.Tensor


def empty_features(n: int, device="cuda") -> Features:
    """n invalid feature slots on `device` (the card unless the caller asks
    for another)."""
    f32 = dict(dtype=torch.float32, device=device)
    return Features(
        xy=torch.zeros((n, 2), **f32),
        level=torch.zeros((n,), dtype=torch.int32, device=device),
        angle=torch.zeros((n,), **f32),
        response=torch.full((n,), -torch.inf, **f32),
        desc=torch.zeros((n, 8), dtype=torch.int32, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        u_right=torch.full((n,), -1.0, **f32),
        depth=torch.full((n,), -1.0, **f32),
    )
