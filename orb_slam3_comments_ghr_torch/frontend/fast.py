"""FAST-9/16 corner response with 3x3 non-max suppression.

Port of `RING`, `_ARC_MASKS`, `nms3` and `dual_threshold_response` from
`orb_slam3_comments_ghr_tpu/frontend/fast.py`. The ring pixels come from
`torch.roll`, so they wrap around the image edge; callers mask the border
afterwards, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, circularly ordered (dy, dx).
RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous run required (FAST-9/16)

# 16 circular 9-bit masks over a 16-bit ring word.
_ARC_MASKS = tuple(sum(1 << ((r + i) % 16) for i in range(ARC_LEN)) for r in range(16))


def nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression over the last two dims; keeps positive
    values that equal their neighbourhood max (max_pool2d pads with -inf,
    as reduce_window SAME does)."""
    h, w = resp.shape[-2:]
    nb = F.max_pool2d(resp.reshape(-1, 1, h, w), 3, stride=1, padding=1).reshape(resp.shape)
    return torch.where((resp >= nb) & (resp > 0.0), resp, 0.0)


def _hit(word: torch.Tensor) -> torch.Tensor:
    h = torch.zeros(word.shape, dtype=torch.bool, device=word.device)
    for m in _ARC_MASKS:
        h = h | ((word & m) == m)
    return h


def dual_threshold_response(
    img: torch.Tensor,
    ini_threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 35,
) -> torch.Tensor:
    """Per-cell dual-threshold FAST (ORBextractor.cc:1100-1135): cells with
    any strong corner use the strong response, empty cells fall back to the
    weak threshold. Both thresholds accumulate in one pass over the 16 ring
    offsets. img: (..., H, W) float32."""
    zi = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    zf = torch.zeros_like(img)
    wb_i = wd_i = wb_m = wd_m = zi
    sb_i = sd_i = sb_m = sd_m = zf
    for k, (dy, dx) in enumerate(RING):
        d = torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) - img
        wb_i = wb_i | ((d > ini_threshold).to(torch.int32) << k)
        wd_i = wd_i | ((d < -ini_threshold).to(torch.int32) << k)
        wb_m = wb_m | ((d > min_threshold).to(torch.int32) << k)
        wd_m = wd_m | ((d < -min_threshold).to(torch.int32) << k)
        sb_i = sb_i + torch.clamp_min(d - ini_threshold, 0.0)
        sd_i = sd_i + torch.clamp_min(-d - ini_threshold, 0.0)
        sb_m = sb_m + torch.clamp_min(d - min_threshold, 0.0)
        sd_m = sd_m + torch.clamp_min(-d - min_threshold, 0.0)

    strong = nms3(torch.where(_hit(wb_i) | _hit(wd_i), torch.maximum(sb_i, sd_i), 0.0))
    weak = nms3(torch.where(_hit(wb_m) | _hit(wd_m), torch.maximum(sb_m, sd_m), 0.0))

    h, w = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    gh, gw = -(-h // cell), -(-w // cell)
    sp = F.pad(strong, (0, gw * cell - w, 0, gh * cell - h))
    cell_has_strong = sp.reshape(lead + (gh, cell, gw, cell)).amax(dim=(-3, -1)) > 0.0
    use_strong = cell_has_strong.repeat_interleave(cell, -2).repeat_interleave(cell, -1)[..., :h, :w]
    return torch.where(use_strong, strong, weak)
