"""Binary descriptor matching.

Port of the projection-search part of `orb_slam3_comments_ghr_tpu/ops/
matching.py`: a masked Hamming-distance matrix, a top-2 reduction with ratio
test, duplicate resolution and the rotation-histogram check.

Descriptors are (N,8) torch.int32 words, bit-identical to the JAX package's
uint32 (`convert.py` views one as the other): torch's uint32 lacks `>>` and
`min` on the CPU.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor. Widened to int64 and
    masked first: an arithmetic right shift of a negative int32 word would
    drag its sign bit in."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(N,8) x (M,8) int32 -> (N,M) int32 Hamming distances, one word at a
    time so no (N,M,8) intermediate exists."""
    out = torch.zeros((da.shape[0], db.shape[0]), dtype=torch.int32, device=da.device)
    for k in range(da.shape[1]):
        out += popcount32(da[:, k, None] ^ db[None, :, k])
    return out


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Row-wise best and second-best over masked columns. Returns
    (best_idx (N,) int32, best (N,), second (N,)); rows without a candidate
    get best = second = BIG and idx 0 (argmin takes the first of ties),
    also when there is no column at all."""
    if dist.shape[1] == 0:  # argmin over an empty dimension raises
        big = torch.full((dist.shape[0],), BIG, dtype=torch.int32, device=dist.device)
        return torch.zeros_like(big), big, big.clone()
    d = torch.where(mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    second = d.scatter(1, best_idx[:, None], BIG).amin(dim=1)
    return best_idx.to(torch.int32), best, second


def ratio_test(best: torch.Tensor, second: torch.Tensor, th: int, ratio: float):
    """best < th and best < ratio * second (ORBmatcher nn-ratio)."""
    return (best < th) & (best.to(torch.float32) < ratio * second.to(torch.float32))


def rotation_consistency(ang_a, ang_b, match_idx, valid):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ComputeThreeMaxima, ORBmatcher.cc:2341)."""
    rot = torch.remainder(ang_a - ang_b[match_idx.long()], 2 * math.pi)
    bins = torch.clamp(
        (rot * (HISTO_LENGTH / (2 * math.pi))).to(torch.int32), 0, HISTO_LENGTH - 1
    )
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    hist.index_add_(0, bins, valid.to(torch.int32))
    # stable descending sort: ties go to the lowest bin, as lax.top_k
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    top_vals = top_vals.to(torch.float32)
    keep2 = top_vals[1] > 0.1 * top_vals[0]
    keep3 = top_vals[2] > 0.1 * top_vals[0]
    in_top = (
        (bins == top_idx[0]) | ((bins == top_idx[1]) & keep2) | ((bins == top_idx[2]) & keep3)
    )
    return valid & in_top


def resolve_duplicates(match_idx, dist, valid, m: int):
    """One query per train feature: scatter-min of (dist * n + row) keyed by
    train index; the winner keeps the slot."""
    n = match_idx.shape[0]
    sentinel = 2**31 - 1
    rows = torch.arange(n, dtype=torch.int32, device=dist.device)
    key = torch.where(valid, torch.clamp_max(dist, 256) * n + rows, sentinel)
    idx = match_idx.long()
    best_key = torch.full((m,), sentinel, dtype=torch.int32, device=dist.device)
    best_key.scatter_reduce_(0, idx, key, "amin", include_self=True)
    return valid & (key == best_key[idx])


def window_mask(query_uv, feat_xy, feat_level, feat_valid, radius, level_lo, level_hi):
    """(N,M) candidate mask: feature within +-radius of the query's predicted
    pixel (strict) and inside the octave band [level_lo, level_hi]."""
    r = radius[:, None]
    return (
        (torch.abs(query_uv[:, 0:1] - feat_xy[None, :, 0]) < r)
        & (torch.abs(query_uv[:, 1:2] - feat_xy[None, :, 1]) < r)
        & feat_valid[None, :]
        & (feat_level[None, :] >= level_lo[:, None])
        & (feat_level[None, :] <= level_hi[:, None])
    )


def search_by_window(desc_q, desc_t, mask, th: int = TH_LOW, ratio: float = 0.9):
    """Constrained matcher. Returns (idx (N,), dist (N,), valid (N,))."""
    idx, best, second = masked_best2(hamming_matrix(desc_q, desc_t), mask)
    return idx, best, ratio_test(best, second, th, ratio)


def search_for_initialization(feats_a, feats_b, window: float = 100.0, ratio: float = 0.9):
    """Monocular-initialization matching (SearchForInitialization,
    ORBmatcher.cc:735): level-0 features of frame A matched to level-0
    features of frame B inside a +-window pixel box, TH_LOW + ratio +
    rotation check + duplicate resolution. Returns (idx, dist, ok).

    The box search is the window match's function, so it runs through
    `window_match` (the Hopper kernel on CUDA tensors): rows of A that are
    not level 0 come in with radius -1, B's level-0 mask is the target
    valid flag, and the octave band [-1, BIG] passes every level."""
    from .window_match import window_match  # here: window_match imports this module

    n = feats_a.xy.shape[0]
    f32 = torch.float32
    lev0_a = feats_a.valid & (feats_a.level == 0)
    lev0_b = feats_b.valid & (feats_b.level == 0)
    dev = feats_a.xy.device
    idx, best, second = window_match(
        feats_a.desc, feats_a.xy,
        torch.where(lev0_a, window, -1.0).to(f32),
        torch.full((n,), -1.0, dtype=f32, device=dev),
        torch.full((n,), float(BIG), dtype=f32, device=dev),
        feats_b.desc, feats_b.xy, feats_b.level.to(f32), lev0_b.to(f32),
    )
    ok = ratio_test(best, second, TH_LOW, ratio)
    ok = rotation_consistency(feats_a.angle, feats_b.angle, idx, ok)
    ok = resolve_duplicates(idx, best, ok, feats_b.xy.shape[0])
    return idx, best, ok
