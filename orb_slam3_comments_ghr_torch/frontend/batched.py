"""Batched ORB extraction over a padded pyramid.

Port of `extract_batched` and its helpers from
`orb_slam3_comments_ghr_tpu/frontend/batched.py`. All levels are padded to
the level-0 shape and stacked (L, H, W), so FAST, NMS and selection run once
over the stack; then one 54x54 patch per keypoint gives the IC angle, the
in-patch Gaussian blur and the rotation-binned rBRIEF bits.

Two departures from the JAX code, both giving the same values:
  * top-k becomes a stable descending sort, because `jax.lax.top_k` breaks
    ties by the lowest index and `torch.topk` does not (FAST scores on
    uint8 images tie often, and the `-arange*1e-6` tie-break of the final
    compaction is lost in f32 next to 1e6);
  * the two int8 matmuls against the +-1 pair-difference matrix (a TPU
    matrix-unit shape) become a gather of the 256 steered pairs of the
    keypoint's own rotation bin: bit = q[p2] > q[p1], with a pair clipped
    onto one pixel giving bit 0, as its all-zero matrix column did.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import brief, fast, pyramid, select
from .types import Features

PATCH_SIDE = 48  # covers rotated pattern offsets (|r| <= sqrt(2)*15 + round)
N_ROT_BINS = 30  # 12-degree steering steps
PATCH_IN = PATCH_SIDE + 6  # 48 + two 3-tap blur borders


def _padded_pyramid(img, n_levels, scale):
    """(L, H, W) stack, plus static per-level (h, w)."""
    levels = pyramid.build_pyramid(img, n_levels, scale)
    h, w = img.shape
    stack = [F.pad(lv, (0, w - lv.shape[1], 0, h - lv.shape[0])) for lv in levels]
    return torch.stack(stack), [tuple(lv.shape) for lv in levels]


def _bounds_mask(h, w, shapes, device=None):
    m = torch.zeros((len(shapes), h, w), dtype=torch.bool)
    for i, (hh, ww) in enumerate(shapes):
        m[i, :hh, :ww] = True
    return m.to(device)


def _top_desc(x, k):
    """Indices of the k largest along the last dim, ties to the lowest
    index (jax.lax.top_k order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _batched_select(resp, quotas, border, bucket=16):
    """Per-level spatially-balanced top-quota selection on (L, H, W)
    response maps; returns flattened (N,) x, y, level, response, valid
    (N = L * max(quotas), capped by the bucket count)."""
    L, h, w = resp.shape
    dev = resp.device
    row = torch.arange(h, device=dev)[None, :, None]
    col = torch.arange(w, device=dev)[None, None, :]
    inb = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    resp = torch.where(inb, resp, 0.0)

    gh, gw = -(-h // bucket), -(-w // bucket)
    rp = F.pad(resp, (0, gw * bucket - w, 0, gh * bucket - h))
    tiles = rp.reshape(L, gh, bucket, gw, bucket).permute(0, 1, 3, 2, 4).reshape(
        L, gh * gw, bucket * bucket
    )
    best_val = tiles.amax(-1)               # (L, G)
    best_idx = tiles.argmax(-1)             # first maximum, as jnp.argmax
    g = torch.arange(gh * gw, device=dev)
    y = (g // gw)[None] * bucket + best_idx // bucket
    x = (g % gw)[None] * bucket + best_idx % bucket

    # coarse-champion priority: each coarse tile's best bucket outranks every
    # non-champion (same construction as select.select_keypoints)
    kmax = max(quotas)
    c = max(1, math.ceil(math.sqrt(gh * gw / max(kmax, 1))))
    ch, cw = -(-gh // c), -(-gw // c)
    vpad = F.pad(
        best_val.reshape(L, gh, gw), (0, cw * c - gw, 0, ch * c - gh), value=-math.inf
    ).reshape(L, ch, c, cw, c)
    champ = vpad.amax(dim=(2, 4), keepdim=True)
    is_champ_t = (vpad >= champ) & (vpad > 0.0)
    flat = is_champ_t.permute(0, 1, 3, 2, 4).reshape(L, ch, cw, c * c)
    first = flat.to(torch.uint8).argmax(-1, keepdim=True)
    only_first = torch.zeros_like(flat).scatter_(-1, first, flat.any(-1, keepdim=True))
    is_champ = (
        only_first.reshape(L, ch, cw, c, c)
        .permute(0, 1, 3, 2, 4)
        .reshape(L, ch * c, cw * c)[:, :gh, :gw]
        .reshape(L, gh * gw)
    )
    priority = best_val + torch.where(is_champ, 1e12, 0.0)

    k = min(kmax, gh * gw)
    topi = _top_desc(priority, k)           # (L, k)
    topv = best_val.gather(1, topi)
    sel_x = x.gather(1, topi)
    sel_y = y.gather(1, topi)
    quota_arr = torch.tensor(quotas, device=dev)[:, None]
    valid = (topv > 0.0) & (torch.arange(k, device=dev)[None, :] < quota_arr)
    lvl = torch.arange(L, device=dev)[:, None].expand(L, k)
    return (
        sel_x.reshape(-1), sel_y.reshape(-1), lvl.reshape(-1),
        topv.reshape(-1), valid.reshape(-1),
    )


def _moment_kernels():
    """(31, 31) float32 x- and y-moment weights over the circular patch."""
    dy, dx = np.mgrid[-brief.HALF_PATCH : brief.HALF_PATCH + 1,
                      -brief.HALF_PATCH : brief.HALF_PATCH + 1]
    mask = (dx * dx + dy * dy) <= brief.HALF_PATCH * brief.HALF_PATCH
    return (torch.from_numpy((dx * mask).astype(np.float32)),
            torch.from_numpy((dy * mask).astype(np.float32)))


def _rotation_tables() -> np.ndarray:
    """(B, 512) flat indices into a PATCH_SIDE^2 patch: for each rotation
    bin, the 2x256 rotated pattern sample positions (p1 then p2)."""
    out = []
    half = PATCH_SIDE // 2
    pat = brief.PATTERN.numpy()
    for b in range(N_ROT_BINS):
        a = 2 * np.pi * b / N_ROT_BINS
        ca, sa = np.cos(a), np.sin(a)
        idx = []
        for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
            rx = np.round(ca * px - sa * py).astype(np.int64) + half
            ry = np.round(sa * px + ca * py).astype(np.int64) + half
            idx.append(np.clip(ry, 0, PATCH_SIDE - 1) * PATCH_SIDE + np.clip(rx, 0, PATCH_SIDE - 1))
        out.append(np.concatenate(idx))
    return np.stack(out)


def _blur_valid() -> torch.Tensor:
    """(PATCH_SIDE, PATCH_IN) 'valid' 7-tap sigma=2 Gaussian band: row i of
    the blurred 48-patch from rows [i, i+6] of the 54-patch."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k /= k.sum()
    M = np.zeros((PATCH_SIDE, PATCH_IN), np.float32)
    for i in range(PATCH_SIDE):
        M[i, i : i + 7] = k
    return torch.from_numpy(M)


@functools.lru_cache(maxsize=None)
def _tables(device):
    """The static tables on `device`: moment weights (961, 2), blur band,
    rotation index table. Cached: callers must not write to them."""
    kx, ky = _moment_kernels()
    kmat = torch.stack([kx.reshape(-1), ky.reshape(-1)], dim=1)
    return (kmat.to(device), _blur_valid().to(device),
            torch.from_numpy(_rotation_tables()).to(device))


def _per_keypoint_stages(P, xs, ys, lvls):
    """Orientation + blur + descriptors from one 54x54 patch per keypoint of
    the unblurred (L, H, W) stack. Returns (angles (n,), desc (n, 8) int32)."""
    half_in = PATCH_IN // 2
    n = xs.shape[0]
    kmat, blur, rot_tab = _tables(P.device)
    padded = F.pad(P, (half_in, half_in, half_in, half_in))
    L, Hp, Wp = padded.shape
    # one index-grid gather in place of the vmapped dynamic_slice; the
    # starts are in range by construction, so no clamping is needed
    r = torch.arange(PATCH_IN, device=P.device)
    offs = (r[:, None] * Wp + r[None, :]).reshape(-1)
    start = (lvls.long() * Hp + ys.long()) * Wp + xs.long()
    patches = padded.reshape(-1)[start[:, None] + offs[None, :]].reshape(n, PATCH_IN, PATCH_IN)

    # IC angle from the central 31x31 of the unblurred patch
    S = 2 * brief.HALF_PATCH + 1
    off = half_in - brief.HALF_PATCH
    m = patches[:, off : off + S, off : off + S].reshape(n, S * S) @ kmat
    angles = torch.atan2(m[:, 1], m[:, 0])

    # in-patch separable blur: (48,54) @ (n,54,54) @ (54,48), quantised to
    # integers as the reference's uint8 GaussianBlur output
    blurred = (blur @ patches @ blur.T).reshape(n, PATCH_SIDE * PATCH_SIDE)
    q = torch.clamp(torch.round(blurred), 0, 255).to(torch.int32)

    # round() is half-to-even and remainder() Python's modulo, as in jnp
    bidx = torch.remainder(
        torch.round(angles / (2 * math.pi) * N_ROT_BINS).to(torch.int32), N_ROT_BINS
    )
    samples = q.gather(1, rot_tab[bidx.long()])            # (n, 512)
    bits = (samples[:, 256:] > samples[:, :256]).to(torch.int64).reshape(n, 8, 32)
    words = torch.sum(bits << torch.arange(32, device=P.device), dim=-1)
    desc = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return angles, desc


def extract_batched(
    img: torch.Tensor,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> Features:
    """ORB features of a (H, W) grayscale image, on the image's device."""
    if img.ndim != 2:
        raise ValueError(
            f"extract() wants a (H, W) grayscale image, got shape {tuple(img.shape)}; "
            "convert RGB with e.g. img.mean(-1) before calling"
        )
    if min(img.shape) < 31 * 2:
        raise ValueError(
            f"extract() needs images of at least 62px per side (patch 31 + "
            f"borders); got {tuple(img.shape)}"
        )
    img = img.to(torch.float32)
    dev = img.device
    h, w = img.shape
    P, shapes = _padded_pyramid(img, n_levels, scale)
    usable = [i for i, (hh, ww) in enumerate(shapes) if min(hh, ww) >= 35]
    quotas = select.level_quotas(n_features, n_levels, scale)
    if len(usable) < n_levels:
        dropped = sum(quotas[i] for i in range(n_levels) if i not in usable)
        quotas = [q if i in usable else 0 for i, q in enumerate(quotas)]
        quotas[usable[-1]] += dropped

    resp = fast.dual_threshold_response(P, ini_th, min_th)
    # kill responses in the padded region AND within 19px of level borders
    hb = torch.tensor([s[0] for s in shapes], device=dev)[:, None, None]
    wb = torch.tensor([s[1] for s in shapes], device=dev)[:, None, None]
    row = torch.arange(h, device=dev)[None, :, None]
    col = torch.arange(w, device=dev)[None, None, :]
    inb = (row >= 19) & (row < hb - 19) & (col >= 19) & (col < wb - 19)
    resp = torch.where(inb & _bounds_mask(h, w, shapes, dev), resp, 0.0)

    xs, ys, lvls, rs, valid = _batched_select(resp, quotas, border=0)

    # compact to exactly n_features before the per-keypoint stages
    n_cand = xs.shape[0]
    pri = torch.where(valid, 1e6 + rs, 0.0) - torch.arange(n_cand, dtype=torch.float32, device=dev) * 1e-6
    order = _top_desc(pri, n_features)
    xs, ys, lvls, rs, valid = xs[order], ys[order], lvls[order], rs[order], valid[order]

    angles, desc = _per_keypoint_stages(P, xs, ys, lvls)

    sfac = torch.tensor([scale**i for i in range(n_levels)], dtype=torch.float32, device=dev)[lvls]
    xy = torch.stack([xs.to(torch.float32) * sfac, ys.to(torch.float32) * sfac], dim=-1)
    return Features(
        xy=xy,
        level=lvls.to(torch.int32),
        angle=angles,
        response=torch.where(valid, rs, -math.inf),
        desc=desc,
        valid=valid,
        u_right=torch.full((n_features,), -1.0, device=dev),
        depth=torch.full((n_features,), -1.0, device=dev),
    )
