"""Rectified stereo feature matching, and RGB-D virtual stereo.

Port of `orb_slam3_comments_ghr_tpu/frontend/stereo.py`
(Frame::ComputeStereoMatches, reference src/Frame.cc:1117-1370; and
Frame::ComputeStereoFromRGBD, Frame.cc:1376). The row band and disparity
range are a dense mask over the (left, right) feature pairs, the coarse
match is one masked Hamming top-2, and the sub-pixel refinement is a
parabola over the 11x11 SAD of level-0 patches swept over +-5 px.

The function is the reference's, fault included: its median-deviation pass
(Frame.cc:1340-1365) takes the median over every left slot, with NaN for
the ones that did not match. That median is NaN whenever one slot did not
match, falls back to TH_STEREO, and then keeps every match. So the pass
acts only on a frame where every slot matched. `torch.quantile(x, 0.5)`
propagates NaN and averages the two middle values, as `jnp.median` does;
`torch.median` (lower middle) and `torch.nanmedian` (skips NaN) would not.
"""

from __future__ import annotations

import torch

from ..ops import cameras, matching
from .types import Features

TH_STEREO = (matching.TH_HIGH + matching.TH_LOW) // 2  # 75
W = 5  # SAD half window: 11x11 patches, swept over -W..W pixels


def _patches(img: torch.Tensor, xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """(..., 11, 11) patches of img whose top-left corners are (int(xc) - W,
    int(yc) - W), clamped into the image: one gather of clamped indices."""
    h, w = img.shape
    x0 = torch.clamp(xc.to(torch.int32) - W, 0, w - (2 * W + 1)).long()
    y0 = torch.clamp(yc.to(torch.int32) - W, 0, h - (2 * W + 1)).long()
    k = torch.arange(2 * W + 1, device=img.device)
    rows = y0[..., None, None] + k[:, None]
    cols = x0[..., None, None] + k
    return img[rows, cols]


def stereo_match(cam: cameras.Camera, feats_l: Features, feats_r: Features,
                 img_l: torch.Tensor, img_r: torch.Tensor, scale: float = 1.2):
    """(u_right (N,), depth (N,)) of the left features, -1 where unmatched.
    img_l / img_r are the level-0 grayscale images as float32."""
    min_d = 0.0
    max_d = cam.bf / max(cam.baseline, 1e-6)

    # row band |vR - vL| <= 2 scale^octave(L), disparity in [-2, max_d],
    # octaves at most 1 apart
    band = 2.0 * torch.pow(scale, feats_l.level.to(torch.float32))
    dv = torch.abs(feats_l.xy[:, 1:2] - feats_r.xy[None, :, 1])
    disp = feats_l.xy[:, 0:1] - feats_r.xy[None, :, 0]
    level_ok = torch.abs(feats_l.level[:, None] - feats_r.level[None, :]) <= 1
    mask = ((dv <= band[:, None]) & (disp >= min_d - 2.0) & (disp <= max_d)
            & feats_l.valid[:, None] & feats_r.valid[None, :] & level_ok)
    idx, dist, ok = matching.search_by_window(feats_l.desc, feats_r.desc, mask,
                                              th=TH_STEREO, ratio=1.0)

    # SAD over 11x11 patches at the 11 offsets -5..5 of the right match
    xl, yl = feats_l.xy[:, 0], feats_l.xy[:, 1]
    xr0 = feats_r.xy[idx.long(), 0]
    offsets = torch.arange(-W, W + 1, device=xl.device).to(torch.float32)
    pl = _patches(img_l, xl, yl)                                    # (N,11,11)
    pr = _patches(img_r, xr0[None, :] + offsets[:, None], yl[None, :].expand(2 * W + 1, -1))
    sads = torch.sum(torch.abs(pl[None] - pr), dim=(-2, -1))         # (11,N)
    best_off = torch.argmin(sads, dim=0)
    col = torch.arange(xl.shape[0], device=xl.device)
    c0 = sads[torch.clamp(best_off - 1, 0, 2 * W), col]
    c1 = sads[best_off, col]
    c2 = sads[torch.clamp(best_off + 1, 0, 2 * W), col]
    denom = torch.clamp_min(c0 + c2 - 2 * c1, 1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    interior = (best_off > 0) & (best_off < 2 * W)
    delta = torch.where(interior, delta, 0.0)
    u_r = xr0 + (best_off - W).to(torch.float32) + delta

    disparity = xl - u_r
    ok = ok & (disparity > min_d) & (disparity < max_d)

    # median-deviation pass on the accepted Hamming distances (see the
    # module note: NaN, and so off, unless every slot matched)
    distf = dist.to(torch.float32)
    med = torch.quantile(torch.where(ok, distf, torch.nan), 0.5)
    med = torch.nan_to_num(med, nan=float(TH_STEREO))
    ok = ok & (distf <= 1.5 * 1.4 * med)

    depth = cam.bf / torch.clamp_min(disparity, 1e-6)
    return torch.where(ok, u_r, -1.0), torch.where(ok, depth, -1.0)


def depth_to_stereo(cam: cameras.Camera, feats: Features, depth_map: torch.Tensor):
    """RGB-D: (u_right, depth) of each feature from the depth image at its
    truncated pixel, -1 where the depth is not positive."""
    xy = feats.xy.to(torch.int32)
    x = torch.clamp(xy[:, 0], 0, depth_map.shape[1] - 1).long()
    y = torch.clamp(xy[:, 1], 0, depth_map.shape[0] - 1).long()
    d = depth_map[y, x]
    ok = feats.valid & (d > 0)
    u_right = torch.where(ok, feats.xy[:, 0] - cam.bf / torch.clamp_min(d, 1e-6), -1.0)
    return u_right, torch.where(ok, d, -1.0)
