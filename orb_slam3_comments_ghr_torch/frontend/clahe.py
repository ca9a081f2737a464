"""Contrast-limited adaptive histogram equalization (CLAHE).

Port of `orb_slam3_comments_ghr_tpu/frontend/clahe.py`. The reference's
ROS drivers equalize every frame with cv::createCLAHE(clipLimit=3.0,
tileGrid=8x8) before tracking (ros_stereo_inertial.cc:68-69,102-120): per
tile a histogram, clipped and redistributed, whose CDF is the tile's lookup
table; each pixel blends the tables of its 4 nearest tiles bilinearly. A
tensor function: it runs on the device of `img`.
"""

from __future__ import annotations

import torch


def clahe(img: torch.Tensor, tiles: int = 8, clip_limit: float = 3.0,
          n_bins: int = 256) -> torch.Tensor:
    """img: (H, W) in [0, 255]. Returns the equalized float32 (H, W)."""
    h, w = img.shape
    dev = img.device
    th = -(-h // tiles)
    tw = -(-w // tiles)
    # pad to whole tiles by repeating the last row and column
    ky = torch.arange(th * tiles, device=dev)
    kx = torch.arange(tw * tiles, device=dev)
    padded = img.to(torch.float32)[torch.clamp_max(ky, h - 1)[:, None], torch.clamp_max(kx, w - 1)]

    bins = torch.clamp(padded.to(torch.int32), 0, n_bins - 1).long()
    tile_id = (ky // th)[:, None] * tiles + (kx // tw)[None, :]
    hist = torch.bincount((tile_id * n_bins + bins).reshape(-1),
                          minlength=tiles * tiles * n_bins)
    hist = hist.to(torch.float32).reshape(tiles * tiles, n_bins)

    # clip and redistribute (OpenCV: limit = clipLimit * area / bins)
    area = float(th * tw)
    limit = max(clip_limit * area / n_bins, 1.0)
    excess = torch.sum(torch.clamp_min(hist - limit, 0.0), dim=1, keepdim=True)
    hist = torch.clamp_max(hist, limit) + excess / n_bins
    lut = (torch.cumsum(hist, dim=1) * ((n_bins - 1) / area)).reshape(-1)

    # bilinear blend of the 4 neighbouring tiles' tables, each at the
    # pixel's own bin
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy), 0, tiles - 1).long()
    x0 = torch.clamp(torch.floor(xx), 0, tiles - 1).long()
    y1 = torch.clamp_max(y0 + 1, tiles - 1)
    x1 = torch.clamp_max(x0 + 1, tiles - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    b = bins[:h, :w]

    def at(tyi, txi):
        return lut[(tyi[:, None] * tiles + txi[None, :]) * n_bins + b]

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy
