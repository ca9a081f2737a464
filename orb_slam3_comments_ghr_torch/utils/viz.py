"""Offline visualization: frame overlays and map renders to PNG.

Headless replacement for the reference's Pangolin Viewer stack
(src/Viewer.cc, src/FrameDrawer.cc current-frame overlay with keypoints and
state text, src/MapDrawer.cc GL map/keyframe/covisibility rendering). TPU
hosts have no GL; these render with numpy + PIL and are driven per-frame or
post-hoc (see io.run_slam --viz).

Port of `orb_slam3_comments_ghr_tpu/utils/viz.py`: host code over the map's
numpy arrays; features may be tensors on any device (copied to the host
here)."""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def draw_frame(img: np.ndarray, feats=None, tracked_mask=None, state: str = "",
               path: str | None = None) -> np.ndarray:
    """FrameDrawer::DrawFrame equivalent: green squares on tracked keypoints,
    blue on untracked, state banner. Returns an RGB uint8 array."""
    from PIL import Image, ImageDraw

    g = np.clip(_host(img), 0, 255).astype(np.uint8)
    rgb = Image.fromarray(np.stack([g, g, g], -1))
    d = ImageDraw.Draw(rgb)
    if feats is not None:
        xy = _host(feats.xy)
        valid = _host(feats.valid)
        tm = (
            _host(tracked_mask)
            if tracked_mask is not None
            else np.zeros(len(xy), bool)
        )
        for i in np.nonzero(valid)[0]:
            x, y = float(xy[i, 0]), float(xy[i, 1])
            color = (0, 220, 0) if tm[i] else (70, 70, 255)
            d.rectangle([x - 2, y - 2, x + 2, y + 2], outline=color)
    if state:
        d.text((8, 8), state, fill=(255, 220, 0))
    out = np.asarray(rgb)
    if path:
        rgb.save(path)
    return out


def draw_map(map_state, path: str | None = None, size: int = 800,
             axis=(0, 2)) -> np.ndarray:
    """MapDrawer equivalent: top-down orthographic render of map points
    (black), keyframes (blue frusta dots), covisibility edges (gray), and
    the spanning tree (green)."""
    from PIL import Image, ImageDraw

    m = map_state
    mps = m.mp_ids()
    kfs = m.kf_ids()
    img = Image.new("RGB", (size, size), (255, 255, 255))
    d = ImageDraw.Draw(img)
    if len(mps) == 0:
        if path:
            img.save(path)
        return np.asarray(img)

    pts = m.mp_pos[mps][:, axis]
    centers = np.stack(
        [-m.kf_R[k].T @ m.kf_t[k] for k in kfs]
    )[:, axis] if len(kfs) else np.zeros((0, 2))
    allp = np.concatenate([pts, centers], axis=0)
    lo = np.percentile(allp, 2, axis=0)
    hi = np.percentile(allp, 98, axis=0)
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        q = (p - lo) / span * (size * 0.9) + size * 0.05
        return float(q[0]), float(size - q[1])

    for p in pts:
        x, y = to_px(p)
        if 0 <= x < size and 0 <= y < size:
            d.point((x, y), fill=(60, 60, 60))
    # covisibility edges + spanning tree
    kf_list = list(map(int, kfs))
    for k in kf_list:
        cx = to_px(centers[kf_list.index(k)])
        p_ = int(m.kf_parent[k])
        if p_ >= 0 and p_ in kf_list:
            d.line([cx, to_px(centers[kf_list.index(p_)])], fill=(0, 180, 0))
    for i, k in enumerate(kf_list):
        x, y = to_px(centers[i])
        d.ellipse([x - 3, y - 3, x + 3, y + 3], fill=(40, 40, 255))
    if path:
        img.save(path)
    return np.asarray(img)
