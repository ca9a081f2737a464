"""Image pyramid.

Port of `level_shapes`, `_interp_matrix` and `build_pyramid` from
`orb_slam3_comments_ghr_tpu/frontend/pyramid.py`: each level is resampled
from the previous one by two dense interpolation matrices holding the
antialiased triangle weights of `jax.image.resize(method="linear")` (not
`F.interpolate`, whose weights differ when downsampling).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_N_LEVELS = 8
DEFAULT_SCALE = 1.2


def level_shapes(h: int, w: int, n_levels: int = DEFAULT_N_LEVELS, scale: float = DEFAULT_SCALE):
    """Static per-level (h, w) list."""
    out = []
    for lv in range(n_levels):
        f = 1.0 / (scale**lv)
        out.append((max(8, int(round(h * f))), max(8, int(round(w * f)))))
    return out


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_out: int, n_in: int, device="cpu") -> torch.Tensor:
    """(n_out, n_in) float32 resampling matrix with half-pixel centers, built
    in float64 and cast, as the JAX package builds it. Cached per device:
    callers must not write to it."""
    scale = n_out / n_in
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    # antialiased triangle kernel, support widened by 1/scale when downsampling
    M = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) * min(scale, 1.0))
    M /= M.sum(axis=1, keepdims=True)
    return torch.from_numpy(M.astype(np.float32)).to(device)


def build_pyramid(img: torch.Tensor, n_levels: int = DEFAULT_N_LEVELS, scale: float = DEFAULT_SCALE):
    """List of n_levels (h, w) float32 tensors, level 0 = input; each level
    resampled from the previous as A_rows @ img @ A_cols^T."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    cur = img
    for lv in range(1, n_levels):
        h_in, w_in = cur.shape
        h_out, w_out = shapes[lv]
        cur = _interp_matrix(h_out, h_in, img.device) @ cur @ _interp_matrix(w_out, w_in, img.device).T
        levels.append(cur)
    return levels
