"""rBRIEF sampling pattern.

Port of the constants of `orb_slam3_comments_ghr_tpu/frontend/brief.py`.
`PATTERN` is regenerated by the same recipe (256 point pairs from an
isotropic Gaussian, sigma = patch/5, rounded and clipped, seed 1234), so it
equals the JAX package's table.
"""

from __future__ import annotations

import numpy as np
import torch

PATCH_SIZE = 31
HALF_PATCH = 15
N_BITS = 256


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32: (x1, y1, x2, y2) sample offsets."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(N_BITS, 4) * (PATCH_SIZE / 5.0)
    pts = np.clip(np.round(pts), -HALF_PATCH + 2, HALF_PATCH - 2)
    return pts.astype(np.int32)


PATTERN = torch.from_numpy(_make_pattern())  # (256, 4) int32
