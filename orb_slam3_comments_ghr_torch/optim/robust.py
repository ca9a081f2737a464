"""Robust kernels and chi-square gates.

Port of `orb_slam3_comments_ghr_tpu/optim/robust.py`: g2o's Huber kernel,
the 5.991 / 7.815 chi2 thresholds and the per-octave information ladder.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991       # 95% for 2 dof
CHI2_STEREO = 7.815     # 95% for 3 dof
SCALE_FACTOR = 1.2


def inv_level_sigma2(level: torch.Tensor, scale: float = SCALE_FACTOR) -> torch.Tensor:
    """Information weight 1/sigma^2 for a keypoint octave."""
    return torch.pow(scale, -2.0 * level.to(torch.float32))


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber IRLS weight of the squared error: 1 inside, delta/sqrt(chi2)
    outside."""
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)))


def huber_cost(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """rho(chi2): quadratic inside, linear outside."""
    delta = delta2**0.5
    return torch.where(
        chi2 <= delta2, chi2, 2.0 * delta * torch.sqrt(torch.clamp_min(chi2, 1e-12)) - delta2
    )
