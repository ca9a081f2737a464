"""Per-level feature quotas.

Port of `level_quotas` from `orb_slam3_comments_ghr_tpu/frontend/select.py`.
"""

from __future__ import annotations


def level_quotas(n_features: int, n_levels: int = 8, scale: float = 1.2):
    """Geometric per-level feature quotas (ORBextractor.cc:474-541)."""
    inv = 1.0 / scale
    total = sum(inv**i for i in range(n_levels))
    quotas = [int(round(n_features * (inv**i) / total)) for i in range(n_levels)]
    # the last level absorbs the rounding drift, as the reference does
    quotas[-1] = max(1, n_features - sum(quotas[:-1]))
    return quotas
