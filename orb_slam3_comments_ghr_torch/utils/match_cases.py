"""Inputs for checking the window match: random problems and the edge cases
that the kernel's grid of cells must not break.

Each builder returns numpy arrays in `ops.window_match.window_match`'s
argument order: qdesc (N,8) int32, q_uv (N,2), q_radius, q_lvl_lo,
q_lvl_hi (N,) float32, tdesc (M,8) int32, t_xy (M,2), t_level, t_valid
(M,) float32. `tests/test_torch_window_match.py` holds them against the JAX
package and the plain version; `chip_smoke.py` phase 1 holds the kernel
against the plain version on the card.
"""

from __future__ import annotations

import numpy as np

# JAX's window match (Pallas or XLA) takes these
EDGE_CASES = ("outside", "on_edge", "ties", "huge_r", "half_px", "one_row", "m777")
# checked against the definition: non-finite coordinates, no target at all
PLAIN_ONLY = ("nan_target", "inf_target", "nan_query", "no_targets")
# sizes worth running on the card only: M over one shared-memory stage of
# the kernel, and enough rows that each warp owns several
CARD_ONLY = ("chunks", "many_rows")
ALL_CASES = EDGE_CASES + PLAIN_ONLY + CARD_ONLY


def random_problem(seed: int, n: int, m: int, radius: float):
    """The recipe of the JAX package's tests/test_pallas_match.py: random
    descriptors, pixels in [0, 600), radius `radius`, octave bands of width
    2, 10 % of the targets invalid."""
    rng = np.random.default_rng(seed)
    qd = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    td = rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32)
    quv = rng.random((n, 2), np.float32) * np.float32(600)
    txy = rng.random((m, 2), np.float32) * np.float32(600)
    qrad = np.full((n,), radius, np.float32)
    qlo = rng.integers(0, 3, n).astype(np.float32)
    qhi = qlo + 2
    tlvl = rng.integers(0, 8, m).astype(np.float32)
    tval = (rng.random(m) > 0.1).astype(np.float32)
    return qd, quv, qrad, qlo, qhi, td, txy, tlvl, tval


def edge_problem(case: str):
    """One of ALL_CASES, from a seed of its own."""
    seed = 20 + ALL_CASES.index(case)
    n, m = {"one_row": (1, 300), "m777": (128, 777), "no_targets": (128, 0),
            "chunks": (512, 5000), "many_rows": (40000, 1024)}.get(case, (128, 300))
    radius = {"on_edge": 8.0, "huge_r": 1e30, "half_px": 0.5, "nan_target": 300.0,
              "inf_target": 1e30, "many_rows": 15.0}.get(case, 80.0)
    qd, quv, qrad, qlo, qhi, td, txy, tlvl, tval = random_problem(seed, n, m, radius)
    rng = np.random.default_rng(seed + 1000)
    if case == "outside":  # targets off the image, at negative coordinates too
        txy = (rng.random((m, 2), np.float32) * 1200 - 300).astype(np.float32)
    elif case == "on_edge":  # |du| or |dv| exactly r: never a candidate
        quv = (rng.integers(0, 1200, (n, 2)) / 2).astype(np.float32)
        off = rng.choice(np.array([-8.0, -7.5, 0.0, 7.5, 8.0], np.float32), (m, 2))
        txy = (quv[rng.integers(0, n, m)] + off).astype(np.float32)
    elif case == "ties":  # one descriptor for every target: every distance ties
        td[:] = td[0]
    elif case == "half_px":  # half of the targets within a pixel of a query
        near = quv[rng.integers(0, n, m // 2)] + rng.uniform(-0.6, 0.6, (m // 2, 2))
        txy[: m // 2] = near.astype(np.float32)
    elif case == "nan_target":
        txy[::7, 0] = np.nan
        txy[3::11, 1] = np.nan
    elif case == "inf_target":
        txy[::5, 0] = np.inf
        txy[1::9, 1] = -np.inf
        qrad[::4] = np.inf
    elif case == "nan_query":
        quv[::3, 0] = np.nan
        quv[1::5, 1] = np.inf
        qrad[2::7] = np.nan
    return qd, quv, qrad, qlo, qhi, td, txy, tlvl, tval
