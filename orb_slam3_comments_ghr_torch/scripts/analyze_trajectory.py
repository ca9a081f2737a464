"""Segment-wise trajectory error for GT-replay triage: the port of
`scripts/analyze_trajectory.py`.

Aligns an estimated TUM trajectory to a EuRoC ground truth with Horn
(`utils/evaluation.horn_align`, optionally with scale), then reports the
RMSE and the worst error over fixed time windows: where a sequence's error
concentrates (drift, one bad segment, or uniform noise). The reference's
`evaluate_ate_scale.py` gives one scalar; its authors read the aligned plot
for the same purpose (evaluation/evaluate_ate_scale.py:118).

    python -m orb_slam3_comments_ghr_torch.scripts.analyze_trajectory --seq V202 \\
        --tum out.tum [--segments 20] [--scale]

The ground truth is `{seq}_GT.txt` in the folder that `EUROC_GT_DIR`
names. Host numpy only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _quat_to_R(q):
    """(qx, qy, qz, qw) -> 3x3."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _read_tum(path: str) -> list:
    """(t, T_cw 4x4) per TUM row (which stores T_wc)."""
    est = []
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        v = [float(x) for x in line.split()]
        Rwc = _quat_to_R(v[4:8])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ np.array(v[1:4])
        est.append((v[0], T))
    return est


def analyze(seq: str, tum: str, segments: int = 20, scale: bool = False) -> dict:
    """Per-frame aligned errors and their segments: {"matched", "estimated",
    "ts" (s), "err" (m), "rmse", "median", "max", "segments": [(start s,
    end s, rmse, max, n), ...]} (times from the first matched frame)."""
    from ..utils import evaluation, gt_replay

    times, R_cw, t_cw, _, _ = gt_replay.load_euroc_gt(seq)
    gt = {}
    for i in range(len(times)):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_cw[i]
        T[:3, 3] = t_cw[i]
        gt[round(float(times[i]), 4)] = T
    est = _read_tum(tum)
    pairs = [(t, T, gt[round(t, 4)]) for t, T in est if round(t, 4) in gt]
    if len(pairs) < 10:
        # nearest-neighbour association within 0.02 s
        gtt = np.array(sorted(gt.keys()))
        pairs = []
        for t, T in est:
            j = np.searchsorted(gtt, t)
            for c in (j - 1, j):
                if 0 <= c < len(gtt) and abs(gtt[c] - t) <= 0.02:
                    pairs.append((t, T, gt[gtt[c]]))
                    break
    P_est = np.array([np.linalg.inv(T)[:3, 3] for _, T, _ in pairs])
    P_gt = np.array([np.linalg.inv(G)[:3, 3] for _, _, G in pairs])
    ts = np.array([t for t, _, _ in pairs])
    s, R, t0, _ = evaluation.horn_align(P_est, P_gt, with_scale=scale)
    err = np.linalg.norm(s * (P_est @ R.T) + t0 - P_gt, axis=1)
    edges = np.linspace(ts[0], ts[-1], segments + 1)
    segs = []
    for i in range(segments):
        m = (ts >= edges[i]) & (ts < edges[i + 1])
        if m.sum() < 2:
            continue
        e = err[m]
        segs.append((edges[i] - ts[0], edges[i + 1] - ts[0], float(np.sqrt((e ** 2).mean())),
                     float(e.max()), int(m.sum())))
    return {"matched": len(pairs), "estimated": len(est), "ts": ts, "err": err,
            "rmse": float(np.sqrt((err ** 2).mean())), "median": float(np.median(err)),
            "max": float(err.max()), "segments": segs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", required=True)
    ap.add_argument("--tum", required=True)
    ap.add_argument("--segments", type=int, default=20)
    ap.add_argument("--scale", action="store_true")
    args = ap.parse_args(argv)

    r = analyze(args.seq, args.tum, args.segments, args.scale)
    print(f"matched {r['matched']} / {r['estimated']} est frames to GT")
    print(f"overall RMSE {r['rmse']*100:.2f} cm  median {r['median']*100:.2f}  "
          f"max {r['max']*100:.2f}")
    for a, b, rmse, mx, n in r["segments"]:
        print(f"  [{a:6.1f}-{b:6.1f}s] rmse {rmse*100:6.2f} cm  max {mx*100:6.2f}  n={n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
