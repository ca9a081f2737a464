"""Compare two keyframe-state dumps of `scripts/vi_slam_cpu.py --dump`
(for example the JAX package's and the port's on the same sequence), call
by call of `process_keyframe`.

    python scripts/vi_slam_diff.py A.npz B.npz [--rel 1e-4]

Prints, for each call, the keyframe processed in each run and, over the
keyframes live in both, the largest camera-centre difference (m), rotation
difference (rad), velocity difference (m/s) and bias difference, and names
the first call where a difference exceeds `--rel` relative to the size of
the quantity (centres against the largest distance from the first
keyframe).
"""

import argparse
import sys

import numpy as np


def load(path):
    z = np.load(path)
    n = 1 + max(int(k.split("_")[0]) for k in z.files)
    return [{k: z[f"{j}_{k}"] for k in ("kf", "ids", "R", "t", "vel", "bias")} for j in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rel", type=float, default=1e-4)
    args = ap.parse_args(argv)
    a, b = load(args.a), load(args.b)
    first = None
    for j, (x, y) in enumerate(zip(a, b)):
        common, ia, ib = np.intersect1d(x["ids"], y["ids"], return_indices=True)
        centre = lambda d, i: -np.einsum("kji,kj->ki", d["R"][i].astype(np.float64),
                                         d["t"][i].astype(np.float64))
        ca, cb = centre(x, ia), centre(y, ib)
        extent = max(np.linalg.norm(ca - ca[:1], axis=1).max(), 1e-6)
        dc = np.linalg.norm(ca - cb, axis=1).max()
        dR = np.abs(x["R"][ia] - y["R"][ib]).max()
        dv = np.abs(x["vel"][ia] - y["vel"][ib]).max()
        vmax = max(np.abs(x["vel"][ia]).max(), 1e-6)
        db = np.abs(x["bias"][ia] - y["bias"][ib]).max()
        print(f"call {j}: kf {int(x['kf'])} / {int(y['kf'])}, {len(common)} common keyframes, "
              f"centre {dc:.3e} m (extent {extent:.3f}), R {dR:.3e}, vel {dv:.3e} "
              f"(max {vmax:.3f}), bias {db:.3e}")
        if first is None and (int(x["kf"]) != int(y["kf"]) or dc > args.rel * extent
                              or dR > args.rel or dv > args.rel * vmax):
            first = j
    print(f"first call past {args.rel:g} relative: {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
