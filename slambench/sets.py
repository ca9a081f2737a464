"""Run one cell several times, one process after another, and print each
metric's median and spread.

    python -m slambench.sets --workload <name> --seeds 11 12 13 [--seconds S]
        [--trace 0|1] [--control 0|1] [--out runs.jsonl]

Each run is `python -m slambench.run` in a process of its own (as the
benchmark's checks run it), with `--seconds` the `run_seconds` of
BENCHMARK.json unless given. Every result line goes to `--out` with its
seed and exit code; then, per metric and per compared number, the values,
the median, and the spread: the distance between the first and the third
quartile (`statistics.quantiles(values, n=4)`) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, "-m", "slambench.run", "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(seconds), "--trace", str(args.trace), "--control",
               str(args.control)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t0
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
        try:
            res = json.loads(line)
        except json.JSONDecodeError:
            res = {}
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": res,
               "stderr_tail": proc.stderr[-1500:]}
        rows.append(row)
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in res.get("checks", {}).items()},
                          "events": res.get("events"), "window": res.get("window")}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    values = {}
    for row in rows:
        for group in ("metrics", "checks"):
            for k, v in row["result"].get(group, {}).items():
                values.setdefault(f"{group}.{k}", []).append(v["value"])
    for k, v in values.items():
        print(f"{k}: median {statistics.median(v)!r} spread {spread(v)!r} values {v}")
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
