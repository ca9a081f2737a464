"""Time the window-match kernel on a CUDA card, on the arguments of recorded
calls (one per caller: tracking, two-view init and fuse of monocular SLAM,
tracking and fuse of stereo and of RGB-D SLAM).

    python3 chip_smoke.py --save-caller-inputs callers.pt
    python3 orb_slam3_comments_ghr_torch/utils/time_window_match.py \\
        --inputs callers.pt [--tree DIR]

`--tree` names the directory that holds the `orb_slam3_comments_ghr_torch`
package to time (default: this checkout), so an earlier version of the
package, unpacked with `git archive`, is timed the same way; run the two in
turns (old, new, new, old) on one card. For each caller the script checks
the kernel against the plain version, then prints one JSON line of times:

- `device_ms`: device time per launch, from a CUDA graph of 100 launches,
  replayed and timed with CUDA events (no host time inside);
- `wrapper_ms`: CUDA events around 100 back-to-back eager calls, per call:
  the wrapper's host work and the kernel, whichever is longer;
- `enqueue_us`: host clock over 1000 eager calls with no sync inside, per
  call: what the wrapper costs the calling thread;
- `empty_ms`: as `device_ms`, on the same arguments with every radius set
  to -1, so that no row searches: what a launch costs before any target is
  read (for a kernel that skips empty rows);
- `plain_ms`: the plain PyTorch version, CUDA events over 10 calls.

`chip_smoke.py` uses the same timers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device milliseconds per call of fn(): `launches` calls captured in a
    CUDA graph, replayed `replays` times, each replay timed with CUDA events;
    the median replay over `launches`."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def events_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Milliseconds per call of fn(), CUDA events around `calls` eager calls
    back to back; the median of `reps` such runs, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def enqueue_us(fn, calls: int = 1000, reps: int = 3) -> float:
    """Host microseconds per call of fn(), host clock over `calls` calls
    with no sync inside (the device runs behind); the median of `reps`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def agrees_with_plain(out, plain, qdesc, tdesc, big: int) -> bool:
    """best and second bit-equal; idx equal, or where it differs, at a
    column whose distance equals best (a tie); idx 0 on empty rows."""
    idx, best, second = (x.long() for x in out)
    idx_p, best_p, second_p = (x.long() for x in plain)
    if not (torch.equal(best, best_p) and torch.equal(second, second_p)):
        return False
    hit = best < big
    if bool((idx[~hit] != 0).any()):
        return False
    rows = torch.nonzero(hit & (idx != idx_p))[:, 0]
    if rows.numel() == 0:
        return True
    # distances of the differing columns, recomputed from the descriptors
    x = (qdesc[rows] ^ tdesc[idx[rows]]).to(torch.int64) & 0xFFFFFFFF
    d = sum(((x >> b) & 1) for b in range(32)).sum(-1)
    return torch.equal(d, best[rows])


def time_caller(wm_module, args) -> dict:
    """The five times of one caller's recorded arguments (on the card)."""
    empty_args = args[:2] + (torch.full_like(args[2], -1.0),) + args[3:]

    def kernel():
        return wm_module.window_match(*args)

    def plain():
        return wm_module.window_match_plain(*args)

    return {"device_ms": graph_ms(kernel), "wrapper_ms": events_ms(kernel),
            "enqueue_us": enqueue_us(kernel),
            "empty_ms": graph_ms(lambda: wm_module.window_match(*empty_args)),
            "plain_ms": events_ms(plain, calls=10, reps=3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True, help="file written by chip_smoke.py "
                    "--save-caller-inputs")
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the orb_slam3_comments_ghr_torch package to time")
    ap.add_argument("--label", default="", help="name of this tree in the JSON line")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(opts.tree).resolve()))
    from orb_slam3_comments_ghr_torch.ops import window_match as wm_module

    lib = wm_module.build()
    recorded = torch.load(opts.inputs)
    device = torch.device("cuda", 0)
    result = {"label": opts.label, "tree": opts.tree, "library": lib.name,
              "card": torch.cuda.get_device_name(0), "callers": {}}
    for caller in recorded:
        args = tuple(a.to(device) for a in recorded[caller])
        out = wm_module.window_match(*args)
        plain = wm_module.window_match_plain(*args)
        if not agrees_with_plain(out, plain, args[0], args[5], 1 << 20):
            raise AssertionError(f"{caller}: the kernel disagrees with the plain version")
        result["callers"][caller] = time_caller(wm_module, args)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
