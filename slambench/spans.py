"""A run of a cell with the port's span tracer on, and the charging of a
profiler trace's launches and host syncs to the innermost open range.

    python -m slambench.spans --workload <name> --seed <n> --seconds <s> [--trace 0|1]

prints one JSON line: the result line of `run.run` for the same arguments,
and under `spans` what the port's spans (`utils/profiling.GLOBAL_TIMER`)
give: the per-layer numbers of the readers `metrics/local_ba_ms.py`,
`keyframe_rest_ms.py`, `keyframe_launches.py` and `frame_syncs.py`; with
`--trace 1`, the launches each traced frame charges to port spans and a
table by span name: calls, mean ms, self ms and device ms over the window,
and the launches and host syncs charged to the name per call in the
profiled slice.

The tracer is reset and switched on once the warm-up has ended (the hook of
`run.run`) and off when the window closes. The same command through
`slambench.run` is the same run with the tracer off, so the two on the same
seeds show what the tracer costs. With `--trace 1` the harness's
`trace.reduce` gets the port's span names beside its own ranges: the GPU
user-annotation events of the spans are then not counted as device work,
and `breakdown.idle_gaps` names a gap by the innermost span or range open
when it began. It needs a CUDA card, as `run.py` does.

`charge(prof, harness_ranges, port_spans)` charges each launch call
(`trace.LAUNCH_CALLS`) and each host wait on the device (`SYNC_CALLS`) to
the innermost range open on its thread: a harness `Timer`'s own
synchronize lies in its harness range, so it is not charged to the
program.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from collections import Counter, defaultdict

from . import run
from . import trace as trace_mod

# host-side CUDA API calls (`cuda*` and `cu*`) that block the host until the
# device (or a stream, or an event) has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cuMemcpyDtoH", "cuMemcpyDtoH_v2",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
NEW_METRICS = ("local_ba_ms", "keyframe_rest_ms", "keyframe_launches", "frame_syncs")
KEYFRAME = "keyframe"


def _innermost(ranges, times):
    """The name of the innermost of `ranges` ((start, end, name), nested as
    one thread's are) open at each of the sorted `times`, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _charge(ranges_by_thread, calls):
    """(time, range name) of each (time, thread) call, by the ranges of its
    own thread, or of every thread where its thread opened none."""
    every = [r for rs in ranges_by_thread.values() for r in rs]
    by_thread = defaultdict(list)
    for t, th in calls:
        by_thread[th if th in ranges_by_thread else None].append(t)
    out = []
    for th, times in by_thread.items():
        times.sort()
        out += zip(times, _innermost(ranges_by_thread[th] if th is not None else every, times))
    out.sort(key=lambda x: x[0])
    return out


def charge(prof, harness_ranges, port_spans) -> dict:
    """Launch calls and host syncs per traced frame, by the innermost open
    range; launches inside each `keyframe` span; calls, launches and syncs
    by range name over the slice."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    port = set(port_spans)
    names = set(harness_ranges) | port | {trace_mod.FRAME}
    frames, keyframes = [], []
    ranges = defaultdict(list)
    launches, syncs = [], []
    for e in prof.events():
        if e.device_type != cpu:
            continue
        a, b = e.time_range.start, e.time_range.end
        if e.name == trace_mod.FRAME:
            frames.append((a, b))
        if e.name in names:
            ranges[e.thread].append((a, b, e.name))
            if e.name == KEYFRAME:
                keyframes.append((a, b))
        elif e.name in trace_mod.LAUNCH_CALLS:
            launches.append((a, e.thread))
        elif e.name in SYNC_CALLS:
            syncs.append((a, e.thread))
    if not frames:
        return {}
    frames.sort()
    charged = {"launches": _charge(ranges, launches), "syncs": _charge(ranges, syncs)}
    at = {key: [t for t, _ in calls] for key, calls in charged.items()}
    per_frame = []
    by_range = defaultdict(Counter)
    for a, b in frames:
        row = {"launches": Counter(), "syncs": Counter(),
               "keyframe": any(a <= s < b for s, _ in keyframes)}
        for key, calls in charged.items():
            times = at[key]
            for _, name in calls[bisect.bisect_left(times, a):bisect.bisect_left(times, b)]:
                row[key][name] += 1
                by_range[name][key] += 1
        per_frame.append(row)
    w0, w1 = frames[0][0], frames[-1][1]
    for rs in ranges.values():
        for a, b, name in rs:
            if w0 <= a < w1:
                by_range[name]["calls"] += 1
    launch_t = at["launches"]
    kf_launches = [bisect.bisect_left(launch_t, b) - bisect.bisect_left(launch_t, a)
                   for a, b in sorted(keyframes) if w0 <= a < w1]
    return {
        "port_launches_per_frame": [sum(n for k, n in r["launches"].items() if k in port)
                                    for r in per_frame],
        "port_syncs_per_frame": [sum(n for k, n in r["syncs"].items() if k in port)
                                 for r in per_frame],
        "keyframe_in_frame": [r["keyframe"] for r in per_frame],
        "keyframe_launches": kf_launches,
        "by_range": {name: dict(c) for name, c in by_range.items() if name is not None},
    }


def span_dicts(spans) -> list[dict]:
    return [{"id": s.id, "name": s.name, "parent": s.parent, "frame": s.frame,
             "thread": s.thread, "host_ms": s.host_ms, "device_ms": s.device_ms, "ms": s.ms,
             "self_ms": s.self_ms} for s in spans]


def table(spans: list[dict], summary: dict) -> dict:
    """By span name: calls and mean ms / self ms / device ms over the run's
    spans; launches and syncs per call in the profiled slice."""
    by_name = defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    in_slice = summary.get("by_range", {})
    out = {}
    for name, rows in by_name.items():
        dev = [s["device_ms"] for s in rows if s["device_ms"] is not None]
        entry = {"calls": len(rows), "ms": statistics.fmean(s["ms"] for s in rows),
                 "self_ms": statistics.fmean(s["self_ms"] for s in rows),
                 "device_ms": statistics.fmean(dev) if dev else None}
        c = in_slice.get(name)
        if c and c.get("calls"):
            entry.update(slice_calls=c["calls"], launches=c.get("launches", 0) / c["calls"],
                         syncs=c.get("syncs", 0) / c["calls"])
        out[name] = entry
    return out


def traced_run(args, device) -> dict:
    """`run.run` for `args` on `device` with the port's spans on, and read:
    the result dict with its `spans` part."""
    from orb_slam3_comments_ghr_torch.utils.profiling import GLOBAL_TIMER, StageTimer

    from . import probes

    port = tuple(StageTimer.STAGES)
    summary = {}

    def reduce_too(orig):
        def wrapper(prof, ranges):
            out = orig(prof, tuple(ranges) + port)
            out.update(charge(prof, ranges, port))
            summary.update(out)
            return out
        return wrapper

    def off_at_window_end(orig):
        def wrapper(*a):
            GLOBAL_TIMER.enabled = False
            return orig(*a)
        return wrapper

    def on(slam):
        GLOBAL_TIMER.reset()
        GLOBAL_TIMER.enabled = True

    patches = probes.Patches()
    patches.wrap(trace_mod, "reduce", reduce_too)
    patches.wrap(run, "window_metrics", off_at_window_end)
    run_args = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=args.seconds,
                                  trace=args.trace, control=0)
    try:
        result, lines = run.run(run_args, device, hooks=on)
    finally:
        patches.restore()
        GLOBAL_TIMER.enabled = False
    if not run._finite(result):
        lines.append("a metric or number is not finite: not correct")
    spans = span_dicts(GLOBAL_TIMER.spans())
    GLOBAL_TIMER.reset()
    ctx = {"spans": spans, "trace": summary}
    kf_free = [n for n, kf in zip(summary.get("port_launches_per_frame", []),
                                  summary.get("keyframe_in_frame", [])) if not kf]
    result["spans"] = {
        "metrics": {name: run.metric_reader(name)(ctx) for name in NEW_METRICS},
        "port_launches_median": float(statistics.median(kf_free)) if kf_free else None,
        "port_launches_per_frame": summary.get("port_launches_per_frame"),
        "keyframe_in_frame": summary.get("keyframe_in_frame"),
        "table": table(spans, summary),
    }
    result["check_lines"] = lines
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    run._environment()
    import torch

    if not torch.cuda.is_available():
        print("slambench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = traced_run(args, torch.device("cuda", 0))
    sys.stderr.write("\n".join(result.pop("check_lines")) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
