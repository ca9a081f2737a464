"""Reduction of the traced run: a `torch.profiler` trace of a slice of the
window, and the port's spans (`utils/profiling.GLOBAL_TIMER`).

`reduce(prof, harness_ranges, port_spans)` reads the profiler's events once
and returns what the per-layer readers take: host launch calls per traced
frame; the device's busy time (the union of kernel, copy and memset
intervals, leaving out the GPU annotations of the harness's ranges and the
port's spans) and the slice's wall; the window-match kernel's time of each
launch in order; the device operations with the most time; the longest idle
gaps of the device, each named by the innermost harness range or port span
open on the host when the gap began; and the charging below.

Each launch call (`LAUNCH_CALLS`) and each host wait on the device
(`SYNC_CALLS`) is charged to the innermost range or span open on its own
thread (a harness `Timer`'s own synchronize lies in its harness range, so
it is not charged to the program): per traced frame, those charged to port
spans; the launches inside each `keyframe` span; and calls, launches and
syncs by range name over the slice.

`take_spans` and `table` read the port's spans: by span name, calls, mean
ms, self ms and device ms over the window, and launches and syncs per call
in the profiled slice.
"""

from __future__ import annotations

import bisect
import statistics
from collections import Counter, defaultdict

import torch

FRAME = "slambench.frame"
KEYFRAME = "keyframe"
# host-side CUDA runtime and driver calls that each put one kernel, copy,
# memset or graph on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch", "cuGraphLaunch")
# host-side CUDA API calls (`cuda*` and `cu*`) that block the host until the
# device (or a stream, or an event) has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cuMemcpyDtoH", "cuMemcpyDtoH_v2",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


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


def reduce(prof, harness_ranges, port_spans=()) -> dict:
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    port = set(port_spans)
    names = set(harness_ranges) | port | {FRAME}
    frames, keyframes, device = [], [], []
    ranges = defaultdict(list)
    launches, syncs = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name == FRAME:
                frames.append((a, b))
            if e.name in names:
                ranges[e.thread].append((a, b, e.name))
                if e.name == KEYFRAME:
                    keyframes.append((a, b))
            elif e.name in LAUNCH_CALLS:
                launches.append((a, e.thread))
            elif e.name in SYNC_CALLS:
                syncs.append((a, e.thread))
        elif e.device_type == cuda and e.name not in names:
            device.append((a, b, e.name))
    if not frames:
        return {}
    frames.sort()
    w0, w1 = frames[0][0], frames[-1][1]
    launch_at = sorted(t for t, _ in launches)
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1])
    by_name = Counter()
    for a, b, n in device:
        by_name[n] += (b - a) * 1e-6
    gaps = []
    edges = [(w0, w0)] + [tuple(x) for x in busy] + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)
    every = [r for rs in ranges.values() for r in rs]
    named = []
    for length, at in gaps[:10]:
        open_ = [(b - a, n) for a, b, n in every if a <= at < b]
        named.append([min(open_)[1] if open_ else "host", length * 1e-6])
    wm = [(a, (b - a) * 1e-6) for a, b, n in device if "window_match" in n]

    # launches and host waits, each charged to the innermost range of its thread
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
    for a, b, name in every:
        if w0 <= a < w1:
            by_range[name]["calls"] += 1
    return {
        "launches_per_frame": [bisect.bisect_left(launch_at, b) - bisect.bisect_left(launch_at, a)
                               for a, b in frames],
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "window_match_s": [s for _, s in sorted(wm)],
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": named,
        "port_launches_per_frame": [sum(n for k, n in r["launches"].items() if k in port)
                                    for r in per_frame],
        "port_syncs_per_frame": [sum(n for k, n in r["syncs"].items() if k in port)
                                 for r in per_frame],
        "keyframe_in_frame": [r["keyframe"] for r in per_frame],
        "keyframe_launches": [bisect.bisect_left(launch_at, b) - bisect.bisect_left(launch_at, a)
                              for a, b in sorted(keyframes) if w0 <= a < w1],
        "by_range": {name: dict(c) for name, c in by_range.items() if name is not None},
    }


def take_spans(timer) -> list[dict]:
    """The spans that `timer` (a `utils/profiling.StageTimer`) closed since
    the last take, as plain dicts of their fields, and forgotten by it: a
    span still open joins the next take."""
    out = [{"id": s.id, "name": s.name, "parent": s.parent, "frame": s.frame,
            "thread": s.thread, "host_ms": s.host_ms, "device_ms": s.device_ms, "ms": s.ms,
            "self_ms": s.self_ms} for s in timer.spans()]
    timer.reset()
    return out


def table(spans: list[dict], summary: dict) -> dict:
    """By span name: calls and mean ms / self ms over the window's spans;
    launches and syncs per call in the profiled slice."""
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
