"""Reduction of a `torch.profiler` trace of a slice of the window.

`reduce(prof, range_names)` reads the profiler's events once and returns
what the per-layer readers take: host launch calls per traced frame, the
device's busy time (the union of kernel, copy and memset intervals) and the
slice's wall, the window-match kernel's time of each launch in order, the
device operations with the most time, and the longest idle gaps of the
device, each named by the innermost harness range open on the host when the
gap began.
"""

from __future__ import annotations

import bisect
from collections import Counter

import torch

FRAME = "slambench.frame"
# host-side CUDA runtime and driver calls that each put one kernel, copy,
# memset or graph on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch", "cuGraphLaunch")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, range_names) -> dict:
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    names = set(range_names) | {FRAME}
    frames, ranges, launch_at, device = [], [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name == FRAME:
                frames.append((a, b))
            if e.name in names:
                ranges.append((a, b, e.name))
            elif e.name in LAUNCH_CALLS:
                launch_at.append(a)
        elif e.device_type == cuda and e.name not in names:
            device.append((a, b, e.name))
    frames.sort()
    launch_at.sort()
    if not frames:
        return {}
    w0, w1 = frames[0][0], frames[-1][1]
    launches = [bisect.bisect_left(launch_at, b) - bisect.bisect_left(launch_at, a)
                for a, b in frames]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1])
    busy_us = sum(e - s for s, e in busy)
    by_name = Counter()
    for a, b, n in device:
        by_name[n] += (b - a) * 1e-6
    gaps = []
    edges = [(w0, w0)] + [tuple(x) for x in busy] + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:10]:
        open_ = [(b - a, n) for a, b, n in ranges if a <= at < b]
        named.append([min(open_)[1] if open_ else "host", length * 1e-6])
    wm = [(a, (b - a) * 1e-6) for a, b, n in device if "window_match" in n]
    return {
        "launches_per_frame": launches,
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "window_match_s": [s for _, s in sorted(wm)],
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": named,
    }
