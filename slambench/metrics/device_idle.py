"""The device's idle share of the profiled slice, in %: 1 - (union of its
kernel, copy and memset intervals) / the slice's wall. An upper estimate:
the profiler inflates the host's time, and so the wall."""


def read(ctx):
    t = ctx["trace"]
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
