"""The window-match kernel's share of its roofline over the profiled slice:
the least time of each launch on its own arguments (`reference.
window_match_bound`: bytes read and written once at the HBM rate, 24
operations per in-window pair at the ALU rate) summed, over the launches'
kernel times in the device trace summed, in %."""


def read(ctx):
    times = ctx["trace"].get("window_match_s", [])
    bounds = ctx["wm_bounds_s"]
    if not times or len(times) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(times)
