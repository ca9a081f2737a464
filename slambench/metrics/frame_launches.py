"""Host launch calls (kernels, copies, memsets, graph launches) per frame
without a keyframe, median over the profiled slice of the window."""

import statistics


def read(ctx):
    per_frame = ctx["trace"].get("launches_per_frame", [])
    at = ctx["trace_from"]
    kept = [n for j, n in enumerate(per_frame) if at + j not in ctx["keyframe_at"]]
    return float(statistics.median(kept)) if kept else None
