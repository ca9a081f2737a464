"""Host launch calls (kernels, copies, memsets, graph launches) inside each
`keyframe` span of the profiled slice, median over its keyframes
(`trace.reduce`'s `keyframe_launches`)."""

import statistics


def read(ctx):
    per_kf = (ctx.get("trace") or {}).get("keyframe_launches")
    return float(statistics.median(per_kf)) if per_kf else None
