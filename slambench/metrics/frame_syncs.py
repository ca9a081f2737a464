"""Host waits on the device (stream, device and event synchronizes, blocking
copies) charged to the port's spans, per traced frame without a keyframe,
median over the profiled slice (`trace.reduce`); the harness's own
synchronizes lie in its ranges and are not counted."""

import statistics


def read(ctx):
    t = ctx.get("trace") or {}
    per_frame = t.get("port_syncs_per_frame")
    if not per_frame:
        return None
    kept = [n for n, kf in zip(per_frame, t.get("keyframe_in_frame", ())) if not kf]
    return float(statistics.median(kept)) if kept else None
