"""Host ms of the frame program's call (`extract_and_track_stereo` /
`extract_and_track`), ending in a device sync, median over the window's
frames without a keyframe."""

import statistics


def read(ctx):
    calls = ctx["timer_ms"].get("frame_program", [])
    kept = [ms for i, ms in enumerate(calls) if i not in ctx["keyframe_at"]]
    return float(statistics.median(kept)) if kept else None
