"""Host ms per frame of the IMU preintegration (`optim/imu.preintegrate`,
`preintegrate_continue`) and the tracker's VI refinement (`_vi_refine`),
each ending in a device sync, median over the window's frames without a
keyframe. Inertial cells only."""

import statistics


def read(ctx):
    if not ctx["inertial"]:
        return None
    kept = [ms for i, ms in ctx["vi_ms_at"].items() if i not in ctx["keyframe_at"]]
    return float(statistics.median(kept)) if kept else None
