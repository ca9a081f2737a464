"""RPE of the window's trajectory (`SLAM.trajectory()` at the run's end)
against the generated motion: RMSE in mm of the translation error over
every pair of tracked window frames 1 s apart, Sim(3) scale first for a
monocular map (`reference.rpe`). Run to run it spreads 14-25 % (IQR over
the median), too widely for an end-to-end bound of at most 25 %."""

import math


def read(ctx):
    v = ctx["rpe_mm"]
    return v if math.isfinite(v) else None
