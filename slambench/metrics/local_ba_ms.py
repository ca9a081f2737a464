"""The `local_ba` span's ms (the local BA of `LocalMapper.process_keyframe`,
inertial once the IMU is initialized), mean over the window's keyframes
that ran one. Reads the port's spans of the window (`ctx["spans"]`, dicts
of `utils/profiling.Span`'s fields), which the `--trace 1` run records."""


def read(ctx):
    ms = [s["ms"] for s in ctx.get("spans") or () if s["name"] == "local_ba"]
    return sum(ms) / len(ms) if ms else None
