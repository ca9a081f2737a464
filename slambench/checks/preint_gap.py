"""`preint_gap`: the largest relative gap of a sampled IMU preintegration's
(dR, dV, dP) against the reference integration of the same samples
(`reference.preintegrate` in float64). The control: the reference in
bfloat16."""

import torch

from slambench import reference as ref

CALL = "optim.imu.preintegrate"
SAMPLE = "preint"


def picks(rng, samples):
    """`preint` preintegrations among the window's first `draw_from`."""
    return rng.choice(samples["draw_from"], samples["preint"], False)


def number(kept, ctx):
    gaps = []
    for _, (args, _, out) in kept:
        acc, gyr, dts, bias = args[:4]
        if float(dts.clamp_min(0).sum()) <= 0:
            continue
        want = ref.preintegrate(acc, gyr, dts, bias, torch.float64)
        got = (ref.preintegrate(acc, gyr, dts, bias, torch.bfloat16) if ctx.control
               else (out.dR, out.dV, out.dP))
        gaps.append(ref.preint_gap(want, got))
    return max(gaps) if gaps else None
