"""`viba_cost_gap`: the largest excess of the cost of a sampled inertial
local BA's result over the reference BA's (`reference.viba_lm` in float64:
the same problem, the same iterations), both costs taken by the
reference's cost function, as a share of the reference's cost. The
control: the reference BA in bfloat16."""

import torch

from slambench import reference as ref

CALL = "optim.vi_ba.vi_bundle_adjust"
SAMPLE = "viba"


def picks(rng, samples):
    """`viba` local BAs among the window's first `viba_from`."""
    return rng.choice(samples["viba_from"], samples["viba"], False)


def number(kept, ctx):
    gaps = []
    for _, (args, kwargs, out) in kept:
        prob = args[1]._asdict()
        if prob["obs_rig"] is not None:
            raise ValueError("the inertial BA reference has no camera rig")
        prob["pre"] = prob["pre"]._asdict()
        iters = kwargs.get("iters", args[2] if len(args) > 2 else 10)
        want = ref.viba_lm(ctx.cam, prob, iters=iters, dtype=torch.float64)
        got = (ref.viba_lm(ctx.cam, prob, iters=iters, dtype=torch.bfloat16) if ctx.control
               else out[:5])
        c_ref = ref.viba_cost(ctx.cam, prob, want)
        c_got = ref.viba_cost(ctx.cam, prob, got)
        gaps.append((c_got - c_ref) / max(c_ref, 1e-12))
    return max(gaps) if gaps else None
