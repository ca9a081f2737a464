"""`vi_gap_mm`: the largest distance between the body position that the
tracker's VI refinement returned on a sampled frame and the reference
refinement's (`reference.vi_refine_lm` in float64) from the same start,
matches and preintegration, in mm. The control: the reference in
bfloat16."""

import torch

from slambench import reference as ref

CALL = "slam.tracker._pose_inertial"
SAMPLE = "vi_refine"


def picks(rng, samples):
    """`vi_refine` refinements among the window's first `draw_from`."""
    return rng.choice(samples["draw_from"], samples["vi_refine"], False)


def number(kept, ctx):
    gaps = []
    for _, (args, _, out) in kept:
        _, state0, prev, pre, obs, Tcb = args
        plain = (state0._asdict(), prev._asdict(), pre._asdict(), obs._asdict(), Tcb)
        want = ref.vi_refine_lm(ctx.cam, *plain, dtype=torch.float64)
        got = (ref.vi_refine_lm(ctx.cam, *plain, dtype=torch.bfloat16) if ctx.control
               else [t.to(torch.float64) for t in out[0]])
        gaps.append(float(torch.linalg.norm(got[1] - want[1])) * 1e3)
    return max(gaps) if gaps else None
