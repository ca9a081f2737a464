"""`wm_mismatch`: rows of the sampled window-match launches whose result
differs from the dense reference's (`reference.window_match`: best, second,
idx up to ties), summed over the launches where some query had a candidate.
The control: the window test computed in bfloat16."""

import torch

from slambench import reference as ref

CALL = "pipeline.programs.window_match"
SAMPLE = "window_match"


def picks(rng, samples):
    """`window_match` launches among the window's first `draw_from`."""
    return rng.choice(samples["draw_from"], samples["window_match"], False)


def number(kept, ctx):
    total, seen = 0, 0
    for _, (args, _, out) in kept:
        want = ref.window_match(args, torch.float64)
        if not bool((want[1] < ref.BIG).any()):
            continue  # no query had a candidate: nothing to compare
        got = ref.window_match(args, torch.bfloat16)[:3] if ctx.control else out
        total += ref.window_match_mismatches(got, want)
        seen += 1
    return total if seen else None
