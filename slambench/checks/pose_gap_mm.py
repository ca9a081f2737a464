"""`pose_gap_mm`: the largest distance between the camera centre that the
frame program's pose LM returned on a sampled frame and the reference
optimisation's (`reference.pose_lm` in float64) over the same matches from
the same start, in mm (map units for a monocular map). The control: the
reference in bfloat16."""

import numpy as np
import torch

from slambench import reference as ref

CALL = "pipeline.programs.track_against_points"
SAMPLE = "pose"


def picks(rng, samples):
    """Every one of the window's first `draw_from` calls: `number` draws
    `pose` of them, from the seed, among those that matched 20 points."""
    return range(samples["draw_from"])


def keep(args, kwargs, out):
    """The local points' positions, the frame's keypoints, the start pose,
    and the result's pose and matches."""
    _, feats, pts, R0, t0 = args[:5]
    return (pts.pos, feats.xy, feats.u_right, feats.level, R0, t0, out.R, out.t,
            out.match_feat)


def number(kept, ctx):
    able = [k for _, k in kept if int((k[-1] >= 0).sum()) >= 20]
    if not able:
        return None
    n = min(int(ctx.samples["pose"]), len(able))
    gaps = []
    for i in sorted(np.random.default_rng(ctx.seed).choice(len(able), n, False)):
        pos, xy, u_right, level, R0, t0, R_got, t_got, match = able[i]
        valid = match >= 0
        sel = match.clamp_min(0).long()
        obs = (pos, xy[sel], u_right[sel], level[sel], valid)
        R, t = ref.pose_lm(ctx.cam, R0, t0, *obs, dtype=torch.float64)
        if ctx.control:
            gR, gt = ref.pose_lm(ctx.cam, R0, t0, *obs, dtype=torch.bfloat16)
        else:
            gR, gt = R_got.to(torch.float64), t_got.to(torch.float64)
        c_ref, c_got = -(R.T @ t), -(gR.T @ gt)
        gaps.append(float(torch.linalg.norm(c_ref - c_got)) * 1e3)
    return max(gaps)
