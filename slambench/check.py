"""The output check: each number compared beside its limit.

`numbers(ctx, limits)` works out, for every limit of the cell, the number
it bounds, from what the window produced and the plain references of
`reference.py`:

- `wm_mismatch`: rows of the sampled window-match launches whose result
  differs from the reference's, summed.
- `pose_gap_mm`: the largest distance between the camera centre the frame
  program's pose LM returned on a sampled frame and the reference
  optimisation's over the same matches from the same start, in mm (map
  units for a monocular map).
- `vi_gap_mm`: the largest distance between the body position that the
  tracker's VI refinement returned on a sampled frame and the reference
  refinement's from the same start, matches and preintegration, in mm.
- `viba_cost_gap`: the largest excess of the cost of a sampled inertial
  local BA's result over the reference BA's (same problem, same
  iterations), both costs taken by the reference's cost function, as a
  share of the reference's cost.
- `preint_gap`: the largest relative gap of a sampled IMU preintegration's
  (dR, dV, dP) against the reference integration of the same samples.

With `ctx.control` the references computed in bfloat16 stand in the
program's place, and the numbers are the control's readings.

The trajectory is not compared here: on an H100 the generated motion in
bfloat16 (the control of `rpe_mm`) read 1.5-2.9 mm RPE where the program
read 3.7-11.6, so no limit separates the two (PERF.md). `rpe_mm` below
works out the per-layer metric of that name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reference as ref

BF16 = torch.bfloat16
F64 = torch.float64


@dataclasses.dataclass
class Context:
    cam: dict
    control: bool
    seed: int
    n_pose: int         # frame-program calls the pose check compares
    mono: bool
    samplers: dict
    est: dict           # timestamp -> T_cw of every tracked frame
    times: np.ndarray   # the window's frame times
    gt: np.ndarray      # (n,4,4) the window's true T_cw


def window_match_bound_s(args) -> float:
    """The least time (s) of one window-match launch on its arguments."""
    return ref.window_match_bound(args, ref.window_pairs(args))[0]


def rpe_mm(ctx: Context) -> float:
    """`rpe_mm` of the window's tracked frames (inf under 20 pairs)."""
    keep = [k for k, ts in enumerate(ctx.times) if float(ts) in ctx.est]
    if len(keep) < 3:
        return float("inf")
    gt_wc = np.linalg.inv(ctx.gt[keep])
    est_wc = np.linalg.inv(np.stack([ctx.est[float(ctx.times[k])] for k in keep])
                           .astype(np.float64))
    value, pairs = ref.rpe(est_wc, gt_wc, ctx.times[keep], 1.0, ctx.mono)
    return value * 1e3 if pairs >= 20 else float("inf")


def _wm(ctx: Context):
    total, seen = 0, 0
    for _, (args, _, out) in ctx.samplers["window_match"].kept:
        want = ref.window_match(args, F64)
        if not bool((want[1] < ref.BIG).any()):
            continue  # no query had a candidate: nothing to compare
        got = ref.window_match(args, BF16)[:3] if ctx.control else out
        total += ref.window_match_mismatches(got, want)
        seen += 1
    return total if seen else None


def pose_sample(args, kwargs, out):
    """What the pose check keeps of a `track_against_points` call: the
    local points' positions, the frame's keypoints, the start pose, and
    the result's pose and matches."""
    _, feats, pts, R0, t0 = args[:5]
    return (pts.pos, feats.xy, feats.u_right, feats.level, R0, t0, out.R, out.t,
            out.match_feat)


def _pose(ctx: Context):
    """Over `ctx.n_pose` calls drawn from the seed among those of the
    window's first calls that matched at least 20 points."""
    able = [k for _, k in ctx.samplers["pose"].kept if int((k[-1] >= 0).sum()) >= 20]
    if not able:
        return None
    picks = np.random.default_rng(ctx.seed).choice(len(able), min(ctx.n_pose, len(able)), False)
    gaps = []
    for i in sorted(picks):
        pos, xy, u_right, level, R0, t0, R_got, t_got, match = able[i]
        valid = match >= 0
        sel = match.clamp_min(0).long()
        obs = (pos, xy[sel], u_right[sel], level[sel], valid)
        R, t = ref.pose_lm(ctx.cam, R0, t0, *obs, dtype=F64)
        if ctx.control:
            gR, gt = ref.pose_lm(ctx.cam, R0, t0, *obs, dtype=BF16)
        else:
            gR, gt = R_got.to(F64), t_got.to(F64)
        c_ref, c_got = -(R.T @ t), -(gR.T @ gt)
        gaps.append(float(torch.linalg.norm(c_ref - c_got)) * 1e3)
    return max(gaps)


def _viba(ctx: Context):
    gaps = []
    for _, (args, kwargs, out) in ctx.samplers["viba"].kept:
        prob = args[1]._asdict()
        if prob["obs_rig"] is not None:
            raise ValueError("the inertial BA reference has no camera rig")
        prob["pre"] = prob["pre"]._asdict()
        iters = kwargs.get("iters", args[2] if len(args) > 2 else 10)
        want = ref.viba_lm(ctx.cam, prob, iters=iters, dtype=F64)
        got = ref.viba_lm(ctx.cam, prob, iters=iters, dtype=BF16) if ctx.control else out[:5]
        c_ref = ref.viba_cost(ctx.cam, prob, want)
        c_got = ref.viba_cost(ctx.cam, prob, got)
        gaps.append((c_got - c_ref) / max(c_ref, 1e-12))
    return max(gaps) if gaps else None


def _vi_refine(ctx: Context):
    gaps = []
    for _, (args, _, out) in ctx.samplers["vi_refine"].kept:
        _, state0, prev, pre, obs, Tcb = args
        plain = (state0._asdict(), prev._asdict(), pre._asdict(), obs._asdict(), Tcb)
        want = ref.vi_refine_lm(ctx.cam, *plain, dtype=F64)
        got = (ref.vi_refine_lm(ctx.cam, *plain, dtype=BF16) if ctx.control
               else [t.to(F64) for t in out[0]])
        gaps.append(float(torch.linalg.norm(got[1] - want[1])) * 1e3)
    return max(gaps) if gaps else None


def _preint(ctx: Context):
    gaps = []
    for _, (args, _, out) in ctx.samplers["preint"].kept:
        acc, gyr, dts, bias = args[:4]
        if float(dts.clamp_min(0).sum()) <= 0:
            continue
        want = ref.preintegrate(acc, gyr, dts, bias, F64)
        got = ref.preintegrate(acc, gyr, dts, bias, BF16) if ctx.control else (out.dR, out.dV,
                                                                               out.dP)
        gaps.append(ref.preint_gap(want, got))
    return max(gaps) if gaps else None


READERS = {"wm_mismatch": _wm, "pose_gap_mm": _pose, "vi_gap_mm": _vi_refine,
           "viba_cost_gap": _viba, "preint_gap": _preint}


def numbers(ctx: Context, limits: dict) -> dict:
    """{name: (number, limit)} for each limit whose number could be worked
    out; a limit left out had nothing to compare, which fails the run."""
    out = {}
    with torch.no_grad():
        for name, limit in limits.items():
            value = READERS[name](ctx)
            if value is not None:
                out[name] = (float(value), float(limit))
    return out
