"""Run chosen phases of `chip_smoke.py` from the tree of a checkout, on the
card, to compare two versions of the port in one call.

    python scripts/smoke_phases.py [--tree DIR] [--keep-going] --phases 7 8 9 10a 10b

DIR (default: this checkout) is the root of a checkout, for example an
earlier commit unpacked by `git archive <commit> | tar -x -C DIR` into a
git-ignored directory; its `chip_smoke.py` and its package are the ones
imported. Each phase runs as the whole script runs it (the window-match
kernel built from DIR's sources first) and prints its own lines; then one
JSON line gives the seconds each phase took and what it returned (the
launches and matcher calls; the runs' outcome). Phases: 7
(stereo-inertial), 8 (RGB-D-inertial), 9 (mono-inertial), 10a (the feature
loop), 10b (the kidnap and merge), 11 (inertial loop closing: (a), (b) and
(c) on (a)'s map; from a tree that has it), 12 (the fisheye camera: (a)
mono, (b) stereo, (c) stereo-inertial; from a tree that has it), 13 (the
entry points: phase 4's run for its map and atlas, then (a)-(e); from a
tree that has it), 14 (asynchronous mapping and the deep pipeline: (a)-(d);
from a tree that has it; 14a and 14d run its (a) or (d) alone), 15 (the
port's tools on a stand-in ground truth: (a)-(d); from a tree that has
it), 14c60 (phase 14 (c)'s 60 frames in all four modes: pipelined or
synchronous, with the worker or inline, each with its per-frame metric
error after alignment, in mm). A phase
named again runs again (its result under "NAME#2", ...); with
`--keep-going` a phase that fails is recorded with its error and the next
one runs, and the exit code is 1 if any failed. Needs one CUDA card.
"""

import argparse
import json
import os
import sys
import time

PHASES = {"7": "phase7_stereo_inertial", "8": "phase8_rgbd_inertial",
          "9": "phase9_mono_inertial", "10a": "phase10_feature_loop", "10b": "phase10_merge",
          "11": None, "12": None, "13": None, "14": None, "15": None, "14c60": None,
          "14a": "phase14_async_mono",
          "14d": "phase14_background_gba"}


def phase11(chip_smoke, window_match, device):
    """Phase 11's three runs, as chip_smoke.main runs them."""
    n, calls, _, loop, snap = chip_smoke.phase11_inertial_loop(window_match, device)
    n_b, calls_b, merge = chip_smoke.phase11_kidnap(window_match, device)
    gba = chip_smoke.phase11_full_inertial_ba(snap, device)
    return n + n_b, {"a": calls, "b": calls_b}, dict(inertial_loop=loop, inertial_merge=merge,
                                                     full_inertial_ba=gba)


def phase12(chip_smoke, window_match, device):
    """Phase 12's three runs, as chip_smoke.main runs them."""
    n, calls, _, mono = chip_smoke.phase12_mono_fisheye(window_match, device)
    inputs = chip_smoke.fisheye_stereo_inputs(chip_smoke.PHASE12_VI_FRAMES)
    n_b, calls_b, stereo = chip_smoke.phase12_stereo_fisheye(window_match, device, inputs, False)
    n_c, calls_c, vi = chip_smoke.phase12_stereo_fisheye(window_match, device, inputs, True)
    return n + n_b + n_c, {"a": calls, "b": calls_b, "c": calls_c}, dict(
        mono=mono, stereo=stereo, stereo_inertial=vi)


def phase13(chip_smoke, window_match, device):
    """Phase 13's five runs, as chip_smoke.run_phases runs them, on phase
    4's frames and final map (phase 4 runs first for them)."""
    import tempfile

    seq = chip_smoke.render_sequence(chip_smoke.PHASE4_FRAMES)
    slam = chip_smoke.phase4_slam(window_match, seq)[2]
    chip_smoke.phase4_lost_and_back(window_match, slam, seq)
    with tempfile.TemporaryDirectory(prefix="phase13_", dir=chip_smoke.scratch_dir()) as work:
        atlas = chip_smoke.phase13_save_atlas(slam, work, device)
        del slam
        right = chip_smoke.second_inputs(seq, "stereo")
        launches, calls, out = 0, {}, {}
        for key, second in (("cli mono", None), ("cli stereo", right)):
            n, calls[key], _, out[key] = chip_smoke.phase13_cli(window_match, seq, second)
            launches += n
        n, calls["atlas"], _, out["atlas"] = chip_smoke.phase13_second_session(
            window_match, seq, atlas, device)
        out.update(chip_smoke.phase13_distributed(atlas, device))
    return launches + n, calls, out


def phase14(chip_smoke, window_match, device):
    """Phase 14's runs, as chip_smoke's group process runs them."""
    paths, _, out = chip_smoke.phase_group_async(window_match, device, None)
    return sum(p["launches"] for p in paths.values()), paths, out


def phase15(chip_smoke, window_match, device):
    """Phase 15's runs, as chip_smoke's group process runs them, its files
    in a temporary folder under the tree's `build/`."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="phase15_", dir=chip_smoke.scratch_dir()) as work:
        paths, _, out = chip_smoke.phase_group_gt_tools(window_match, device, work)
    return sum(p["launches"] for p in paths.values()), paths, out


def phase14c60(chip_smoke, window_match, device):
    """Phase 14 (c)'s 60 frames in the four modes, each to its bars; a mode
    that fails is recorded with its error."""
    import numpy as np

    from orb_slam3_comments_ghr_torch.utils import evaluation

    ate_rmse, seen = evaluation.ate_rmse, {}

    def kept(est, gt, with_scale=True, max_dt=0.02):
        seen["est"], seen["gt"] = est, gt
        return ate_rmse(est, gt, with_scale, max_dt)

    evaluation.ate_rmse = kept
    launches, calls, out = 0, {}, {}
    try:
        for (pipelined, worker), mode in chip_smoke.PHASE14_MODES.items():
            try:
                n, calls[mode], out[mode] = chip_smoke.phase14_stereo_inertial(
                    window_match, device, chip_smoke.PHASE14_VI_FRAMES, pipelined, worker)
                launches += n
            except AssertionError as e:
                out[mode] = {"failed": repr(e)}
            gt = {round(t, 4): np.linalg.inv(T)[:3, 3] for t, T in seen["gt"]}
            pe = np.stack([np.linalg.inv(T)[:3, 3] for _, T in seen["est"]])
            pg = np.stack([gt[round(t, 4)] for t, _ in seen["est"]])
            _, R, t, _ = evaluation.horn_align(pe, pg, with_scale=False)
            out[mode]["err_mm"] = np.round(np.linalg.norm(pe @ R.T + t - pg, axis=1) * 1e3,
                                           1).tolist()
    finally:
        evaluation.ate_rmse = ate_rmse
    return launches, calls, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--phases", nargs="+", choices=tuple(PHASES), required=True)
    ap.add_argument("--keep-going", action="store_true",
                    help="record a failing phase and run the next one")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases.py needs a CUDA card")
    import chip_smoke
    from orb_slam3_comments_ghr_torch.ops import window_match

    print(f"tree {os.path.abspath(args.tree)}: {chip_smoke.__file__}")
    print(chip_smoke.card_line())
    window_match.build()
    device = torch.device("cuda", 0)
    out, failed = {}, 0
    for phase in args.phases:
        key = phase
        while key in out:
            key = f"{phase}#{int(key.partition('#')[2] or 1) + 1}"
        t0 = time.perf_counter()
        run = {"11": phase11, "12": phase12, "13": phase13, "14": phase14,
               "15": phase15, "14c60": phase14c60}.get(phase)
        try:
            result = (run(chip_smoke, window_match, device) if run
                      else getattr(chip_smoke, PHASES[phase])(window_match, device))
        except Exception as e:
            if not args.keep_going:
                raise
            failed += 1
            out[key] = dict(seconds=time.perf_counter() - t0, failed=repr(e))
            print(f"phase {key} FAILED in {out[key]['seconds']:.1f} s: {e!r}")
            continue
        out[key] = dict(seconds=time.perf_counter() - t0, launches=result[0], calls=result[1],
                        result=result[-2] if phase == "7" else result[-1])
        print(f"phase {key} passed in {out[key]['seconds']:.1f} s")
    print(json.dumps(out, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
