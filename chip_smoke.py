"""Run the PyTorch port on a CUDA card: the window-match kernel against
its plain version, the per-frame tracking program, monocular, stereo,
RGB-D and visual-inertial SLAM end to end, loop closing, the fisheye
camera, and the entry points users run (the CLI, atlas files, the
distributed whole-map BA).

    python3 chip_smoke.py [--save-caller-inputs FILE]

Builds the window-match kernel from `orb_slam3_comments_ghr_torch/csrc`
and holds it against its plain PyTorch version (phase 1): at the shapes of
its three callers (tracking, two-view initialization, the mapper's fuse),
on the edge cases of `utils/match_cases.py` (targets off the image, |du|
exactly r, all distances tied, r = 1e30 and 0.5, N = 1, M = 777, NaN and
inf coordinates, no target, M over one shared-memory stage, several rows
per warp) and on misaligned views; two launches must give the same bits,
and a CUDA-graph replay the same outputs as an eager launch. Its device
time per launch comes from a CUDA graph of 100 launches, beside the
wrapper-included time and the host enqueue time.
Renders 752x480 EuRoC-cam0 frames of a synthetic two-plane scene, builds a
4096-point local map from four keyframes and tracks frames 1-24 through
`programs.extract_and_track` at 1024 features / 8 levels (phase 2), then
holds one frame against the port on the CPU (phase 3). Phase 4 drives
`SLAM.track_monocular` at the default (full) width over 120 frames:
two-view initialization, tracking, keyframes, local mapping with local BA,
and the trajectory, checked against ground truth; then blank frames lose
tracking, relocalization has to bring it back, and a frame rolled about
the optical axis has to go through the reference-keyframe fallback. Phase
5 drives `SLAM.track_stereo` over the same 120 poses with the right view of
a rectified rig (EuRoC's bf), phase 6 `SLAM.track_rgbd` with the exact
depth map: depth-seeded initialization on the first frame, tracking,
keyframes with depth-spawned points, local mapping, and the metric
trajectory (no scale fit). Phase 5 also holds the row matcher
(`stereo_match`) and the RGB-D conversion on the card against the port on
the CPU and times them; phase 6 does the same for the stereo rectification
remap and CLAHE. Phase 7 drives stereo-inertial `SLAM.track_stereo` with
the IMU rows (150 frames of `vi_sequence` rendered from the same scene, the
stereo-inertial configuration of `bench.py`): preintegration, the
IMU-predicted pose and its 4x wider search, visual-inertial refinement, the
inertial keyframe rule, the IMU initialization (gravity alignment of the
map, VI-BA) and inertial local BA, checked against ground truth, with the
per-frame and per-stage times; phase 8 RGB-D-inertial `track_rgbd` (60
frames), phase 9 mono-inertial `track_features` on rendered features (80
frames), each to its test's bars. Phase 10 runs `SLAM` with loop closing
on: (a) the feature loop of tests/test_loopclosing.py, (b) the kidnap and
merge of tests/test_merge.py, (c) the image-level loop of
tests/test_image_loopclosing.py (150 rendered 752x480 frames through
`track_monocular`, the loop closer's stages timed in the run and on the
inputs of the keyframe that closed the loop, with its host syncs), each to
its test's bars, and (d) the whole-map BA on phase 4's final map (its cost
must not rise) and on a copy with seeded noise (it must remove the noise).
Phase 11 runs inertial loop closing: (a) stereo-inertial `track_stereo` at
phase 7's width with loop closing on, over an outward turn in the room
scene that closes a loop, whose correction runs the inertial whole-map BA
(`mapper.full_inertial_ba`), with the frame and stage times of the
loop-closing keyframe, its host syncs and the inertial BA's device
profile; (b) the mono-inertial kidnap of tests/test_inertial_merge.py,
whose yaw-only weld ends in `mapper.merge_inertial_ba`, to that test's four
bars; (c) `full_inertial_ba` on (a)'s final map, dense and then past the
dense cap over every point by the point-chunked solver, with the share of
that map's observations that fail the chi2 gate and its VI-BA cost. Phase 12
runs the fisheye (KB8) camera: (a) `track_monocular` with TUM-VI's 512x512
cam0 over a circle rendered in the room through the KB8 model, with one
frame's undistortion and pose held against the CPU port; (b) the
non-rectified KB8 pair of tests/test_fisheye_stereo.py through
`track_stereo_fisheye` from rendered images (right-camera rows in the map
and in both BAs); (c) the same rig with the IMU rows of `vi_sequence(150)`
at phase 7's configuration. Phase 13 runs the entry points users run: (a)
the CLI (`io/run_slam.main`, mono, on the card) over phase 4's frames
written as an EuRoC folder with a TUM ground-truth file; (b) the CLI on
phase 5's rectified pairs with a v1.0 settings file; (c) phase 4's final
map through `save_atlas` and `load_atlas` (bit for bit), then a second
session that loads it as a new sub-map and tracks phase 4's first frames
again; (d) the landmark-sharded BA of `parallel/dba.py` on two ranks of
this script (`--dba-worker`) sharing the card over gloo, against the
single-process BA; (e) the live whole-map BA (`SlamConfig(dba_devices=-1)`,
`mapper.global_ba`) on those ranks on (c)'s atlas. Phase 14 runs
asynchronous mapping and the deep pipeline: (a) phase 4's frames with the
mapping worker (loop closing on) beside a synchronous run of the same
frames, per-frame times of both; (b) bench.py's mono pass (its config, 300
frames) through `track_monocular_pipelined`; (c) stereo-inertial
`track_stereo_pipelined`, the 60 frames of tests/test_stereo_pipelined.py
and phase 7's 150, the tracker's VI-refinement graph captured and replayed
beside the worker, and phase 7's 150 frames pipelined inline and
synchronous with the worker (these two in phases 7-9's process; phase 7
runs them synchronous inline: the four modes' metric ATE are printed side
by side); (d) phase 10 (a)'s loop
with the whole-map BA on its own thread, to phase 10 (a)'s bars. Phase 15
runs the tools users run (`orb_slam3_comments_ghr_torch/scripts`) on a
stand-in EuRoC ground truth written from the JAX package's own estimate of
MH01's motion in results/: (a) `run_gt_replay` on rendered features,
mono, 600 frames; (b) `run_gt_replay` on rendered stereo images with the
IMU and loop closing, 200 frames; (c) phase 10 (a)'s loop with the
100k-word vocabulary; (d) `train_vocabulary` on the card, its file round
trip, and `eval_vocabulary` of the 10k and 100k trees.
Phases 4-15 each count the window match's
launches from 0 (the loop closer's projection counts and fuses apart from
the mapper's fuse; the tracker's and the worker's calls on per-thread
caller stacks) and record its arguments on one call of each caller (a
worker-thread fuse in phase 14);
phases 7-9, 10, 11, 12, 14 and 15 run in six processes of this
script (`--phase-group`) beside the main one's phases 5, 6 and 13 (a)-(c),
since every phase is bound by its host's launches and the card is idle
most of the time; their output follows the main one's; after them, phase
1 holds the kernel against the plain version on those calls
and times it there (`--save-caller-inputs` also writes them to FILE for
`orb_slam3_comments_ghr_torch/utils/time_window_match.py`). Any failure
raises. The last lines are the card's name and power limit, a JSON line of
per-kernel results (with the launches and matcher calls of each path and
the times of the plain stages), and the JSON status line. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def match_problem(seed: int, n: int, m: int, radius, device, caller: str = "track"):
    """Random descriptors, predicted pixels, radii and octave bands, as the
    JAX package's kernel test builds them (`caller` "track"), or as the
    two-view init ("init": radius 100, band -1..8, half of the targets
    invalid) and the fuse ("fuse": radius 3 * 1.2^level, band level +- 1, a
    quarter of the points invisible) call the kernel."""
    rng = np.random.default_rng(seed)
    qd = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    td = rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32)
    quv = rng.random((n, 2), np.float32) * np.float32(600)
    txy = rng.random((m, 2), np.float32) * np.float32(600)
    tlvl = rng.integers(0, 8, m).astype(np.float32)
    if caller == "init":
        qrad = np.full(n, radius, np.float32)
        qlo, qhi = np.full(n, -1.0, np.float32), np.full(n, 8.0, np.float32)
        tval = (rng.random(m) > 0.5).astype(np.float32)
    elif caller == "fuse":
        lvl = rng.integers(0, 8, n).astype(np.float32)
        qrad = np.where(rng.random(n) > 0.25, np.float32(3.0) * np.float32(1.2) ** lvl,
                        np.float32(-1.0)).astype(np.float32)
        qlo, qhi = lvl - 1, lvl + 1
        tval = (rng.random(m) > 0.1).astype(np.float32)
    else:
        qrad = np.full(n, radius, np.float32)
        qlo = rng.integers(0, 3, n).astype(np.float32)
        qhi = qlo + 2
        tval = (rng.random(m) > 0.1).astype(np.float32)
    arrays = (qd, quv, qrad, qlo, qhi, td, txy, tlvl, tval)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


# H100 SXM peaks (NVIDIA's published figures): HBM bytes/s, and
# the float32 rate outside the tensor cores, taken as the ceiling for the
# kernel's 32-bit integer and compare operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def window_match_bound(args, matching_mod):
    """(bound_ms, bound_by) of one window match on these inputs: each input
    read once and each output written once (bytes); 8 XOR, 8 POPC and 8
    adds for every pair inside a window (operations, counted on this data).
    No operation is counted for a pair outside every window: a spatial
    index over the targets, as the kernel's grid, never tests such a pair,
    and the rows with r <= 0 (most of the padded local map) test none."""
    n = args[0].shape[0]
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * 4 * n
    mask = matching_mod.window_mask(args[1], args[6], args[7], args[8] > 0, args[2],
                                    args[3], args[4])
    ops = 24 * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_against_plain(wm_mod, matching_mod, args, label: str):
    """One launch against the plain version on the same inputs: best and
    second bit-equal, idx equal up to ties (idx 0 on empty rows); a second
    launch must give the same bits. Returns the largest |difference| of
    best and second (0, or it raises) and the kernel's `best`."""
    from orb_slam3_comments_ghr_torch.utils import time_window_match as twm

    out = wm_mod.window_match(*args)
    again = wm_mod.window_match(*args)
    plain = wm_mod.window_match_plain(*args)
    torch.cuda.synchronize()
    err = max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
              for a, b in zip(out[1:], plain[1:]))
    if not twm.agrees_with_plain(out, plain, args[0], args[5], matching_mod.BIG):
        raise AssertionError(f"{label}: the kernel disagrees with the plain version "
                             f"(best/second differ by up to {err})")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    return err, out[1]


def phase1_kernel(window_match_mod, matching_mod, device):
    """Kernel against plain on the card: the callers' shapes, the edge
    cases, misaligned views, determinism, a CUDA-graph replay; times on
    the random 4096x1024 r = 80 problem. Returns (max_abs_err, the times
    and bound of that problem)."""
    from orb_slam3_comments_ghr_torch.utils import match_cases, time_window_match as twm

    cases = [(0, 4096, 1024, 80.0, "track"), (1, 4096, 1024, 15.0, "track"),
             (2, 4096, 1024, 300.0, "track"), (3, 1000, 777, 80.0, "track"),
             (4, 1000, 777, 0.0, "track"), (5, 1024, 1024, 100.0, "init"),
             (6, 4096, 1024, None, "fuse")]
    max_err = 0
    for seed, n, m, radius, caller in cases:
        args = match_problem(seed, n, m, radius, device, caller)
        err, best = check_against_plain(window_match_mod, matching_mod, args,
                                        f"case {caller} seed {seed}")
        max_err = max(max_err, err)
        if radius == 0.0 and not bool((best == matching_mod.BIG).all()):
            raise AssertionError("radius-0 rows must be empty")
        print(f"phase1 case {caller} seed={seed} N={n} M={m} r={radius}: ok "
              f"(rows with a match {int((best < matching_mod.BIG).sum())})")
    for case in match_cases.ALL_CASES:
        args = tuple(torch.from_numpy(a).to(device) for a in match_cases.edge_problem(case))
        err, best = check_against_plain(window_match_mod, matching_mod, args,
                                        f"edge case {case}")
        max_err = max(max_err, err)
        print(f"phase1 edge case {case} N={args[0].shape[0]} M={args[5].shape[0]}: ok "
              f"(rows with a match {int((best < matching_mod.BIG).sum())})")
    # descriptors and pixels as views 4 bytes into their buffers
    args = list(match_problem(7, 300, 500, 40.0, device))
    for i in (5, 6):
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=device)
        buf[1:] = args[i].flatten()
        args[i] = buf[1:].view(args[i].shape)
    max_err = max(max_err, check_against_plain(window_match_mod, matching_mod, tuple(args),
                                               "misaligned views")[0])
    print("phase1 misaligned views: ok")
    # a launch captured in a CUDA graph and replayed gives the eager outputs
    args = match_problem(6, 4096, 1024, None, device, "fuse")
    eager = torch.stack(window_match_mod.window_match(*args))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = window_match_mod.window_match(*args)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(torch.stack(captured), eager):
        raise AssertionError("a CUDA-graph replay differs from the eager launch")
    print("phase1 CUDA-graph replay equals the eager launch")

    args = match_problem(0, 4096, 1024, 80.0, device)
    times = twm.time_caller(window_match_mod, args)
    times["bound_ms"], times["bound_by"] = window_match_bound(args, matching_mod)
    print(f"phase1 window_match 4096x1024 r=80: device {times['device_ms'] * 1e3:.3f} us per "
          f"launch (CUDA graph of 100), wrapper incl. {times['wrapper_ms'] * 1e3:.3f} us per call, "
          f"enqueue {times['enqueue_us']:.3f} us, plain {times['plain_ms']:.4f} ms, bound "
          f"{times['bound_ms'] * 1e3:.4f} us ({times['bound_by']})")
    return max_err, times


def phase1_callers(window_match_mod, matching_mod, recorded, device, callers):
    """The kernel against plain, and its times, on the arguments that
    phases 4-6 recorded from each of `callers`. Returns (max_abs_err,
    {caller: times, bound and counts})."""
    from orb_slam3_comments_ghr_torch.utils import time_window_match as twm

    max_err, out = 0, {}
    for caller in callers:
        if caller not in recorded:
            raise AssertionError(f"phases 4-6 recorded no call of {caller}")
        args = tuple(a.to(device) for a in recorded[caller])
        max_err = max(max_err, check_against_plain(window_match_mod, matching_mod, args,
                                                   f"recorded {caller}")[0])
        t = twm.time_caller(window_match_mod, args)
        t["bound_ms"], t["bound_by"] = window_match_bound(args, matching_mod)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        mask = matching_mod.window_mask(args[1], args[6], args[7], args[8] > 0, args[2],
                                        args[3], args[4])
        t.update(n=args[0].shape[0], m=args[5].shape[0],
                 rows_searching=int((args[2] > 0).sum()), candidates=int(mask.sum()))
        out[caller] = t
        print(f"phase1 recorded {caller} (N={t['n']}, M={t['m']}, rows searching "
              f"{t['rows_searching']}, candidates {t['candidates']}): ok; device "
              f"{t['device_ms'] * 1e3:.3f} us per launch (CUDA graph of 100; no row searching "
              f"{t['empty_ms'] * 1e3:.3f} us), wrapper incl. "
              f"{t['wrapper_ms'] * 1e3:.3f} us, enqueue {t['enqueue_us']:.3f} us, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.4f} us ({t['bound_by']}), "
              f"{100 * t['share_of_bound']:.2f} % of it")
    return max_err, out


def host_ms(fn) -> float:
    """Milliseconds of fn() on the host clock, ending in a device sync."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def render_all(fn, poses) -> list:
    """fn(R, t) for each pose, on RENDER_THREADS threads: the renderers are
    numpy, whose large array operations run without the interpreter lock,
    so the frames come out the same, several at a time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        return list(pool.map(lambda pose: fn(*pose), poses))


RENDER_THREADS = 8  # the chip machine's cores


def camera_centre(R, t) -> np.ndarray:
    return -(np.asarray(R, np.float64).T @ np.asarray(t, np.float64))


PHASE2_FRAMES = 24


def render_sequence(n: int):
    """uint8 frames 0..n-1 of the synthetic two-plane scene along its arc,
    as a camera delivers them, with the scene and the poses."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(300)
    frames = render_all(lambda R, t: np.clip(np.round(synthetic.render_image(scene, cam, R, t)),
                                             0, 255).astype(np.uint8), poses[:n])
    return frames, scene, poses


def phase2_slice(device, wm_mod, seq):
    """Track frames 1..24 against a 4096-point map from keyframes 0/10/20/30.
    Checks accuracy and the kernel's launch count, prints per-frame times and
    returns (launches, frame 1, the map)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import pose_opt
    from orb_slam3_comments_ghr_torch.pipeline import programs
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    host_frames, scene, poses = seq
    frames = [torch.from_numpy(f).to(device) for f in host_frames]
    kfs = (0, 10, 20, 30)
    kf_feats = [programs.extract_only(cam, frames[i]) for i in kfs]
    pts = synthetic.local_points_from_keyframes(
        cam, kf_feats, [poses[i] for i in kfs],
        [synthetic.depth_map(scene, cam, *poses[i]) for i in kfs], cap=4096)
    torch.cuda.synchronize()
    print(f"phase2 map: {int(pts.valid.sum())} local points from keyframes {kfs}")

    R = torch.from_numpy(poses[0][0]).to(device)
    t = torch.from_numpy(poses[0][1]).to(device)
    errs, inliers = [], []
    # the pose LM replayed from a CUDA graph, as the tracker runs it
    lm = pose_opt.PoseLMGraph()
    wm_mod.launches = 0
    for i in range(1, PHASE2_FRAMES + 1):
        _, res = programs.extract_and_track(cam, cam, frames[i], pts, R, t, lm_graph=lm)
        R, t = res.R, res.t
        Rn, tn = R.cpu().numpy(), t.cpu().numpy()
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            raise AssertionError(f"frame {i}: non-finite pose")
        errs.append(float(np.linalg.norm(camera_centre(Rn, tn) - camera_centre(*poses[i]))))
        inliers.append(int(res.n_inliers))
    torch.cuda.synchronize()
    launches = wm_mod.launches
    errs, inliers = np.asarray(errs), np.asarray(inliers)
    print(f"phase2 {PHASE2_FRAMES} frames: centre error median {np.median(errs) * 1e3:.3f} mm, "
          f"max {errs.max() * 1e3:.3f} mm; inliers min {inliers.min()}, "
          f"median {np.median(inliers):.0f}; window_match launches {launches}")
    if errs.max() >= 0.02:
        raise AssertionError(f"camera-centre error {errs.max():.4f} m >= 2 cm")
    if inliers.min() < 300:
        raise AssertionError(f"a frame has {inliers.min()} < 300 inliers")
    if launches != PHASE2_FRAMES:
        raise AssertionError(f"window_match launched {launches} times for {PHASE2_FRAMES} frames")

    # per-frame times after warm-up (the frames above), host clock with a
    # device sync around each call; each frame starts from the previous pose
    starts = [tuple(torch.from_numpy(a).to(device) for a in poses[i - 1])
              for i in range(PHASE2_FRAMES + 1)]
    ext, trk, fused = [], [], []
    for i in range(1, PHASE2_FRAMES + 1):
        box = {}
        ext.append(host_ms(lambda: box.update(f=programs.extract_only(cam, frames[i]))))
        trk.append(host_ms(lambda: programs.track_only(cam, box["f"], pts, *starts[i],
                                                       lm_graph=lm)))
        fused.append(host_ms(lambda: programs.extract_and_track(cam, cam, frames[i], pts,
                                                                *starts[i], lm_graph=lm)))
    print(f"phase2 per-frame ms over {PHASE2_FRAMES} frames (median / p75): " + ", ".join(
        f"{k} {np.median(v):.3f} / {np.percentile(v, 75):.3f}"
        for k, v in (("extract_only", ext), ("track_only", trk), ("extract_and_track", fused))))
    return launches, frames[1], pts


def phase3_against_cpu(device, frame, pts, pose):
    """The same frame through the port on the CPU (plain window match) and
    on the card: keypoints, descriptors and the tracked pose must agree."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import pose_opt
    from orb_slam3_comments_ghr_torch.pipeline import programs

    cam = cameras.euroc_cam0()
    cpu = torch.device("cpu")
    R0, t0 = (torch.from_numpy(a) for a in pose)
    lm = pose_opt.PoseLMGraph()  # replayed on the card, eager on the CPU
    f_g, r_g = programs.extract_and_track(cam, cam, frame, pts, R0.to(device), t0.to(device),
                                          lm_graph=lm)
    f_c, r_c = programs.extract_and_track(
        cam, cam, frame.to(cpu), type(pts)(*(x.to(cpu) for x in pts)), R0, t0, lm_graph=lm)
    lvl0 = (f_c.level == 0) & f_c.valid
    same_kp = bool(torch.equal(f_g.xy.cpu()[lvl0], f_c.xy[lvl0]))
    kp_share = float((f_g.xy.cpu() == f_c.xy).all(-1).float().mean())
    both = (f_g.xy.cpu() == f_c.xy).all(-1) & f_c.valid
    x = (f_g.desc.cpu()[both] ^ f_c.desc[both]).numpy().view(np.uint8)
    bit_rate = float(np.unpackbits(x).mean()) if x.size else 0.0
    dR = float((r_g.R.cpu() - r_c.R).abs().max())
    dt = float((r_g.t.cpu() - r_c.t).abs().max())
    print(f"phase3 card vs cpu: level-0 keypoints equal {same_kp}, keypoint share {kp_share:.4f}, "
          f"descriptor bit mismatch {bit_rate:.2e}, |dR| {dR:.2e}, |dt| {dt:.2e} m, "
          f"inliers {int(r_g.n_inliers)} vs {int(r_c.n_inliers)}")
    # the card's float sums run in another order: allow a few flipped bits and
    # keypoints, and sub-millimetre pose differences
    if not same_kp or kp_share < 0.95 or bit_rate > 1e-2 or dR > 1e-3 or dt > 1e-3:
        raise AssertionError("the card's result disagrees with the CPU port")


PHASE4_FRAMES = 120


def _count_calls(module, name: str, counts: dict, key, active: list):
    """Replace module.name by a wrapper that counts its calls under `key`
    (a string, or a function giving it at each call) and keeps that key on
    the stack `active` during the call; returns the original, to put
    back."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        k = key() if callable(key) else key
        counts[k] += 1
        active.append(k)
        try:
            return fn(*args, **kwargs)
        finally:
            active.pop()

    setattr(module, name, counted)
    return fn


# the call of each caller whose window-match arguments phase 4 keeps: the
# 60th tracking call (a frame well after init, the map grown), every init
# attempt (the last one kept: the attempt that initialized), the 40th fuse
RECORD_AT = {"tracking": 60, "init": None, "fuse": 40}
# the same in phases 5 and 6 (no two-view init there): the 60th tracking
# call and the last fuse of the run
RECORD_AT_DEPTH = {"tracking": 60, "fuse": None}


class ThreadStack:
    """A list of caller keys per thread, for `_count_calls` and
    `_recording`: the tracking thread and the mapping worker each see only
    their own callers."""

    def __init__(self):
        self._local = threading.local()

    def _list(self) -> list:
        if not hasattr(self._local, "items"):
            self._local.items = []
        return self._local.items

    def append(self, key):
        self._list().append(key)

    def pop(self):
        return self._list().pop()

    def __getitem__(self, i):
        return self._list()[i]

    def __bool__(self) -> bool:
        return bool(self._list())


def _recording(fn, calls: dict, active: list, recorded: dict, record_at: dict, prefix: str):
    """fn (window_match), keeping a device copy of its arguments, under
    prefix + caller, on the calls that record_at names, by the caller on top
    of `active`."""
    def recorded_fn(*args):
        key = active[-1] if active else None
        if key in record_at and record_at[key] in (None, calls[key]):
            recorded[prefix + key] = tuple(a.clone() for a in args)
        return fn(*args)

    return recorded_fn


def _count_matchers(wm_mod, calls: dict, active: list, recorded: dict, record_at: dict,
                    prefix: str = "", fuse_key="fuse"):
    """Count the calls of the window match's callers (tracking, init, and
    `programs.fuse_project` under `fuse_key`: "fuse", or a function that
    names the loop closer's callers) in `calls`, and record its arguments
    as `_recording` says. Returns what to put back: (module, name,
    original) triples."""
    from orb_slam3_comments_ghr_torch.ops import matching
    from orb_slam3_comments_ghr_torch.pipeline import programs

    originals = [
        (programs, "track_against_points",
         _count_calls(programs, "track_against_points", calls, "tracking", active)),
        # the deep pipeline's name for the same program
        (programs, "track_only", _count_calls(programs, "track_only", calls, "tracking", active)),
        (matching, "search_for_initialization",
         _count_calls(matching, "search_for_initialization", calls, "init", active)),
        (programs, "fuse_project", _count_calls(programs, "fuse_project", calls, fuse_key, active)),
    ]
    # where the callers look the window match up: programs' global, and the
    # module attribute that search_for_initialization imports at each call
    wm = wm_mod.window_match
    for module in (programs, wm_mod):
        originals.append((module, "window_match", module.window_match))
        module.window_match = _recording(wm, calls, active, recorded, record_at, prefix)
    return originals


def phase4_slam(wm_mod, seq):
    """`SLAM.track_monocular` over frames 0..119 (20 Hz timestamps) at the
    default, full-width configuration, loop closing off. Fails unless the
    run initializes, tracks >= 90 % of the frames after init, ends with >= 3
    keyframes and > 200 map points and a Sim(3)-aligned ATE < 5 cm, and the
    window match launched once per matcher call on its three paths. Returns
    the launch count, the SLAM object and the recorded window-match
    arguments ({caller: args on the card})."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    frames, _, poses = seq
    slam = SLAM(cameras.euroc_cam0(), SlamConfig(enable_loop_closing=False), device="cuda")
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    active, recorded = [], {}
    originals = _count_matchers(wm_mod, calls, active, recorded, RECORD_AT)
    kf_ms = []
    process_keyframe = slam.mapper.process_keyframe

    def timed_process_keyframe(kf):
        kf_ms.append(host_ms(lambda: process_keyframe(kf)))

    slam.mapper.process_keyframe = timed_process_keyframe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        tracked, plain_frame_ms, init_frame = [], [], None
        for i in range(PHASE4_FRAMES):
            box = {}
            frame_ms = host_ms(lambda: box.update(pose=slam.track_monocular(frames[i], i * 0.05)))
            pose = box["pose"]
            if pose is not None:
                if not np.isfinite(pose).all():
                    raise AssertionError(f"frame {i}: non-finite pose")
                if init_frame is None:
                    init_frame = i
                tracked.append(i)
            if init_frame is not None and i > init_frame and slam.tracker.pending_kf is None:
                plain_frame_ms.append(frame_ms)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    peak = torch.cuda.max_memory_allocated()
    if init_frame is None:
        raise AssertionError("phase4: the run never initialized")
    after = PHASE4_FRAMES - 1 - init_frame
    n_after = sum(1 for i in tracked if i > init_frame)
    ate = evaluation.ate_rmse(slam.trajectory(), synthetic.gt_trajectory(poses[:PHASE4_FRAMES]),
                              with_scale=True)
    print(f"phase4 {PHASE4_FRAMES} frames: initialized at frame {init_frame}, tracked "
          f"{n_after}/{after} after init, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, Sim(3)-aligned ATE {ate * 1e3:.3f} mm")
    print(f"phase4 window_match launches {launches}; matcher calls tracking {calls['tracking']}, "
          f"init {calls['init']}, fuse {calls['fuse']}")
    print(f"phase4 track_monocular ms on {len(plain_frame_ms)} frames without a keyframe "
          f"(median / p75): {np.median(plain_frame_ms):.3f} / {np.percentile(plain_frame_ms, 75):.3f}; "
          f"process_keyframe ms over {len(kf_ms)} keyframes (median / max): "
          f"{np.median(kf_ms):.3f} / {max(kf_ms):.3f}; max_memory_allocated {peak / 2**20:.1f} MiB")
    if n_after < 0.9 * after:
        raise AssertionError(f"phase4: tracked {n_after} of {after} frames after init (< 90 %)")
    if slam.n_keyframes() < 3 or slam.n_map_points() <= 200:
        raise AssertionError("phase4: the map has < 3 keyframes or <= 200 points")
    if not ate < 0.05:
        raise AssertionError(f"phase4: ATE {ate:.4f} m >= 5 cm")
    if calls["init"] == 0 or calls["fuse"] == 0:
        raise AssertionError("phase4: the init or the fuse path never ran")
    if launches != sum(calls.values()):
        raise AssertionError(f"phase4: {launches} launches for {sum(calls.values())} matcher calls")
    return launches, calls, slam, recorded


LOST_BLANK_FRAMES = 3
# (pose index, roll in degrees about the optical axis) of the frames after
# the blank ones: 70-79, 2.5 s of arc behind where tracking was lost, then a
# 36-frame jump ahead; then frame 100 rolled by 30 degrees, which the
# projection search cannot follow and the reference-keyframe fallback must
RETURN_POSES = [(j, 0.0) for j in (*range(70, 80), *range(115, 120))] \
    + [(100, 30.0), (101, 0.0), (102, 0.0)]
ROLLED_AT = LOST_BLANK_FRAMES + 15


def rolled_pose(pose, deg: float):
    """The pose turned by `deg` about its optical axis (same centre)."""
    a = np.radians(deg)
    Rz = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                  np.float32)
    return Rz @ pose[0], Rz @ pose[1]


def _count_outcomes(obj, name: str, counts: dict):
    """Replace obj.name by a wrapper that counts its calls and its truthy
    results under counts[name] = [calls, successes]."""
    fn = getattr(obj, name)
    counts[name] = [0, 0]

    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        counts[name][0] += 1
        counts[name][1] += bool(out)
        return out

    setattr(obj, name, counted)


def phase4_lost_and_back(wm_mod, slam, seq):
    """Continue phase 4's run: blank frames lose tracking, then the camera
    comes back at RETURN_POSES. Fails unless tracking is lost on the first
    blank frame, relocalization brings the state back to OK on the first
    returned frame, the reference-keyframe fallback tracks the rolled frame,
    >= 90 % of the returned frames are tracked, the Sim(3)-aligned ATE of the
    whole trajectory stays under 5 cm, and the window match launched once
    per matcher call in this window. Returns the launch count."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic

    frames, scene, poses = seq
    cam = cameras.euroc_cam0()
    back_poses = [rolled_pose(poses[j], deg) for j, deg in RETURN_POSES]
    inputs = [np.zeros_like(frames[0])] * LOST_BLANK_FRAMES + [
        frames[j] if deg == 0.0 else
        np.clip(np.round(synthetic.render_image(scene, cam, *pose)), 0, 255).astype(np.uint8)
        for (j, deg), pose in zip(RETURN_POSES, back_poses)]
    gt_poses = list(poses[:PHASE4_FRAMES]) + [poses[PHASE4_FRAMES - 1]] * LOST_BLANK_FRAMES \
        + back_poses
    calls, active = {"tracking": 0, "init": 0, "fuse": 0}, []
    originals = _count_matchers(wm_mod, calls, active, {}, {})
    outcomes = {}
    for name in ("_relocalize", "_track_reference_kf"):
        _count_outcomes(slam.tracker, name, outcomes)
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        states, tracked, fell_back = [], [], []
        for k, img in enumerate(inputs):
            before = outcomes["_track_reference_kf"][1]
            pose = slam.track_monocular(img, (PHASE4_FRAMES + k) * 0.05)
            states.append(slam.state)
            if outcomes["_track_reference_kf"][1] > before:
                fell_back.append(k)
            if pose is not None:
                if not np.isfinite(pose).all():
                    raise AssertionError(f"lost-and-back input {k}: non-finite pose")
                tracked.append(k)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        for name in outcomes:
            delattr(slam.tracker, name)
    back = [k for k in tracked if k >= LOST_BLANK_FRAMES]
    ate = evaluation.ate_rmse(slam.trajectory(), synthetic.gt_trajectory(gt_poses), with_scale=True)
    print(f"phase4 lost-and-back: states {' '.join(states)}")
    print(f"phase4 lost-and-back: tracked {len(back)}/{len(RETURN_POSES)} returned frames; "
          f"relocalize calls/successes {outcomes['_relocalize']}, reference-KF fallback "
          f"calls/successes {outcomes['_track_reference_kf']}; keyframes {slam.n_keyframes()}, "
          f"map points {slam.n_map_points()}, Sim(3)-aligned ATE of all frames {ate * 1e3:.3f} mm")
    print(f"phase4 lost-and-back: the fallback tracked inputs {fell_back} "
          f"(the rolled frame is input {ROLLED_AT})")
    print(f"phase4 lost-and-back window_match launches {launches}; matcher calls tracking "
          f"{calls['tracking']}, init {calls['init']}, fuse {calls['fuse']}")
    if states[0] != "RECENTLY_LOST" or any(k < LOST_BLANK_FRAMES for k in tracked):
        raise AssertionError("phase4 lost-and-back: the blank frames did not lose tracking")
    if states[LOST_BLANK_FRAMES] != "OK" or outcomes["_relocalize"][1] == 0:
        raise AssertionError("phase4 lost-and-back: relocalization did not bring tracking back")
    if ROLLED_AT not in fell_back or states[ROLLED_AT] != "OK":
        raise AssertionError("phase4 lost-and-back: the reference-keyframe fallback did not "
                             "track the rolled frame")
    if len(back) < 0.9 * len(RETURN_POSES):
        raise AssertionError(f"phase4 lost-and-back: tracked {len(back)} of {len(RETURN_POSES)} "
                             "returned frames (< 90 %)")
    if not ate < 0.05:
        raise AssertionError(f"phase4 lost-and-back: ATE {ate:.4f} m >= 5 cm")
    if launches != sum(calls.values()):
        raise AssertionError(f"phase4 lost-and-back: {launches} launches for "
                             f"{sum(calls.values())} matcher calls")
    return launches, calls


PHASE5_FRAMES = 120
# metric ATE bars (no scale fit) of tests/test_stereo.py and tests/test_rgbd.py
ATE_BAR = {"stereo": 0.06, "rgbd": 0.08}


def second_inputs(seq, mode: str) -> list:
    """Per frame the second input of `track_stereo` (the right view: a
    rectified rig, the camera b to the right, t_r = t - [b, 0, 0]) or of
    `track_rgbd` (the exact depth map)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    _, scene, poses = seq
    if mode == "rgbd":
        return render_all(lambda R, t: synthetic.depth_map(scene, cam, R, t),
                          poses[:PHASE5_FRAMES])
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    return render_all(lambda R, t: np.clip(np.round(synthetic.render_image(scene, cam, R, t - b)),
                                           0, 255).astype(np.uint8), poses[:PHASE5_FRAMES])


def phase_depth_slam(wm_mod, seq, second, mode: str):
    """`SLAM.track_stereo` (phase 5) or `SLAM.track_rgbd` (phase 6) over
    frames 0..119 (20 Hz timestamps) at the default, full-width
    configuration, loop closing on (the loop closer runs after each
    keyframe and stops at its 12-keyframe gate: these maps have fewer).
    Fails unless the run initializes on
    frame 0, tracks >= 90 % of the frames, ends with >= 3 keyframes and a
    metric ATE (no scale fit) under ATE_BAR, never calls the two-view init,
    and the window match launched once per tracking and fuse call. Returns
    (launches, the matcher calls, the recorded window-match arguments, the
    SLAM object, the per-frame ms without a keyframe)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation, synthetic

    frames, _, poses = seq
    sensor = config.STEREO if mode == "stereo" else config.RGBD
    slam = SLAM(cameras.euroc_cam0(), config.SlamConfig(sensor=sensor), device="cuda")
    track = slam.track_stereo if mode == "stereo" else slam.track_rgbd
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    active, recorded = [], {}
    originals = _count_matchers(wm_mod, calls, active, recorded, RECORD_AT_DEPTH, mode + " ")
    kf_ms = []
    process_keyframe = slam.mapper.process_keyframe
    slam.mapper.process_keyframe = lambda kf: kf_ms.append(host_ms(lambda: process_keyframe(kf)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        tracked, plain_frame_ms, init_frame, local_rows = [], [], None, []
        for i in range(PHASE5_FRAMES):
            box = {}
            frame_ms = host_ms(lambda: box.update(pose=track(frames[i], second[i], i * 0.05)))
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"{mode} frame {i}: non-finite pose")
                init_frame = i if init_frame is None else init_frame
                tracked.append(i)
            if init_frame is not None and i > init_frame and slam.tracker.pending_kf is None:
                plain_frame_ms.append(frame_ms)
            if slam.tracker._lp_cache is not None:
                local_rows.append(len(slam.tracker._lp_cache[2]))
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        del slam.mapper.process_keyframe
    peak = torch.cuda.max_memory_allocated()
    gt = synthetic.gt_trajectory(poses[:PHASE5_FRAMES])
    ate = evaluation.ate_rmse(slam.trajectory(), gt, with_scale=False)
    rec = recorded.get(mode + " tracking")
    searching = int((rec[2] > 0).sum()) if rec is not None else -1
    tag = f"phase{5 if mode == 'stereo' else 6} {mode}"
    print(f"{tag} {PHASE5_FRAMES} frames: initialized at frame {init_frame}, tracked "
          f"{len(tracked)}/{PHASE5_FRAMES}, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, metric ATE (no scale fit) {ate * 1e3:.3f} mm")
    print(f"{tag} local map rows (valid points of {slam.cfg.local_points_cap}) median "
          f"{np.median(local_rows):.0f}, max {max(local_rows)}; searching rows at the recorded "
          f"tracking call {searching}")
    print(f"{tag} window_match launches {launches}; matcher calls tracking {calls['tracking']}, "
          f"init {calls['init']}, fuse {calls['fuse']}")
    print(f"{tag} track_{mode} ms on {len(plain_frame_ms)} frames without a keyframe (median / "
          f"p75): {np.median(plain_frame_ms):.3f} / {np.percentile(plain_frame_ms, 75):.3f}; "
          f"process_keyframe ms over {len(kf_ms)} keyframes (median / max): "
          f"{np.median(kf_ms):.3f} / {max(kf_ms):.3f}; max_memory_allocated {peak / 2**20:.1f} MiB")
    if init_frame != 0:
        raise AssertionError(f"{tag}: initialized at frame {init_frame}, not 0")
    if len(tracked) < 0.9 * PHASE5_FRAMES:
        raise AssertionError(f"{tag}: tracked {len(tracked)} of {PHASE5_FRAMES} frames (< 90 %)")
    if slam.n_keyframes() < 3:
        raise AssertionError(f"{tag}: {slam.n_keyframes()} keyframes (< 3)")
    if not ate < ATE_BAR[mode]:
        raise AssertionError(f"{tag}: metric ATE {ate:.4f} m >= {ATE_BAR[mode]} m")
    if calls["init"] != 0 or calls["fuse"] == 0:
        raise AssertionError(f"{tag}: the two-view init ran, or the fuse never did")
    if launches != calls["tracking"] + calls["fuse"]:
        raise AssertionError(f"{tag}: {launches} launches for {calls['tracking']} tracking and "
                             f"{calls['fuse']} fuse calls")
    return launches, calls, recorded, slam, plain_frame_ms


def device_profile(fn, calls: int = 10) -> tuple[float, float]:
    """(device milliseconds, kernels and copies) per call of fn(): those of
    `calls` calls under torch.profiler (one stream: they do not overlap),
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    on_card = [e for e in prof.events() if e.device_type == cuda]
    us = sum(e.time_range.elapsed_us() for e in on_card)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / calls, len(on_card) / calls



def stage_times(label: str, fn, calls: int = 20) -> dict:
    """Host ms (median of `calls` calls, each ending in a sync), device ms
    and kernels and copies per call of fn, printed and returned."""
    t = {"host_ms": float(np.median([host_ms(fn) for _ in range(calls)]))}
    t["device_ms"], t["launches"] = device_profile(fn, max(3, calls // 2))
    print(f"  {label}: host {t['host_ms']:.3f} ms per call (median of {calls}, synchronized), "
          f"device {t['device_ms']:.4f} ms per call (torch.profiler), {t['launches']:.0f} kernels "
          f"and copies per call")
    return t


def depth_stages_against_cpu(device, seq, right, depth, slam):
    """On frame 60: `stereo_match` and `depth_to_stereo` on the card against
    the port on the CPU with the same features and images (matched set and
    u_right equal to 1e-3 px, depth to 1e-5 relative), and their times on
    the card; then what the stereo observations cost the tracking program:
    `track_against_points` on phase 5's last local map and pose with the
    frame's stereo features and with the same features as monocular
    (u_right -1), in turns. Returns {stage: times}."""
    from orb_slam3_comments_ghr_torch.frontend import stereo
    from orb_slam3_comments_ghr_torch.frontend.batched import extract_batched
    from orb_slam3_comments_ghr_torch.ops import cameras

    cam = cameras.euroc_cam0()
    cpu = torch.device("cpu")
    frames, _, _ = seq
    gl, gr = (torch.from_numpy(a).to(device) for a in (frames[60], right[60]))
    fl, fr = extract_batched(gl), extract_batched(gr)
    il, ir = gl.to(torch.float32), gr.to(torch.float32)
    dmap = torch.from_numpy(depth[60]).to(device)
    on_cpu = lambda feats: type(feats)(*(x.to(cpu) for x in feats))
    out = {}
    for name, card, host in (
            ("stereo_match", lambda: stereo.stereo_match(cam, fl, fr, il, ir),
             lambda: stereo.stereo_match(cam, on_cpu(fl), on_cpu(fr), il.cpu(), ir.cpu())),
            ("depth_to_stereo", lambda: stereo.depth_to_stereo(cam, fl, dmap),
             lambda: stereo.depth_to_stereo(cam, on_cpu(fl), dmap.cpu()))):
        (ur_g, d_g), (ur_c, d_c) = card(), host()
        ur_g, d_g = ur_g.cpu(), d_g.cpu()
        ok = ur_c >= 0
        du = float((ur_g - ur_c)[ok].abs().max()) if bool(ok.any()) else 0.0
        dd = float(((d_g - d_c) / d_c)[ok].abs().max()) if bool(ok.any()) else 0.0
        print(f"phase5 {name} card vs cpu on frame 60: matched {int((ur_g >= 0).sum())} vs "
              f"{int(ok.sum())}, max |du_right| {du:.2e} px, max relative depth difference {dd:.2e}")
        if not torch.equal(ur_g >= 0, ok) or du > 1e-3 or dd > 1e-5:
            raise AssertionError(f"{name}: the card disagrees with the CPU port")
        out[name] = stage_times(name, card)

    from orb_slam3_comments_ghr_torch.pipeline import programs

    lp, _ = slam.tracker._local_points_view()
    R, t = (torch.from_numpy(a).to(device) for a in (slam.tracker.last_R, slam.tracker.last_t))
    ur, d = stereo.stereo_match(cam, fl, fr, il, ir)
    feats = {"stereo": fl._replace(u_right=ur, depth=d),
             "as mono": fl._replace(u_right=torch.full_like(ur, -1.0))}
    ms = {k: [] for k in feats}
    lm = slam.tracker._pose_lm  # the pose LM's graph, as the tracker replays it
    for k in ("stereo", "as mono", "as mono", "stereo") * 5:
        ms[k].append(host_ms(lambda: programs.track_against_points(cam, feats[k], lp, R, t,
                                                                   lm_graph=lm)))
    for k, v in ms.items():
        device = device_profile(lambda: programs.track_against_points(cam, feats[k], lp, R, t,
                                                                      lm_graph=lm))[0]
        out[f"track_against_points {k}"] = {"host_ms": float(np.median(v)), "device_ms": device}
    print("phase5 track_against_points on the last local map, host ms (median of 10, in turns) / "
          "device ms: " + ", ".join(f"{k} {out[f'track_against_points {k}']['host_ms']:.3f} / "
                                     f"{out[f'track_against_points {k}']['device_ms']:.3f}"
                                     for k in feats))
    return out


# EuRoC MH cam0 / cam1 raw calibration (sensor.yaml) and an extrinsic close
# to the real rig's (T_c1_c2: ~11 cm along x)
EUROC_RAW = (
    dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
         k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05),
    dict(fx=457.587, fy=456.134, cx=379.999, cy=255.238,
         k1=-0.28368365, k2=0.07451284, p1=-0.00010473, p2=-3.55590700e-05),
)


def rectify_clahe_against_cpu(device, seq, right):
    """Stereo rectification (the EuRoC rig's maps) and CLAHE of frame 60 on
    the card against the port on the CPU: equal to 1e-3 grey levels (the
    card contracts products and sums into fused multiply-adds). Returns
    {stage: times}."""
    from orb_slam3_comments_ghr_torch.frontend.clahe import clahe
    from orb_slam3_comments_ghr_torch.io import rectify
    from orb_slam3_comments_ghr_torch.ops import lie

    R12 = lie.so3_exp(torch.tensor([0.003, -0.002, 0.001])).numpy()
    rig = rectify.build_rectifier(*EUROC_RAW, R12, np.array([0.1101, -0.0002, 0.0003]), 752, 480)
    img_l, img_r = seq[0][60], right[60]
    gl, gr = (torch.from_numpy(a).to(device) for a in (img_l, img_r))
    out = {}
    for name, card, host in (
            ("rectify", lambda: rig.rectify(gl, gr), lambda: rig.rectify(img_l, img_r, device="cpu")),
            ("clahe", lambda: (clahe(gl),), lambda: (clahe(torch.from_numpy(img_l)),))):
        diff = max(float((g.cpu() - c).abs().max()) for g, c in zip(card(), host()))
        print(f"phase6 {name} card vs cpu on frame 60: max |difference| {diff:.2e} grey levels")
        if diff > 1e-3:
            raise AssertionError(f"{name}: the card disagrees with the CPU port")
        out[name] = stage_times(name, card)
    return out


PHASE7_FRAMES = 150
# the near-ideal IMU calibration of bench.py's stereo-inertial pass and of
# tests/test_vi_*.py: noise densities 1e-4 / 1e-3, walks 1e-6 / 1e-5
IMU_NOISE = dict(noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
# the calls of phase 7 whose window-match arguments are kept: the 100th
# tracking call (after the IMU init, which lands near frame 35: its windows
# are 4x wider) and the last fuse
RECORD_AT_VI = {"tracking": 100, "fuse": None}
# frames of phase 7 run under torch.cuda.set_sync_debug_mode("warn"): each
# host sync they make is counted by the line of the port that made it (the
# frames are left out of the per-frame times)
SYNC_PROBE_FRAMES = (120, 121, 122)


def imu_calib():
    from orb_slam3_comments_ghr_torch.optim import imu as imu_mod

    return imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                            **IMU_NOISE)


def vi_inputs(n: int, scene_seed: int, second: str):
    """Frames 0..n-1 of `vi_sequence(n)` over `make_textured_scene(scene_seed)`:
    (left uint8 frames, second inputs (the right view of a rectified rig, t_r
    = t - [b, 0, 0], as bench.py renders its stereo-inertial input; or the
    exact depth map), per-frame IMU rows in (t_{i-1}, t_i], timestamps,
    poses)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    scene = synthetic.make_textured_scene(scene_seed)
    poses, imu_rows, times = synthetic.vi_sequence(n)
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    left = render_all(lambda R, t: u8(synthetic.render_image(scene, cam, R, t)), poses)
    if second == "right":
        sec = render_all(lambda R, t: u8(synthetic.render_image(scene, cam, R, t - b)), poses)
    else:
        sec = render_all(lambda R, t: synthetic.depth_map(scene, cam, R, t), poses)
    rows = [imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0)) & (imu_rows[:, 0] <= times[i])]
            for i in range(n)]
    return left, sec, rows, times, poses


def vi_gt(poses, times) -> list:
    return [(times[i], np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))
            for i, (R, t) in enumerate(poses)]


def _keep_call(module, name: str, box: dict, key: str, which):
    """Replace module.name by a wrapper that keeps (args, kwargs) of the
    call for which which(call index from 1, box) is true under box[key];
    returns the original."""
    fn = getattr(module, name)
    count = [0]

    def kept(*args, **kwargs):
        count[0] += 1
        if key not in box and which(count[0], box):
            box[key] = (args, kwargs)
        return fn(*args, **kwargs)

    setattr(module, name, kept)
    return fn


def phase7_stereo_inertial(wm_mod, device):
    """Stereo-inertial `SLAM.track_stereo` with the IMU rows over
    PHASE7_FRAMES frames at the stereo-inertial configuration of bench.py
    (1024 features, local map 4096, local BA 2048 points, a keyframe at
    least every 10 frames, loop closing and asynchronous mapping off). Fails
    unless the IMU initializes, >= 95 % of the frames are tracked, the
    metric ATE (no scale fit) of `SLAM.trajectory()` is < 8 cm (the bar of
    tests/test_vi_stereo.py), the two-view init never runs, and the window
    match launched once per tracking and fuse call. Returns (launches, the
    matcher calls, the recorded window-match arguments, the per-frame times,
    the stage times)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import imu as imu_mod, inertial, vi_ba
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation

    left, right, rows, times, poses = vi_inputs(PHASE7_FRAMES, 7, "right")
    cfg = config.SlamConfig(sensor=config.IMU_STEREO, n_features=1024, local_points_cap=4096,
                            local_ba_points=2048, max_frames_between_kf=10, min_init_matches=60,
                            enable_loop_closing=False)
    slam = SLAM(cameras.euroc_cam0(), cfg, imu_calib=imu_calib(), device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    active, recorded = [], {}
    originals = _count_matchers(wm_mod, calls, active, recorded, RECORD_AT_VI, "stereo-inertial ")
    # the inputs of one call of each inertial stage, replayed for its times
    # below: a frame's preintegration and the VI refinement after the IMU
    # init, the initializing inertial_init, the first inertial local BA
    kept = {}
    imu_ready = lambda: slam.map.map_imu_init.get(slam.map.active_map, False)
    originals += [
        (imu_mod, "preintegrate", _keep_call(imu_mod, "preintegrate", kept, "preintegrate",
                                             lambda i, b: imu_ready() and i > 60)),
        (slam.tracker, "_pose_inertial", _keep_call(
            slam.tracker, "_pose_inertial", kept, "pose_inertial_optimize",
            lambda i, b: i == 10)),
        (inertial, "inertial_init", _keep_call(inertial, "inertial_init", kept, "inertial_init",
                                               lambda i, b: not imu_ready())),
        (vi_ba, "vi_bundle_adjust", _keep_call(vi_ba, "vi_bundle_adjust", kept, "vi_bundle_adjust",
                                               lambda i, b: i >= 2)),
    ]
    stage_ms = {k: [] for k in ("tracker._vi_refine", "mapper.maybe_initialize_imu",
                                "mapper.local_ba (inertial)", "process_keyframe")}

    def host_timed(obj, name, key, when=lambda: True):
        fn = getattr(obj, name)

        def timed(*args):
            box = {}
            ms = host_ms(lambda: box.update(out=fn(*args)))
            if when():
                stage_ms[key].append(ms)
            return box["out"]

        setattr(obj, name, timed)

    # these stages end in a device->host copy already: the sync adds nothing
    host_timed(slam.tracker, "_vi_refine", "tracker._vi_refine")
    host_timed(slam.mapper, "maybe_initialize_imu", "mapper.maybe_initialize_imu")
    host_timed(slam.mapper, "local_ba", "mapper.local_ba (inertial)", imu_ready)
    host_timed(slam.mapper, "process_keyframe", "process_keyframe")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        tracked, frame_ms, init_frame, imu_frame = [], {False: [], True: []}, None, None
        syncs = collections.Counter()
        for i in range(PHASE7_FRAMES):
            box = {}
            ready = imu_ready()
            step = lambda: box.update(pose=slam.track_stereo(left[i], right[i], times[i],
                                                             imu_samples=rows[i]))
            if i in SYNC_PROBE_FRAMES:
                syncs.update(count_syncs(step))
                ms = None
            else:
                ms = host_ms(step)
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"stereo-inertial frame {i}: non-finite pose")
                init_frame = i if init_frame is None else init_frame
                tracked.append(i)
            if imu_frame is None and imu_ready():
                imu_frame = i
            if (ms is not None and init_frame is not None and i > init_frame
                    and slam.tracker.pending_kf is None):
                frame_ms[ready].append(ms)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        for name in ("_vi_refine",):
            delattr(slam.tracker, name)
        for name in ("maybe_initialize_imu", "local_ba", "process_keyframe"):
            delattr(slam.mapper, name)
    peak = torch.cuda.max_memory_allocated()
    ate = evaluation.ate_rmse(slam.trajectory(), vi_gt(poses, times), with_scale=False)
    rec = recorded.get("stereo-inertial tracking")
    print(f"phase7 stereo-inertial {PHASE7_FRAMES} frames: initialized at frame {init_frame}, IMU "
          f"initialized at frame {imu_frame}, VIBA1 {slam.mapper.viba1_done}, tracked "
          f"{len(tracked)}/{PHASE7_FRAMES}, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, metric ATE (no scale fit) {ate * 1e3:.3f} mm")
    if rec is not None:
        print(f"phase7 recorded tracking call {RECORD_AT_VI['tracking']}: searching rows "
              f"{int((rec[2] > 0).sum())}, median radius {float(rec[2][rec[2] > 0].median()):.2f} px")
    print(f"phase7 window_match launches {launches}; matcher calls tracking {calls['tracking']}, "
          f"init {calls['init']}, fuse {calls['fuse']}")
    frames = {}
    for ready, v in frame_ms.items():
        key = "imu_ready" if ready else "before_imu_init"
        frames[key] = {"n": len(v), "median_ms": float(np.median(v)) if v else None,
                       "p75_ms": float(np.percentile(v, 75)) if v else None}
        print(f"phase7 track_stereo ms on {len(v)} frames without a keyframe, {key} (median / "
              f"p75): " + (f"{np.median(v):.3f} / {np.percentile(v, 75):.3f}" if v else "none"))
    for key, v in stage_ms.items():
        print(f"phase7 {key} host ms over {len(v)} calls (median / max): "
              + (f"{np.median(v):.3f} / {max(v):.3f}" if v else "none"))
    print(f"phase7 max_memory_allocated {peak / 2**20:.1f} MiB")
    n_probe = len([i for i in SYNC_PROBE_FRAMES if i < PHASE7_FRAMES])
    print(f"phase7 host syncs per IMU-ready frame (frames {SYNC_PROBE_FRAMES}, "
          f"set_sync_debug_mode): {sum(syncs.values()) / max(n_probe, 1):.1f}; by line of the "
          "port: " + ", ".join(f"{k} {v / max(n_probe, 1):.1f}" for k, v in syncs.most_common()))
    if imu_frame is None:
        raise AssertionError("phase7: the IMU never initialized")
    if len(tracked) < 0.95 * PHASE7_FRAMES:
        raise AssertionError(f"phase7: tracked {len(tracked)} of {PHASE7_FRAMES} frames (< 95 %)")
    if not ate < 0.08:
        raise AssertionError(f"phase7: metric ATE {ate:.4f} m >= 8 cm")
    if calls["init"] != 0 or calls["fuse"] == 0:
        raise AssertionError("phase7: the two-view init ran, or the fuse never did")
    if launches != calls["tracking"] + calls["fuse"]:
        raise AssertionError(f"phase7: {launches} launches for {calls['tracking']} tracking and "
                             f"{calls['fuse']} fuse calls")
    if rec is None or RECORD_AT_VI["tracking"] <= imu_frame:
        raise AssertionError("phase7: the recorded tracking call is not after the IMU init")
    missing = {"preintegrate", "pose_inertial_optimize", "inertial_init",
               "vi_bundle_adjust"} - set(kept)
    if missing:
        raise AssertionError(f"phase7: the run never called {sorted(missing)}")

    # each inertial stage again on its kept inputs: host and device ms and
    # kernels per call (the calls are pure functions of their inputs); the
    # VI refinement eagerly and as the tracker runs it, from a CUDA graph
    print("phase7 inertial stages on kept inputs:")
    stages = {}
    graph = inertial.PoseInertialGraph()
    for key, fn in (("preintegrate", imu_mod.preintegrate),
                    ("pose_inertial_optimize", lambda *a: inertial.pose_inertial_optimize(*a, None)),
                    ("pose_inertial_optimize (CUDA graph)", graph),
                    ("inertial_init", inertial.inertial_init),
                    ("vi_bundle_adjust", vi_ba.vi_bundle_adjust)):
        args, kwargs = kept[key.split(" ")[0]]
        n = 20 if key.startswith(("preintegrate", "pose_inertial_optimize")) else 5
        stages[key] = stage_times(f"{key} {_describe(key.split(' ')[0], args, kwargs)}",
                                  lambda: fn(*args, **kwargs), calls=n)
    stages["pose_inertial_optimize (CUDA graph)"]["max_abs_err"] = graph_against_eager(
        graph, kept["pose_inertial_optimize"][0])
    stages.update({f"{k} in the run": {"host_ms_median": float(np.median(v)) if v else None,
                                       "calls": len(v)} for k, v in stage_ms.items()})
    result = dict(init_frame=init_frame, imu_init_frame=imu_frame,
                  viba1=bool(slam.mapper.viba1_done), tracked=len(tracked),
                  keyframes=slam.n_keyframes(), points=slam.n_map_points(), ate_m=ate,
                  peak_mib=peak / 2**20, frames=frames,
                  syncs_per_frame={k: v / max(n_probe, 1) for k, v in syncs.items()})
    return launches, calls, recorded, result, stages


def graph_against_eager(graph, args) -> float:
    """The CUDA-graph replay of the VI refinement against the eager call on
    the same inputs: the same inliers, and the state within 1e-5 (the same
    kernels; cuBLAS may pick another algorithm inside a capture). Returns
    the largest state difference."""
    from orb_slam3_comments_ghr_torch.optim import inertial

    eager = inertial.pose_inertial_optimize(*args, None)
    replay = graph(*args)
    if not (torch.equal(eager[1], replay[1]) and int(eager[2]) == int(replay[2])):
        raise AssertionError("phase7: the CUDA-graph refinement's inliers differ from the eager "
                             "call's")
    err = max(float((a - b).abs().max()) for a, b in zip(eager[0], replay[0]))
    print(f"phase7 pose_inertial_optimize CUDA graph against eager: inliers equal "
          f"({int(eager[2])}), state max abs difference {err:.3e}")
    if not err <= 1e-5:
        raise AssertionError("phase7: the CUDA-graph refinement disagrees with the eager call")
    return err


def count_syncs(fn, by_line: bool = True) -> collections.Counter:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"); count the
    host syncs it made by the innermost line of the port on the stack (or,
    without `by_line`, all under "all", which costs no stack walk)."""
    import traceback
    import warnings

    where = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if not by_line:
            where["all"] += 1
            return
        frames = [f for f in traceback.extract_stack()
                  if "orb_slam3_comments_ghr_torch" in f.filename]
        at = frames[-1] if frames else None
        where[f"{at.filename.split('orb_slam3_comments_ghr_torch/')[-1]}:{at.lineno}"
              if at else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def _describe(key: str, args, kwargs) -> str:
    """Shape of a kept call, for the printed stage line."""
    if key == "preintegrate":
        return f"({args[0].shape[0]} samples)"
    if key == "pose_inertial_optimize":
        return f"({args[4].p_world.shape[0]} rows, {int(args[4].valid.sum())} valid)"
    if key == "inertial_init":
        return f"({args[0].Rwb.shape[0]} keyframes)"
    return f"({args[1].Rwb.shape[0]} keyframes, {int(args[1].p_valid.sum())} points, " \
           f"{kwargs.get('iters', 10)} iterations)"


PHASE8_FRAMES = 60


def phase8_rgbd_inertial(wm_mod, device):
    """RGB-D-inertial `SLAM.track_rgbd` with the IMU rows and the exact
    depth maps over PHASE8_FRAMES frames of `make_textured_scene(61)`, the
    configuration of tests/test_rgbd_inertial.py. Fails unless the IMU
    initializes, > 45 frames are tracked, the metric ATE is < 12 cm (that
    test's bars), and the window match launched once per tracking and fuse
    call. Returns (launches, the matcher calls, the results)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation

    img, depth, rows, times, poses = vi_inputs(PHASE8_FRAMES, 61, "depth")
    cfg = config.SlamConfig(sensor=config.IMU_RGBD, n_features=768, local_points_cap=2048,
                            local_ba_points=2048, max_frames_between_kf=5,
                            enable_loop_closing=False)
    slam = SLAM(cameras.euroc_cam0(), cfg, imu_calib=imu_calib(), device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    originals = _count_matchers(wm_mod, calls, [], {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        tracked, imu_frame = 0, None
        for i in range(PHASE8_FRAMES):
            pose = slam.track_rgbd(img[i], depth[i], times[i], imu_samples=rows[i])
            if pose is not None:
                if not np.isfinite(pose).all():
                    raise AssertionError(f"rgbd-inertial frame {i}: non-finite pose")
                tracked += 1
            if imu_frame is None and slam.map.map_imu_init.get(slam.map.active_map, False):
                imu_frame = i
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    ate = evaluation.ate_rmse(slam.trajectory(), vi_gt(poses, times), with_scale=False)
    print(f"phase8 rgbd-inertial {PHASE8_FRAMES} frames: IMU initialized at frame {imu_frame}, "
          f"tracked {tracked}/{PHASE8_FRAMES}, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, metric ATE (no scale fit) {ate * 1e3:.3f} mm; window_match "
          f"launches {launches}; matcher calls tracking {calls['tracking']}, init {calls['init']}, "
          f"fuse {calls['fuse']}")
    if imu_frame is None:
        raise AssertionError("phase8: the IMU never initialized")
    if tracked <= 45 or not ate < 0.12:
        raise AssertionError(f"phase8: tracked {tracked} (<= 45) or metric ATE {ate:.4f} m >= 12 cm")
    if calls["init"] != 0 or launches != calls["tracking"] + calls["fuse"]:
        raise AssertionError(f"phase8: {launches} launches for {calls} matcher calls")
    return launches, calls, dict(imu_init_frame=imu_frame, tracked=tracked,
                                 keyframes=slam.n_keyframes(), points=slam.n_map_points(), ate_m=ate)


PHASE9_FRAMES = 80


def phase9_mono_inertial(wm_mod, device):
    """Mono-inertial `SLAM.track_features` over PHASE9_FRAMES frames of
    rendered features (512, `render_features` of `make_world(31)`), the
    configuration of tests/test_vi_pipeline.py: two-view init, then the IMU
    init with the scale (`optimize_scale`). Fails unless the IMU
    initializes, > 60 frames are tracked, and after the init the
    Sim(3)-aligned ATE is < 8 cm and the metric ATE < 25 cm (that test's
    bars), and the window match launched once per matcher call. Returns
    (launches, the matcher calls, the results)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation, synthetic

    cam = cameras.euroc_cam0()
    world = synthetic.make_world(31, n_points=3000)
    poses, imu_rows, times = synthetic.vi_sequence(PHASE9_FRAMES)
    cfg = config.SlamConfig(sensor=config.IMU_MONOCULAR, n_features=512, local_points_cap=2048,
                            local_ba_points=2048, max_frames_between_kf=5, min_init_matches=60,
                            enable_loop_closing=False)
    slam = SLAM(cam, cfg, imu_calib=imu_calib(), device=device)
    feats = [synthetic.render_features(world, cam, R, t, n_feat=512, seed=4100 + i, device=device)[0]
             for i, (R, t) in enumerate(poses)]
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    originals = _count_matchers(wm_mod, calls, [], {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        est = []
        for i in range(PHASE9_FRAMES):
            chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0))
                             & (imu_rows[:, 0] <= times[i])]
            if len(chunk):
                slam.feed_imu(chunk)
            pose = slam.track_features(feats[i], times[i])
            if pose is not None:
                if not np.isfinite(pose).all():
                    raise AssertionError(f"mono-inertial frame {i}: non-finite pose")
                est.append((times[i], pose))
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    t_init = slam.mapper.t_imu_init
    if t_init is None or not slam.map.map_imu_init.get(slam.map.active_map, False):
        raise AssertionError("phase9: the IMU never initialized")
    est_post = [(t, T) for t, T in est if t > t_init]
    gt_post = [(t, T) for t, T in vi_gt(poses, times) if t > t_init]
    scaled = evaluation.ate_rmse(est_post, gt_post, with_scale=True)
    metric = evaluation.ate_rmse(est_post, gt_post, with_scale=False)
    print(f"phase9 mono-inertial {PHASE9_FRAMES} frames: IMU initialized at t = {t_init:.2f} s, "
          f"tracked {len(est)}/{PHASE9_FRAMES}, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, after the IMU init Sim(3)-aligned ATE {scaled * 1e3:.3f} mm, "
          f"metric ATE {metric * 1e3:.3f} mm; window_match launches {launches}; matcher calls "
          f"tracking {calls['tracking']}, init {calls['init']}, fuse {calls['fuse']}")
    if len(est) <= 60 or not scaled < 0.08 or not metric < 0.25:
        raise AssertionError(f"phase9: tracked {len(est)} (<= 60), or ATE {scaled:.4f} m "
                             f"(Sim(3)) / {metric:.4f} m (metric) over 8 / 25 cm")
    if calls["init"] == 0 or launches != sum(calls.values()):
        raise AssertionError(f"phase9: {launches} launches for {calls} matcher calls")
    return launches, calls, dict(t_imu_init=t_init, tracked=len(est),
                                 keyframes=slam.n_keyframes(), points=slam.n_map_points(),
                                 ate_sim3_m=scaled, ate_metric_m=metric)


PHASE10_FEATURE_FRAMES = 160
PHASE10_IMAGE_FRAMES = 150
# the loop closer's window-match callers, both through programs.fuse_project:
# run (c) keeps the arguments of the last projection count and of the first
# fuse of the loop correction (into the keyframe that closed the loop), for
# phase 1
RECORD_AT_LOOP = {"loop_count": None, "loop_fuse": 1}
LOOP_CALLERS = (("_count_projection_matches", "loop_count"), ("_fuse_points_into", "loop_fuse"))
# the loop closer's stages timed in run (c), with the whole-map BA
LOOP_STAGES = ("_detect", "_verify_sim3", "_count_projection_matches", "_correct_loop",
               "_optimize_essential_graph", "_fuse_points_into")


def _count_loop_matchers(wm_mod, slam, calls: dict, recorded: dict, record_at: dict,
                         prefix: str = ""):
    """`_count_matchers` for a SLAM with loop closing: a fuse_project call
    made inside the loop closer's `_count_projection_matches` or
    `_fuse_points_into` counts under "loop_count" / "loop_fuse", any other
    under "fuse". Returns a function that puts everything back. The
    caller stacks are per thread (`ThreadStack`): with asynchronous mapping
    the loop closer's and the mapper's calls come from the worker thread
    while the tracker's come from the caller's."""
    ctx, active = ThreadStack(), ThreadStack()
    originals = _count_matchers(wm_mod, calls, active, recorded, record_at, prefix,
                                fuse_key=lambda: ctx[-1] if ctx else "fuse")
    lc = slam.loopcloser
    for name, key in LOOP_CALLERS:
        fn = getattr(lc, name)

        def in_ctx(*args, _fn=fn, _key=key):
            ctx.append(_key)
            try:
                return _fn(*args)
            finally:
                ctx.pop()

        setattr(lc, name, in_ctx)

    def restore():
        for module, name, fn in originals:
            setattr(module, name, fn)
        for name, _ in LOOP_CALLERS:
            vars(lc).pop(name, None)

    return restore


def _loop_cfg(**widths):
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    return SlamConfig(max_frames_between_kf=5, **widths)


def _check_launches(tag: str, launches: int, calls: dict):
    print(f"{tag} window_match launches {launches}; matcher calls "
          + ", ".join(f"{k} {v}" for k, v in calls.items()))
    if launches != sum(calls.values()):
        raise AssertionError(f"{tag}: {launches} launches for {sum(calls.values())} matcher calls")


def phase10_feature_loop(wm_mod, device, voc_path=None, tag="phase10 (a)"):
    """Run (a), the loop of tests/test_loopclosing.py through the port with
    loop closing on: 160 frames of 512 rendered features (ring world 13,
    an outward circle of 1.06 turns, 0.7 px noise), `track_features`.
    Fails unless a loop or merge closes, > 70 poses come back, the
    Sim(3)-aligned ATE is < 8 cm, every point is finite, and the window match
    launched once per matcher call. `voc_path` is `SlamConfig.voc_path`
    (None: the shipped 10k-word tree); `tag` heads its lines."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic

    cam = cameras.euroc_cam0()
    world = synthetic.make_ring_world(13)
    poses = synthetic.circular_trajectory(PHASE10_FEATURE_FRAMES, arc=1.06, outward=True)
    feats = [synthetic.render_features(world, cam, R, t, n_feat=512, seed=1300 + i, noise_px=0.7,
                                       device=device)[0] for i, (R, t) in enumerate(poses)]
    slam = SLAM(cam, _loop_cfg(n_features=512, local_points_cap=2048, local_ba_points=2048,
                               min_init_matches=60, voc_path=voc_path), device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        est = []
        for i in range(PHASE10_FEATURE_FRAMES):
            pose = slam.track_features(feats[i], i * 0.05)
            if pose is not None:
                est.append((i * 0.05, pose))
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
    lc = slam.loopcloser
    ate = evaluation.ate_rmse(est, synthetic.gt_trajectory(poses), with_scale=True)
    finite = bool(np.isfinite(slam.map.mp_pos[slam.map.mp_ids()]).all())
    print(f"{tag} feature loop {PHASE10_FEATURE_FRAMES} frames, a {slam.voc.n_words}-word "
          f"vocabulary: poses {len(est)}, loops "
          f"{lc.n_loops}, merges {lc.n_merges}, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, Sim(3)-aligned ATE {ate * 1e3:.3f} mm, points finite {finite}, "
          f"state {slam.state}")
    _check_launches(tag, launches, calls)
    if lc.n_loops + lc.n_merges < 1 or len(est) <= 70 or not ate < 0.08 or not finite:
        raise AssertionError(f"{tag}: no loop or merge, <= 70 poses, ATE >= 8 cm, or "
                             "a non-finite point")
    if calls["loop_count"] == 0 or calls["loop_fuse"] == 0:
        raise AssertionError(f"{tag}: a loop-closer caller never ran")
    return launches, calls, dict(poses=len(est), loops=lc.n_loops, merges=lc.n_merges, ate_m=ate,
                                 n_words=slam.voc.n_words,
                                 keyframes=slam.n_keyframes(), points=slam.n_map_points())


def phase10_merge(wm_mod, device):
    """Run (b), the kidnap of tests/test_merge.py: ring world 23, frames
    0-59, 14 blank frames (a new sub-map opens), then poses 5-55 again.
    Fails unless >= 4 keyframes precede the kidnap, >= 2 maps follow it,
    > 20 returned frames are tracked, and the sub-map is merged back or the
    tracker relocalizes into map 0; and the window match launched once per
    matcher call."""
    from orb_slam3_comments_ghr_torch.frontend.types import empty_features
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    world = synthetic.make_ring_world(23)
    poses = synthetic.circular_trajectory(160, arc=1.0, outward=True)
    render = lambda i, seed: synthetic.render_features(world, cam, *poses[i], n_feat=512, seed=seed,
                                                       device=device)[0]
    first = [render(i, 2300 + i) for i in range(60)]
    again = [render(i, 9300 + i) for i in range(5, 56)]
    slam = SLAM(cam, _loop_cfg(n_features=512, local_points_cap=2048, local_ba_points=2048,
                               min_init_matches=60, recently_lost_secs=0.4, loop_min_kfs=8),
                device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        for i, f in enumerate(first):
            slam.track_features(f, i * 0.05)
        kfs_before = slam.n_keyframes()
        blank = empty_features(512, device=device)
        for j in range(14):
            slam.track_features(blank, 3.0 + j * 0.05)
        maps = slam.map.n_maps
        tracked = sum(slam.track_features(f, 4.0 + j * 0.05) is not None
                      for j, f in enumerate(again))
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
    lc = slam.loopcloser
    print(f"phase10 (b) kidnap and merge: keyframes before the kidnap {kfs_before}, maps after it "
          f"{maps}, returned frames tracked {tracked}/{len(again)}, merges {lc.n_merges}, loops "
          f"{lc.n_loops}, active map {slam.map.active_map} of {slam.map.n_maps}")
    _check_launches("phase10 (b)", launches, calls)
    if kfs_before < 4 or maps < 2 or tracked <= 20:
        raise AssertionError("phase10 (b): < 4 keyframes, no new sub-map, or <= 20 frames tracked")
    if not (lc.n_merges >= 1 or slam.map.active_map == 0):
        raise AssertionError("phase10 (b): neither merged nor relocalized into map 0")
    return launches, calls, dict(kfs_before=kfs_before, maps_after_kidnap=maps, tracked=tracked,
                                 merges=lc.n_merges, active_map=int(slam.map.active_map))


def _snapshot_db(db):
    """A copy of a keyframe database's state (the vocabulary shared)."""
    out = copy.copy(db)
    out.present = db.present.copy()
    for k in ("kf_words", "kf_weights", "kf_word", "kf_node"):
        setattr(out, k, dict(getattr(db, k)))
    out.inv = {w: list(v) for w, v in db.inv.items()}
    return out


def _loop_replayer(cam, cfg, snap, device):
    """A function making a LoopCloser (with its mapper) on a fresh copy of
    the map `snap["map"]` and a copy of the database, pending hypotheses and
    generator state of `snap`."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.pipeline.loopcloser import LoopCloser
    from orb_slam3_comments_ghr_torch.pipeline.mapper import LocalMapper

    def make():
        m = convert.map_state_from_numpy(snap["map"])
        db = _snapshot_db(snap["db"]) if snap.get("db") is not None else None
        lc = LoopCloser(cam, cfg, m, db, LocalMapper(cam, cfg, m, kfdb=db, device=device),
                        device=device)
        lc._pendings = copy.deepcopy(snap.get("pendings", []))
        if "generator" in snap:
            lc.generator.set_state(snap["generator"])
        return lc

    return make


def phase10_image_loop(wm_mod, device):
    """Run (c), the image-level loop of tests/test_image_loopclosing.py:
    150 EuRoC cam0 frames (752x480) rendered in room scene 33 along a full
    outward circle, `track_monocular` with that test's configuration (768
    features, local map 2048, local BA 1024 points): the full front end,
    local mapping and the loop closer. Fails unless > 75 % of the frames
    are tracked, one map remains, a loop closes, the Sim(3)-aligned ATE of
    `trajectory()` is < 15 cm, and the window match launched once per
    matcher call. Times per-frame host ms, the loop closer's stages in the
    run, and each stage's device ms and kernels on its inputs in the
    keyframe that closed the loop (replayed, with the host syncs of that
    keyframe counted). Returns (launches, calls, recorded arguments,
    results, stage times)."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, gt_replay, synthetic

    cam = cameras.euroc_cam0()
    poses = synthetic.circular_trajectory(PHASE10_IMAGE_FRAMES, arc=1.0, outward=True)
    centers = np.stack([-R.T @ t for R, t in poses])
    scene = gt_replay.make_room_scene(33, centers, margin=4.0, span=20.0)
    t0 = time.perf_counter()
    frames = render_all(lambda R, t: gt_replay.render_room(scene, cam, R, t), poses)
    print(f"phase10 (c) rendered {len(frames)} room frames in {time.perf_counter() - t0:.1f} s")
    cfg = _loop_cfg(n_features=768, local_points_cap=2048, local_ba_points=1024,
                    min_init_matches=50)
    slam = SLAM(cam, cfg, device=device)
    lc, mapper = slam.loopcloser, slam.mapper
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded = {}
    restore = _count_loop_matchers(wm_mod, slam, calls, recorded, RECORD_AT_LOOP)
    stage_ms = {k: [] for k in (*LOOP_STAGES, "mapper.global_ba")}
    wrapped = []

    def host_timed(obj, name, key):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            box = {}
            stage_ms[key].append(host_ms(lambda: box.update(out=fn(*args, **kwargs))))
            return box["out"]

        setattr(obj, name, timed)
        wrapped.append((obj, name))

    for name in LOOP_STAGES:
        host_timed(lc, name, name)
    host_timed(mapper, "global_ba", "mapper.global_ba")
    # the state at the start of each loop-closer keyframe; the one that
    # closed the first loop is kept for the replay (its copy time is left
    # out of the frame's time)
    snap, kept, copy_ms = {}, {}, [0.0]
    process_keyframe = lc.process_keyframe

    def snapshotting(kf):
        t = time.perf_counter()
        snap.update(kf=kf, map=convert.map_state_to_numpy(slam.map), db=_snapshot_db(slam.kfdb),
                    pendings=copy.deepcopy(lc._pendings), generator=lc.generator.get_state())
        copy_ms[0] += (time.perf_counter() - t) * 1e3
        closed = process_keyframe(kf)
        if closed and not kept:
            kept.update(snap)
        return closed

    lc.process_keyframe = snapshotting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        est, plain_ms, loop_ms, init_frame = [], [], [], None
        for i, img in enumerate(frames):
            box, loops = {}, lc.n_loops
            copy_ms[0] = 0.0
            ms = host_ms(lambda: box.update(pose=slam.track_monocular(img, i * 0.05))) - copy_ms[0]
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"image loop frame {i}: non-finite pose")
                init_frame = i if init_frame is None else init_frame
                est.append((i * 0.05, box["pose"]))
            if lc.n_loops > loops:
                loop_ms.append(ms)
            elif init_frame is not None and i > init_frame and slam.tracker.pending_kf is None:
                plain_ms.append(ms)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
        for obj, name in wrapped:
            vars(obj).pop(name, None)
        del lc.process_keyframe
    peak = torch.cuda.max_memory_allocated()
    ate = evaluation.ate_rmse(slam.trajectory(), synthetic.gt_trajectory(poses), with_scale=True)
    n = PHASE10_IMAGE_FRAMES
    print(f"phase10 (c) image loop {n} frames: initialized at frame {init_frame}, tracked "
          f"{len(est)}/{n}, maps {slam.map.n_maps}, loops {lc.n_loops}, merges {lc.n_merges}, "
          f"keyframes {slam.n_keyframes()}, map points {slam.n_map_points()}, Sim(3)-aligned ATE "
          f"of trajectory() {ate * 1e3:.3f} mm, max_memory_allocated {peak / 2**20:.1f} MiB")
    print(f"phase10 (c) track_monocular host ms on {len(plain_ms)} frames without a keyframe "
          f"(median / p75): {np.median(plain_ms):.3f} / {np.percentile(plain_ms, 75):.3f}; on the "
          f"frames whose keyframe closed a loop: " + " / ".join(f"{v:.3f}" for v in loop_ms))
    for key, v in stage_ms.items():
        print(f"phase10 (c) {key} host ms in the run over {len(v)} calls (median / max): "
              + (f"{np.median(v):.3f} / {max(v):.3f}" if v else "none"))
    _check_launches("phase10 (c)", launches, calls)
    if len(est) <= 0.75 * n or slam.map.n_maps != 1 or lc.n_loops < 1 or not ate < 0.15:
        raise AssertionError(f"phase10 (c): tracked {len(est)} of {n}, {slam.map.n_maps} maps, "
                             f"{lc.n_loops} loops, ATE {ate:.4f} m (bars > 75 %, 1, >= 1, < 15 cm)")
    if set(RECORD_AT_LOOP) - set(recorded):
        raise AssertionError("phase10 (c): a loop-closer caller recorded no call")
    stages = loop_stage_times(cam, cfg, kept, device)
    stages.update({f"{k} in the run": {"host_ms_median": float(np.median(v)) if v else None,
                                       "calls": len(v)} for k, v in stage_ms.items()})
    result = dict(init_frame=init_frame, tracked=len(est), maps=slam.map.n_maps,
                  loops=lc.n_loops, merges=lc.n_merges, keyframes=slam.n_keyframes(),
                  points=slam.n_map_points(), ate_m=ate, peak_mib=peak / 2**20,
                  frame_ms={"plain_median": float(np.median(plain_ms)),
                            "plain_p75": float(np.percentile(plain_ms, 75)),
                            "loop_closing": loop_ms})
    return launches, calls, recorded, result, stages


def loop_stage_times(cam, cfg, kept, device) -> dict:
    """Replay the loop closer's keyframe that closed the loop from its kept
    state, counting its host syncs and keeping each stage's inputs (map and
    arguments) on the way; then each stage again on its inputs: device ms
    and kernels per call under torch.profiler (each call on a fresh copy of
    its map: the stages change the map)."""
    from orb_slam3_comments_ghr_torch import convert

    lc = _loop_replayer(cam, cfg, kept, device)()
    inputs = {}

    def keeping(obj, name, key):
        fn = getattr(obj, name)

        def kept_fn(*args, **kwargs):
            if key not in inputs:
                inputs[key] = dict(map=convert.map_state_to_numpy(lc.map), db=kept["db"],
                                   args=copy.deepcopy(args), kwargs=kwargs)
            return fn(*args, **kwargs)

        setattr(obj, name, kept_fn)

    for name in LOOP_STAGES:
        keeping(lc, name, name)
    keeping(lc.mapper, "global_ba", "mapper.global_ba")
    closed = {}
    syncs = count_syncs(lambda: closed.update(out=lc.process_keyframe(kept["kf"])))
    # a keyframe that confirms a pending hypothesis may skip the BoW
    # detection: then _detect, and _verify_sim3 on the loop's candidate,
    # run on the keyframe's starting map
    if "_correct_loop" not in inputs:
        raise AssertionError("phase10 (c): the replayed keyframe closed no loop")
    start = dict(map=kept["map"], db=kept["db"], kwargs={})
    inputs.setdefault("_detect", dict(start, args=(kept["kf"],)))
    inputs.setdefault("_verify_sim3", dict(start, args=(kept["kf"],
                                                        inputs["_correct_loop"]["args"][1])))
    print(f"phase10 (c) replay of keyframe {kept['kf']} (closed a loop: {closed['out']}): "
          f"{sum(syncs.values())} host syncs (set_sync_debug_mode); by line of the port: "
          + ", ".join(f"{k} {v}" for k, v in syncs.most_common(12)))
    print("phase10 (c) loop-closer stages on the inputs of that keyframe:")
    out = {"syncs_per_loop_keyframe": sum(syncs.values())}
    for key, inp in inputs.items():
        make = _loop_replayer(cam, cfg, inp, device)

        def call(inp=inp, key=key, make=make):
            lc = make()
            obj = lc.mapper if key == "mapper.global_ba" else lc
            getattr(obj, key.split(".")[-1])(*inp["args"], **inp["kwargs"])

        t = {"host_ms": host_ms(call)}
        t["device_ms"], t["launches"] = device_profile(call, 3)
        print(f"  {key}: host {t['host_ms']:.3f} ms for one call (a map copy included), device "
              f"{t['device_ms']:.4f} ms per call (torch.profiler), {t['launches']:.0f} kernels and "
              f"copies per call")
        out[key] = t
    return out


def reprojection_rmse(m, cam) -> float:
    """RMSE in pixels of every observation of the map's live points in its
    live keyframes."""
    pts = m.mp_ids()
    kf, fi = m.mp_obs_kf[pts], m.mp_obs_idx[pts]
    ok = (kf >= 0) & (fi >= 0)
    p_idx = np.broadcast_to(pts[:, None], kf.shape)[ok]
    kf, fi = kf[ok], fi[ok]
    live = m.kf_valid[kf]
    kf, fi, p_idx = kf[live], fi[live], p_idx[live]
    pc = np.einsum("kij,kj->ki", m.kf_R[kf].astype(np.float64), m.mp_pos[p_idx].astype(np.float64)) \
        + m.kf_t[kf]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    return float(np.sqrt(np.mean(np.sum((uv - m.kf_feat_xy[kf, fi]) ** 2, -1))))


def _ba_cost(mapper, kfs, pts) -> float:
    """The robust (Huber) cost that the whole-map BA minimizes, of the
    mapper's map over the cameras `kfs` and the points `pts`."""
    from orb_slam3_comments_ghr_torch.optim import ba

    P = -(-len(pts) // 2048) * 2048
    prob = mapper._ba_problem(list(kfs), 0, pts, len(kfs), P)[0]
    chi2, delta2 = ba._obs_terms(mapper.cam, prob, prob.cam_R, prob.cam_t, prob.p, True)[4::2]
    return float(ba._cost(chi2, delta2, prob.obs_valid, True))


def _perturb(snapshot, seed: int = 0, rot: float = 0.01, trans: float = 0.02,
             point: float = 0.05) -> dict:
    """A copy of a map snapshot with every keyframe but the first moved by
    a random rotation (rad) and translation (m) and every point by `point`
    m, from `seed` (the noise of tests/test_global_ba.py's map)."""
    from orb_slam3_comments_ghr_torch.ops import lie

    rng = np.random.default_rng(seed)
    out = {k: (v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
           for k, v in snapshot.items()}
    kfs = np.nonzero(out["kf_valid"])[0][1:]
    dR = lie.so3_exp(torch.from_numpy(rng.normal(0, rot, (len(kfs), 3)).astype(np.float32)))
    out["kf_R"][kfs] = (dR.numpy() @ out["kf_R"][kfs]).astype(np.float32)
    out["kf_t"][kfs] += rng.normal(0, trans, (len(kfs), 3)).astype(np.float32)
    pts = np.nonzero(out["mp_valid"])[0]
    out["mp_pos"][pts] += rng.normal(0, point, (len(pts), 3)).astype(np.float32)
    return out


def phase10_global_ba(map_snapshot, device):
    """Run (d): `mapper.run_full_map_ba` (the chunked whole-map BA that
    `global_ba` takes for large maps), 10 iterations over every keyframe
    and point of phase 4's final map, and of the same map with seeded noise
    on its poses and points (`_perturb`). Fails unless the robust cost the
    BA minimizes does not rise on the map as it is (local BA has already
    brought it near its optimum, so a whole-map step may gain nothing and
    be rejected) and, on the noisy copy, the cost drops and the
    reprojection RMSE ends below 0.35 of where it started (the bar of
    tests/test_global_ba.py). Returns, for both, the RMSE and the cost
    before and after, host ms, device ms and kernels per call, and the
    peak device memory."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.pipeline.mapper import LocalMapper
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    cam = cameras.euroc_cam0()
    out = {}
    for key, snap in (("final", map_snapshot), ("perturbed", _perturb(map_snapshot))):
        def make(snap=snap):
            m = convert.map_state_from_numpy(snap)
            return m, LocalMapper(cam, SlamConfig(), m, device=device)

        m, mapper = make()
        kfs = [int(k) for k in m.kf_ids()]
        pts = m.local_point_ids(kfs, cap=10**9)
        rmse0, cost0 = reprojection_rmse(m, cam), _ba_cost(mapper, kfs, pts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: mapper.run_full_map_ba(kfs, pts, iters=10))
        peak = torch.cuda.max_memory_allocated()
        rmse1, cost1 = reprojection_rmse(m, cam), _ba_cost(mapper, kfs, pts)

        def call(make=make, kfs=kfs, pts=pts):
            mapper2 = make()[1]
            mapper2.run_full_map_ba(kfs, pts, iters=10)

        device_ms, kernels = device_profile(call, 2)
        print(f"phase10 (d) run_full_map_ba on phase 4's final map, {key} ({len(kfs)} keyframes, "
              f"{len(pts)} points, 10 iterations): reprojection RMSE {rmse0:.4f} -> {rmse1:.4f} px, "
              f"robust cost {cost0:.4f} -> {cost1:.4f}; host {ms:.3f} ms, device {device_ms:.4f} ms, "
              f"{kernels:.0f} kernels and copies per call, max_memory_allocated "
              f"{peak / 2**20:.1f} MiB")
        out[key] = dict(keyframes=len(kfs), points=len(pts), rmse_before_px=rmse0,
                        rmse_after_px=rmse1, cost_before=cost0, cost_after=cost1, host_ms=ms,
                        device_ms=device_ms, launches=kernels, peak_mib=peak / 2**20)
    if not out["final"]["cost_after"] <= out["final"]["cost_before"]:
        raise AssertionError("phase10 (d): the whole-map BA raised the cost of phase 4's map")
    p = out["perturbed"]
    if not (p["cost_after"] < p["cost_before"] and p["rmse_after_px"] < 0.35 * p["rmse_before_px"]):
        raise AssertionError("phase10 (d): the whole-map BA did not remove the noise of the "
                             f"perturbed map (RMSE {p['rmse_before_px']:.4f} -> "
                             f"{p['rmse_after_px']:.4f} px)")
    return out


# phase 11 (a): the outward turn inside room scene 33 that closes the
# stereo-inertial loop (scripts/vi_slam_cpu.py --sensor imu_stereo_loop)
PHASE11_FRAMES = 200
PHASE11_ARC = 1.1
# the loop closer's window-match calls kept on the inertial map: the last
# projection count and the first fuse of the correction
RECORD_AT_INERTIAL_LOOP = {"loop_count": None, "loop_fuse": 1}
# phase 11 (b): tests/test_inertial_merge.py's kidnap, not cut
PHASE11_KIDNAP_FRAMES = 300
PHASE11_BLANK = range(140, 154)


def _loop_closer_timed(slam, keys, stage_ms: dict, current: dict):
    """Time each loop-closer stage (and the mapper's methods named
    "mapper.<name>" in `keys`) on the host clock: every call into
    stage_ms[key], and into current[key] as well (the caller empties
    `current` at each keyframe). Returns a function that puts them back."""
    wrapped = []
    for key in keys:
        obj = slam.mapper if key.startswith("mapper.") else slam.loopcloser
        name = key.split(".")[-1]
        fn = getattr(obj, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            box = {}
            ms = host_ms(lambda: box.update(out=_fn(*args, **kwargs)))
            stage_ms[_key].append(ms)
            current.setdefault(_key, []).append(ms)
            return box["out"]

        setattr(obj, name, timed)
        wrapped.append((obj, name))
    return lambda: [vars(obj).pop(name, None) for obj, name in wrapped]


def _inertial_mapper_maker(cam, cfg, snap, device):
    """A function making a LocalMapper with the IMU on a fresh copy of the
    map, keyframe preintegrations and IMU bias of `snap`."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.pipeline.imu_frontend import ImuFrontend
    from orb_slam3_comments_ghr_torch.pipeline.mapper import LocalMapper

    def make():
        mapper = LocalMapper(cam, cfg, convert.map_state_from_numpy(snap["map"]), device=device)
        mapper.imu = ImuFrontend(imu_calib(), device=device)
        mapper.imu.bias = snap["bias"].copy()
        mapper.kf_preint = dict(snap["preint"])
        return mapper

    return make


def _inertial_snapshot(mapper) -> dict:
    from orb_slam3_comments_ghr_torch import convert

    return dict(map=convert.map_state_to_numpy(mapper.map), preint=dict(mapper.kf_preint),
                bias=np.asarray(mapper.imu.bias).copy())


def phase11_inertial_loop(wm_mod, device):
    """Run (a), the flagship with loop closing on: stereo-inertial
    `SLAM.track_stereo` with the IMU rows at phase 7's full width (EuRoC
    cam0 752x480, 1024 features, local map 4096, local BA 2048 points, IMU
    at 200 Hz with phase 7's noise) and the default SlamConfig (loop closing
    on), over PHASE11_FRAMES frames of `vi_sequence(arc=PHASE11_ARC,
    outward=True)`: an outward-looking turn of 1.1 turns inside room scene
    33 of tests/test_image_loopclosing.py, left and right views rendered
    exactly, which revisits its start. Two gates are those of
    tests/test_inertial_merge.py so that a loop can fire inside the
    script's time: `loop_requires_viba2=False` (the reference waits ~15 s
    for VIBA2) and `loop_min_kfs=8`. The forward-looking sweep of phase 7
    cannot close a loop: every keyframe sees the same planes, so the
    connected set excludes every candidate (PERF.md section 4). Fails unless >=
    95 % of the frames are tracked, the metric ATE (no scale fit) of
    `trajectory()` is < 8 cm, a loop closes and its correction reaches
    `mapper.full_inertial_ba`, one map remains, and the window match
    launched once per matcher call. Times the frames, the loop closer's
    stages of the keyframe that closed the loop, counts that keyframe's host
    syncs, and profiles the inertial GBA on its kept inputs. Returns
    (launches, calls, recorded arguments, result, the final map's snapshot
    with its ground truth)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation, gt_replay, synthetic

    cam = cameras.euroc_cam0()
    n = PHASE11_FRAMES
    poses, imu_rows, times = synthetic.vi_sequence(n, arc=PHASE11_ARC, outward=True)
    room = gt_replay.make_room_scene(33, np.stack([-R.T @ t for R, t in poses]), margin=4.0,
                                     span=20.0)
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    t0 = time.perf_counter()
    left = render_all(lambda R, t: u8(gt_replay.render_room(room, cam, R, t)), poses)
    right = render_all(lambda R, t: u8(gt_replay.render_room(room, cam, R, t - b)), poses)
    rows = [imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0)) & (imu_rows[:, 0] <= times[i])]
            for i in range(n)]
    print(f"phase11 (a) rendered {n} stereo pairs in {time.perf_counter() - t0:.1f} s")
    cfg = config.SlamConfig(sensor=config.IMU_STEREO, n_features=1024, local_points_cap=4096,
                            local_ba_points=2048, max_frames_between_kf=10, min_init_matches=60,
                            loop_requires_viba2=False, loop_min_kfs=8)
    if not cfg.enable_loop_closing:
        raise AssertionError("phase11 (a): the default SlamConfig has loop closing off")
    slam = SLAM(cam, cfg, imu_calib=imu_calib(), device=device)
    lc, mapper = slam.loopcloser, slam.mapper
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded = {}
    restore = _count_loop_matchers(wm_mod, slam, calls, recorded, RECORD_AT_INERTIAL_LOOP,
                                   prefix="inertial ")
    keys = (*LOOP_STAGES, "mapper.full_inertial_ba")
    stage_ms, current = {k: [] for k in keys}, {}
    # the inputs of the first inertial GBA, kept for its device profile
    kept = {}

    def keeping(**kwargs):
        if not kept:
            kept.update(_inertial_snapshot(mapper), kwargs=kwargs)
        return full_inertial_ba(**kwargs)

    unwrap = _loop_closer_timed(slam, keys, stage_ms, current)
    full_inertial_ba = mapper.full_inertial_ba
    mapper.full_inertial_ba = keeping
    loop_kf = {}
    process_keyframe = lc.process_keyframe

    def counted(kf):
        box, loops = {}, lc.n_loops
        current.clear()
        syncs = count_syncs(lambda: box.update(out=process_keyframe(kf)), by_line=False)
        if lc.n_loops > loops and not loop_kf:
            loop_kf.update(kf=kf, syncs=sum(syncs.values()),
                           stages={k: sum(v) for k, v in current.items()})
        return box["out"]

    lc.process_keyframe = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        tracked, plain_ms, loop_ms = 0, [], []
        for i in range(n):
            box, loops = {}, lc.n_loops
            ms = host_ms(lambda: box.update(pose=slam.track_stereo(left[i], right[i], times[i],
                                                                   imu_samples=rows[i])))
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"phase11 (a) frame {i}: non-finite pose")
                tracked += 1
            if lc.n_loops > loops:
                loop_ms.append(ms)
            elif i > 0 and slam.tracker.pending_kf is None:
                plain_ms.append(ms)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
        vars(mapper).pop("full_inertial_ba")
        unwrap()
        del lc.process_keyframe
    peak = torch.cuda.max_memory_allocated()
    gt = vi_gt(poses, times)
    ate = evaluation.ate_rmse(slam.trajectory(), gt, with_scale=False)
    print(f"phase11 (a) stereo-inertial loop {n} frames: tracked {tracked}/{n}, IMU initialized "
          f"{bool(slam.map.map_imu_init.get(slam.map.active_map, False))}, maps "
          f"{slam.map.n_maps}, loops {lc.n_loops}, merges {lc.n_merges}, keyframes "
          f"{slam.n_keyframes()}, map points {slam.n_map_points()}, metric ATE (no scale fit) "
          f"{ate * 1e3:.3f} mm, max_memory_allocated {peak / 2**20:.1f} MiB")
    print(f"phase11 (a) track_stereo host ms on {len(plain_ms)} frames without a keyframe (median "
          f"/ p75): {np.median(plain_ms):.3f} / {np.percentile(plain_ms, 75):.3f}; on the frames "
          "whose keyframe closed a loop: " + " / ".join(f"{v:.3f}" for v in loop_ms))
    for key, v in stage_ms.items():
        print(f"phase11 (a) {key} host ms in the run over {len(v)} calls (median / max): "
              + (f"{np.median(v):.3f} / {max(v):.3f}" if v else "none"))
    if loop_kf:
        print(f"phase11 (a) the keyframe that closed the loop ({loop_kf['kf']}): {loop_kf['syncs']} "
              "host syncs (set_sync_debug_mode); host ms by stage: "
              + ", ".join(f"{k} {v:.3f}" for k, v in loop_kf["stages"].items()))
    _check_launches("phase11 (a)", launches, calls)
    if tracked < 0.95 * n or not ate < 0.08 or lc.n_loops < 1 or slam.map.n_maps != 1:
        raise AssertionError(f"phase11 (a): tracked {tracked} of {n}, ATE {ate:.4f} m, "
                             f"{lc.n_loops} loops, {slam.map.n_maps} maps (bars >= 95 %, < 8 cm, "
                             ">= 1, 1)")
    if not stage_ms["mapper.full_inertial_ba"]:
        raise AssertionError("phase11 (a): the loop correction never reached full_inertial_ba")
    if set(f"inertial {k}" for k in RECORD_AT_INERTIAL_LOOP) - set(recorded):
        raise AssertionError("phase11 (a): a loop-closer caller recorded no call")
    # the inertial GBA again on its kept inputs, each call on a fresh copy
    make = _inertial_mapper_maker(cam, cfg, kept, device)
    call = lambda: make().full_inertial_ba(**kept["kwargs"])
    gba = {"host_ms": host_ms(call)}
    gba["device_ms"], gba["launches"] = device_profile(call, 2)
    m0 = make().map
    chain = make()._temporal_chain(int(m0.kf_ids()[-1]), cap=256)
    print(f"phase11 (a) full_inertial_ba of the loop on its kept inputs ({len(chain)} keyframes in "
          f"the chain, {kept['kwargs']}): host {gba['host_ms']:.3f} ms for one call (a map copy "
          f"included), device {gba['device_ms']:.4f} ms per call (torch.profiler), "
          f"{gba['launches']:.0f} kernels and copies per call")
    result = dict(tracked=tracked, maps=slam.map.n_maps, loops=lc.n_loops, merges=lc.n_merges,
                  keyframes=slam.n_keyframes(), points=slam.n_map_points(), ate_m=ate,
                  peak_mib=peak / 2**20, loop_keyframe=loop_kf, full_inertial_ba=gba,
                  frame_ms={"plain_median": float(np.median(plain_ms)),
                            "plain_p75": float(np.percentile(plain_ms, 75)),
                            "loop_closing": loop_ms})
    return launches, calls, recorded, result, dict(_inertial_snapshot(mapper), cfg=cfg, gt=gt)


def phase11_kidnap(wm_mod, device):
    """Run (b), tests/test_inertial_merge.py's kidnap, not cut:
    mono-inertial `track_features` on 512 rendered features of world 57
    over 300 frames of `vi_sequence`, blank frames 140-153 (the IMU rows
    still fed), loop closing on with that test's gates. Fails unless map 0
    is IMU-initialized before the kidnap and a second map opens, a merge
    happens and leaves map 0 with imu_init / VIBA1 / VIBA2 set, the weld
    (the transform applied while both maps were IMU-initialized) is
    yaw-only (R[2,2] > 0.9999, off-axis terms < 1e-6) with scale in [0.9,
    1.1], more than 80 frames are tracked after the kidnap, the weld ran
    `mapper.merge_inertial_ba`, and the window match launched once per
    matcher call."""
    from orb_slam3_comments_ghr_torch.frontend.types import empty_features
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, synthetic

    cam = cameras.euroc_cam0()
    n = PHASE11_KIDNAP_FRAMES
    world = synthetic.make_world(57, n_points=3000)
    poses, imu_rows, times = synthetic.vi_sequence(n)
    feats = [None if i in PHASE11_BLANK else
             synthetic.render_features(world, cam, *poses[i], n_feat=512, seed=5700 + i,
                                       device=device)[0] for i in range(n)]
    blank = empty_features(512, device=device)
    cfg = config.SlamConfig(sensor=config.IMU_MONOCULAR, n_features=512, local_points_cap=2048,
                            local_ba_points=2048, max_frames_between_kf=5, min_init_matches=60,
                            recently_lost_secs=0.3, loop_requires_viba2=False, loop_min_kfs=8)
    slam = SLAM(cam, cfg, imu_calib=imu_calib(), device=device)
    m = slam.map
    transforms = []
    apply_transform = m.apply_transform

    def spy(map_id, s, R, t, **kw):
        transforms.append((int(map_id), float(s), np.asarray(R).copy(), dict(m.map_imu_init)))
        return apply_transform(map_id, s, R, t, **kw)

    m.apply_transform = spy
    welds = []
    merge_inertial_ba = slam.mapper.merge_inertial_ba
    slam.mapper.merge_inertial_ba = lambda kf, cand: (welds.append(kf), merge_inertial_ba(kf, cand))
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        tracked, imu_init_map0, maps_before, maps_after = 0, False, None, None
        for i in range(n):
            chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0))
                             & (imu_rows[:, 0] <= times[i])]
            if len(chunk):
                slam.feed_imu(chunk)
            if i == PHASE11_BLANK[0]:
                imu_init_map0, maps_before = bool(m.map_imu_init.get(0, False)), m.n_maps
            pose = slam.track_features(blank if feats[i] is None else feats[i], times[i])
            if i == PHASE11_BLANK[-1]:
                maps_after = m.n_maps
            tracked += i > PHASE11_BLANK[-1] and pose is not None
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
        del m.apply_transform, slam.mapper.merge_inertial_ba
    lc = slam.loopcloser
    weld = [(s, R) for _, s, R, flags in transforms if sum(bool(v) for v in flags.values()) >= 2]
    print(f"phase11 (b) inertial kidnap and merge {n} frames: map 0 IMU-initialized before the "
          f"kidnap {imu_init_map0}, maps {maps_before} -> {maps_after}, merges {lc.n_merges}, "
          f"loops {lc.n_loops}, merge_inertial_ba calls {len(welds)}, map 0 imu_init / VIBA1 / "
          f"VIBA2 {m.map_imu_init.get(0, False)} / {m.map_viba1.get(0, False)} / "
          f"{m.map_viba2.get(0, False)}, tracked after the kidnap {tracked}, active map "
          f"{m.active_map} of {m.n_maps}")
    if weld:
        s, R = weld[0]
        print(f"phase11 (b) weld: scale {s:.6f}, R[2,2] {R[2, 2]:.8f}, off-axis max "
              f"{max(abs(R[0, 2]), abs(R[1, 2]), abs(R[2, 0]), abs(R[2, 1])):.3e}")
    _check_launches("phase11 (b)", launches, calls)
    if not (imu_init_map0 and maps_after > maps_before):
        raise AssertionError("phase11 (b): map 0 not IMU-initialized, or no second map")
    if not (lc.n_merges >= 1 and m.map_imu_init.get(0, False) and m.map_viba1.get(0, False)
            and m.map_viba2.get(0, False)) or not welds:
        raise AssertionError("phase11 (b): no inertial merge, or map 0's stages not set")
    s, R = weld[0] if weld else (0.0, np.zeros((3, 3)))
    if not (0.9 <= s <= 1.1 and R[2, 2] > 0.9999 and max(abs(R[0, 2]), abs(R[1, 2]),
                                                        abs(R[2, 0]), abs(R[2, 1])) < 1e-6):
        raise AssertionError("phase11 (b): the weld is not yaw-only with scale in [0.9, 1.1]")
    if tracked <= 80:
        raise AssertionError(f"phase11 (b): {tracked} frames tracked after the kidnap (<= 80)")
    return launches, calls, dict(maps_before=maps_before, maps_after=maps_after,
                                 merges=lc.n_merges, welds=len(welds), tracked_after=tracked,
                                 weld_scale=s, weld_R22=float(R[2, 2]))


def _kf_ate(m, gt) -> float:
    """Metric ATE (no scale fit) of the map's keyframe poses."""
    from orb_slam3_comments_ghr_torch.utils import evaluation

    gtd = {round(t, 6): T for t, T in gt}
    est = []
    for kf in m.kf_ids():
        t = round(float(m.kf_time[kf]), 6)
        if t in gtd:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = m.kf_R[kf], m.kf_t[kf]
            est.append((t, T))
    return evaluation.ate_rmse(est, gt, with_scale=False)


def _vi_cost64(cam, prob, state) -> float:
    """The robust cost that the VI-BA minimizes, of the states (Rwb, pwb,
    vel, bias, p) on the problem `prob`, evaluated in float64."""
    from orb_slam3_comments_ghr_torch.optim import vi_ba

    f64 = lambda a: a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    prob = prob._replace(pre=type(prob.pre)(*map(f64, prob.pre)),
                         **{k: f64(v) for k, v in prob._asdict().items() if k != "pre"})
    return float(vi_ba._total_cost(cam, prob, *map(f64, state), True))


def phase11_full_inertial_ba(snap, device):
    """Run (c): `mapper.full_inertial_ba(iters=7)` on run (a)'s final map,
    first on the dense solver (the chain's first 4 x local_ba_points points)
    and then past the dense cap (local_ba_points cut below the chain's
    point count, as tests/test_full_inertial_ba.py does), where every point
    of the chain goes to the point-chunked solver. The cost is read on each
    solver call's own problem, in float64, before and after the call: the
    map's float32 round trip between bites (body to camera poses and back)
    moves a cost dominated by stiff inertial factors and by the Huber tails
    of the map's outliers by ~1e-6 of itself even when every step is
    rejected. Fails unless the chunked solver sees P >= the chain's point
    count, no solver call raises its cost, and the keyframe ATE ends <=
    max(1.2 x its start, 0.3 m). Returns host ms, device ms, kernels, peak
    memory, costs and ATEs per path, and the final map's failing
    observations and cost."""
    import dataclasses

    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import vi_ba
    from orb_slam3_comments_ghr_torch.pipeline.mapper import VI_CHUNK

    cam = cameras.euroc_cam0()
    cfg, gt = snap["cfg"], snap["gt"]
    mapper = _inertial_mapper_maker(cam, cfg, snap, device)()
    m = mapper.map
    chain = mapper._temporal_chain(int(m.kf_ids()[-1]), cap=256)
    all_pts = m.local_point_ids(chain, None)
    # the map's observations that fail the chi2 gate (ROADMAP C10: the
    # VI-BAs erase theirs since its repair) and its VI-BA cost
    prob, _ = mapper._vi_ba_problem(chain, all_pts, -(-len(all_pts) // VI_CHUNK) * VI_CHUNK)
    state = (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p)
    n_obs = int(prob.obs_valid.sum())
    n_out = n_obs - int(vi_ba.classify_observations(cam, prob, *state[:2], prob.p,
                                                     point_chunk=VI_CHUNK).sum())
    cost = _vi_cost64(cam, prob, state)
    del prob, state
    print(f"phase11 (c) run (a)'s final map: {n_out} of {n_obs} observations of the chain's "
          f"{len(all_pts)} points fail the chi2 gate; VI-BA cost (float64) {cost:.1f}")
    dense_cap = 4 * cfg.local_ba_points
    small = dataclasses.replace(cfg, local_ba_points=max(16, len(all_pts) // 32))
    solvers = {name: getattr(vi_ba, name) for name in ("vi_bundle_adjust",
                                                       "vi_bundle_adjust_chunked")}
    seen = []

    def spied(name):
        def spy(cam_, prob, *args, **kwargs):
            out = solvers[name](cam_, prob, *args, **kwargs)
            seen.append((name, int(prob.p.shape[0]),
                         _vi_cost64(cam_, prob, (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p)),
                         _vi_cost64(cam_, prob, out[:5])))
            return out
        return spy

    out = {}
    for key, run_cfg, kwargs in (("dense", cfg, dict(iters=7, point_cap=dense_cap)),
                                 ("chunked", small, dict(iters=7))):
        start = _inertial_snapshot(mapper)
        mapper.cfg = run_cfg
        ate0 = _kf_ate(m, gt)
        # host ms and peak memory without the cost reads, then the costs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: mapper.full_inertial_ba(**kwargs))
        peak = torch.cuda.max_memory_allocated()
        ate1 = _kf_ate(m, gt)
        make = _inertial_mapper_maker(cam, run_cfg, start, device)
        device_ms, kernels = device_profile(lambda: make().full_inertial_ba(**kwargs), 2)
        seen.clear()
        for name in solvers:
            setattr(vi_ba, name, spied(name))
        try:
            make().full_inertial_ba(**kwargs)
        finally:
            for name, fn in solvers.items():
                setattr(vi_ba, name, fn)
        P = max((n for name, n, _, _ in seen if name.endswith("chunked")), default=None)
        costs = [(c0, c1) for _, _, c0, c1 in seen]
        print(f"phase11 (c) full_inertial_ba {key} on run (a)'s final map ({len(chain)} keyframes, "
              f"{len(m.local_point_ids(chain, kwargs.get('point_cap')))} of the chain's "
              f"{len(all_pts)} points, chunked P {P}, 7 iterations in {len(seen)} bites): VI-BA "
              "cost per bite (float64) " + ", ".join(f"{a:.1f} -> {b:.1f}" for a, b in costs)
              + f"; keyframe ATE {ate0 * 1e3:.3f} -> {ate1 * 1e3:.3f} mm; host {ms:.3f} ms, device "
              f"{device_ms:.4f} ms, {kernels:.0f} kernels and copies per call, "
              f"max_memory_allocated {peak / 2**20:.1f} MiB")
        out[key] = dict(keyframes=len(chain), chunked_P=P, bite_costs=costs,
                        kf_ate_before_m=ate0, kf_ate_after_m=ate1, host_ms=ms,
                        device_ms=device_ms, launches=kernels, peak_mib=peak / 2**20)
        if not all(c1 <= c0 for c0, c1 in costs) or not costs:
            raise AssertionError(f"phase11 (c) {key}: a solver call raised the VI-BA cost")
        if not ate1 <= max(1.2 * ate0, 0.3):
            raise AssertionError(f"phase11 (c) {key}: keyframe ATE {ate0:.4f} -> {ate1:.4f} m")
    if out["dense"]["chunked_P"] is not None:
        raise AssertionError("phase11 (c): the dense run went through the chunked solver")
    if not (out["chunked"]["chunked_P"] or 0) >= len(all_pts):
        raise AssertionError(f"phase11 (c): the chunked solver saw P {out['chunked']['chunked_P']} "
                             f"< {len(all_pts)} points of the chain")
    out["final_map"] = dict(observations=n_obs, failing_gate=n_out, vi_ba_cost=cost)
    return out


PHASE12_MONO_FRAMES = 120
PHASE12_STEREO_FRAMES = 80
PHASE12_VI_FRAMES = 150
# the calls of phase 12 (a) whose window-match arguments are kept for phase
# 1: the 60th tracking call and the last fuse of the mapper
RECORD_AT_FISHEYE = {"tracking": 60, "fuse": None}
CHECK_FRAME_FISHEYE = 60  # the frame of (a) held on the card against the CPU port
# metres of room wall per texture in run (a): at TUM-VI's 190 px focal length
# the 20 m of phase 10 (c) puts its 4-8 cm texture cells near a pixel at the
# walls' 3-4 m, and the aliased frames give ~40 matches between consecutive
# frames, under the 100 that the monocular init needs
PHASE12_ROOM_SPAN = 80.0


def fisheye_pair():
    """The non-rectified KB8 pair of tests/test_fisheye_stereo.py (752x480,
    an 11 cm baseline; the left camera's bf = fx * baseline for the depth
    threshold) and its extrinsics x_l = R_lr x_r + t_lr."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from vi_slam_cpu import fisheye_pair as pair
    from orb_slam3_comments_ghr_torch.ops import cameras, lie

    return pair(cameras, lambda w: lie.so3_exp(torch.from_numpy(w)).numpy())


def fisheye_undistortion_against_cpu(cam, args, kwargs) -> dict:
    """One kept `extract_and_track(undistort=True)` call again on the card
    and through the port on the CPU: the undistorted keypoints (equal to
    1e-3 px plus 1e-5 of their distance from the centre, on >= 95 % of the
    slots; all finite) and the tracked pose (within 1e-3) must agree."""
    from orb_slam3_comments_ghr_torch.pipeline import programs

    cpu = torch.device("cpu")
    on_cpu = lambda a: type(a)(*(x.to(cpu) for x in a)) if isinstance(a, tuple) else (
        a.to(cpu) if torch.is_tensor(a) else a)
    f_g, r_g = programs.extract_and_track(*args, **kwargs)
    f_c, r_c = programs.extract_and_track(*map(on_cpu, args), **kwargs)
    xy_g, xy_c = f_g.xy.cpu(), f_c.xy
    centre = torch.tensor([cam.cx, cam.cy])
    near = ((xy_g - xy_c).abs().amax(-1) <= 1e-3 + 1e-5 * (xy_c - centre).norm(dim=-1))
    share = float(near.float().mean())
    finite = bool(torch.isfinite(xy_g).all())
    dR = float((r_g.R.cpu() - r_c.R).abs().max())
    dt = float((r_g.t.cpu() - r_c.t).abs().max())
    print(f"phase12 (a) frame {CHECK_FRAME_FISHEYE} card vs cpu: undistorted keypoints equal on "
          f"{share:.4f} of the slots, all finite {finite}, |dR| {dR:.2e}, |dt| {dt:.2e} m, inliers "
          f"{int(r_g.n_inliers)} vs {int(r_c.n_inliers)}")
    if share < 0.95 or not finite or dR > 1e-3 or dt > 1e-3:
        raise AssertionError("phase12 (a): the card's undistortion or pose disagrees with the CPU port")
    return dict(keypoint_share=share, dR=dR, dt_m=dt)


def phase12_mono_fisheye(wm_mod, device):
    """Run (a): `SLAM.track_monocular` with TUM-VI's KB8 cam0 (512x512) and
    its preset (1024 features, a keyframe at least every 20 frames, the
    default SlamConfig otherwise: loop closing on) over PHASE12_MONO_FRAMES
    frames of `circular_trajectory`, rendered in room scene 33 built around
    their centres (with PHASE12_ROOM_SPAN m of wall per texture) through the
    KB8 model (rays from its exact inverse; beyond 90 degrees the 40-grey
    background). Fails unless the map
    initializes, >= 90 % of the frames after the init are tracked, >= 3
    keyframes, the Sim(3)-aligned ATE of `trajectory()` < 6 cm
    (tests/test_fisheye.py), and the window match launched once per matcher
    call; then one frame's undistortion and pose against the CPU port.
    Returns (launches, calls, recorded arguments, results)."""
    from orb_slam3_comments_ghr_torch.models import presets
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.pipeline import programs
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation, gt_replay, synthetic

    cam, cfg, _ = presets.tum_vi(config.MONOCULAR)
    n = PHASE12_MONO_FRAMES
    poses = synthetic.circular_trajectory(n)
    scene = gt_replay.make_room_scene(33, np.stack([camera_centre(R, t) for R, t in poses]),
                                      margin=4.0, span=PHASE12_ROOM_SPAN)
    t0 = time.perf_counter()
    frames = render_all(lambda R, t: np.clip(np.round(gt_replay.render_room(scene, cam, R, t)),
                                             0, 255).astype(np.uint8), poses)
    print(f"phase12 (a) rendered {n} 512x512 KB8 frames in {time.perf_counter() - t0:.1f} s")
    slam = SLAM(cam, cfg, device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded, kept = {}, {}
    restore = _count_loop_matchers(wm_mod, slam, calls, recorded, RECORD_AT_FISHEYE, "fisheye ")
    extract_and_track = _keep_call(programs, "extract_and_track", kept, "frame",
                                   lambda i, b: i == CHECK_FRAME_FISHEYE + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        est, frame_ms, init_frame = [], [], None
        for i, img in enumerate(frames):
            box = {}
            ms = host_ms(lambda: box.update(pose=slam.track_monocular(img, i * 0.05)))
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"phase12 (a) frame {i}: non-finite pose")
                init_frame = i if init_frame is None else init_frame
                est.append((i * 0.05, box["pose"]))
                if i > init_frame and slam.tracker.pending_kf is None:
                    frame_ms.append(ms)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
        programs.extract_and_track = extract_and_track
    peak = torch.cuda.max_memory_allocated()
    ate = evaluation.ate_rmse(slam.trajectory(), synthetic.gt_trajectory(poses), with_scale=True)
    after = n - (init_frame if init_frame is not None else n)
    print(f"phase12 (a) mono KB8 {n} frames: initialized at frame {init_frame}, tracked "
          f"{len(est)}/{n}, keyframes {slam.n_keyframes()}, map points {slam.n_map_points()}, maps "
          f"{slam.map.n_maps}, loops {slam.loopcloser.n_loops}, Sim(3)-aligned ATE of trajectory() "
          f"{ate * 1e3:.3f} mm, max_memory_allocated {peak / 2**20:.1f} MiB; track_monocular host "
          f"ms on {len(frame_ms)} frames without a keyframe (median / p75): "
          + (f"{np.median(frame_ms):.3f} / {np.percentile(frame_ms, 75):.3f}" if frame_ms else "none"))
    _check_launches("phase12 (a)", launches, calls)
    if init_frame is None or len(est) < 0.9 * after or slam.n_keyframes() < 3 or not ate < 0.06:
        raise AssertionError(f"phase12 (a): initialized at {init_frame}, tracked {len(est)} of the "
                             f"{after} frames from the init, {slam.n_keyframes()} keyframes, ATE "
                             f"{ate:.4f} m (bars: >= 90 %, >= 3, < 6 cm)")
    if set(RECORD_AT_FISHEYE) - {k[len("fisheye "):] for k in recorded} or "frame" not in kept:
        raise AssertionError("phase12 (a): a caller recorded no call")
    check = fisheye_undistortion_against_cpu(cam, *kept["frame"])
    return launches, calls, recorded, dict(
        init_frame=init_frame, tracked=len(est), keyframes=slam.n_keyframes(),
        points=slam.n_map_points(), loops=slam.loopcloser.n_loops, ate_sim3_m=ate,
        peak_mib=peak / 2**20, card_vs_cpu=check,
        frame_ms={"median": float(np.median(frame_ms)) if frame_ms else None,
                  "p75": float(np.percentile(frame_ms, 75)) if frame_ms else None})


def fisheye_stereo_inputs(n: int):
    """Both views of `fisheye_pair()` along `vi_sequence(n)`'s poses,
    rendered through their KB8 models in room scene 33 built around the
    left camera's centres, with the IMU rows per frame: (left, right,
    rows, timestamps, poses)."""
    from orb_slam3_comments_ghr_torch.utils import gt_replay, synthetic

    cam_l, cam_r, R_lr, t_lr = fisheye_pair()
    R_rl, t_rl = R_lr.T, -R_lr.T @ t_lr
    poses, imu_rows, times = synthetic.vi_sequence(n)
    room = gt_replay.make_room_scene(33, np.stack([camera_centre(R, t) for R, t in poses]),
                                     margin=4.0, span=20.0)
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    left = render_all(lambda R, t: u8(gt_replay.render_room(room, cam_l, R, t)), poses)
    right = render_all(lambda R, t: u8(gt_replay.render_room(
        room, cam_r, (R_rl @ R).astype(np.float32), (R_rl @ t + t_rl).astype(np.float32))), poses)
    rows = [imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0)) & (imu_rows[:, 0] <= times[i])]
            for i in range(n)]
    return left, right, rows, times, poses


def _right_rows(prob, D: int) -> int:
    """Valid right-camera rows (obs_rig = 1, columns >= D) of a BA problem."""
    if prob.obs_rig is None:
        return 0
    return int((prob.obs_valid[:, D:] & (prob.obs_rig[:, D:] == 1)).sum())


def _rig_ba_cost(tag: str, solve, kept, D: int) -> dict:
    """A kept local (VI-)BA call with right-camera rows again on its inputs:
    host ms, device ms, kernels and peak memory above what was allocated,
    with its 2D-wide rig tables and with the right rows taken out (D wide,
    no rig)."""
    cam, prob, args, kwargs = kept
    left = prob._replace(obs_rig=None, rig_R=None, rig_t=None, **{
        k: getattr(prob, k)[:, :D] for k in ("obs_cam", "obs_uv", "obs_ur", "obs_level",
                                              "obs_valid")})
    out = {}
    for key, p in (("with right rows", prob), ("left rows only", left)):
        run = lambda: solve(cam, p, *args, **kwargs)
        out[key] = stage_times(f"{tag} {solve.__name__} {key} ({p.obs_cam.shape[0]} x "
                               f"{p.obs_cam.shape[1]} table)", run, calls=5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        out[key]["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"  {tag} {key}: peak {out[key]['peak_mib']:.1f} MiB above the inputs")
    return out


def phase12_stereo_fisheye(wm_mod, device, inputs, inertial: bool):
    """Run (b) (`inertial` False): `SLAM.track_stereo_fisheye` on rendered
    images of both cameras of the KB8 pair (features extracted by the entry
    point), sensor STEREO with the default widths, over the first
    PHASE12_STEREO_FRAMES frames of `inputs`; fails unless the map holds the
    rig and > 50 right-camera rows, > 30 frames are tracked, the metric ATE
    of `trajectory()` is < 10 cm (tests/test_fisheye_stereo.py), the BA
    tables of the map carry > 50 valid right rows with obs_rig = 1, and the
    last local BA's problem carried > 50 of them. Run (c) (`inertial`):
    the same rig with the IMU rows over all PHASE12_VI_FRAMES frames, at
    phase 7's configuration (loop closing off); fails unless the IMU
    initializes, >= 95 % of the frames are tracked, the metric ATE is < 8
    cm, and inertial local BAs ran with right rows. Both: the window match
    launched once per matcher call; then the last local BA with right rows
    again on its inputs, with and without them (`_rig_ba_cost`). Returns
    (launches, calls, results)."""
    from orb_slam3_comments_ghr_torch.optim import ba, vi_ba
    from orb_slam3_comments_ghr_torch.pipeline.mapper import _build_obs_tables
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation

    tag = "phase12 (c)" if inertial else "phase12 (b)"
    left, right, rows, times, poses = inputs
    n = PHASE12_VI_FRAMES if inertial else PHASE12_STEREO_FRAMES
    cam_l, cam_r, R_lr, t_lr = fisheye_pair()
    if inertial:
        cfg = config.SlamConfig(sensor=config.IMU_STEREO, n_features=1024, local_points_cap=4096,
                                local_ba_points=2048, max_frames_between_kf=10,
                                min_init_matches=60, enable_loop_closing=False)
        slam = SLAM(cam_l, cfg, imu_calib=imu_calib(), device=device)
    else:
        slam = SLAM(cam_l, config.SlamConfig(sensor=config.STEREO), device=device)
    D = slam.cfg.obs_cap
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    solver_mod, solver = (vi_ba, "vi_bundle_adjust") if inertial else (ba, "bundle_adjust")
    solve = getattr(solver_mod, solver)
    right_rows, kept = [], []  # valid right rows of each local (VI-)BA problem

    def counted(cam, prob, *args, **kwargs):
        right_rows.append(_right_rows(prob, D))
        if right_rows[-1]:
            kept[:] = [(cam, prob, args, kwargs)]
        return solve(cam, prob, *args, **kwargs)

    setattr(solver_mod, solver, counted)
    imu_ready = lambda: slam.map.map_imu_init.get(slam.map.active_map, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        est, frame_ms, imu_frame = [], [], None
        for i in range(n):
            box = {}
            kfs = slam.map.n_kf
            ms = host_ms(lambda: box.update(pose=slam.track_stereo_fisheye(
                left[i], right[i], cam_r, R_lr, t_lr, times[i],
                imu_samples=rows[i] if inertial else None)))
            if box["pose"] is not None:
                if not np.isfinite(box["pose"]).all():
                    raise AssertionError(f"{tag} frame {i}: non-finite pose")
                est.append((times[i], box["pose"]))
                if i > 0 and slam.map.n_kf == kfs:
                    frame_ms.append(ms)
            if imu_frame is None and imu_ready():
                imu_frame = i
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
        setattr(solver_mod, solver, solve)
    peak = torch.cuda.max_memory_allocated()
    m = slam.map
    ate = evaluation.ate_rmse(slam.trajectory(), vi_gt(poses[:n], times[:n]), with_scale=False)
    n_right = int((m.mp_obs_r_level >= 0).sum())
    kfs = [int(k) for k in m.kf_ids()]
    pts = m.local_point_ids(kfs, None)
    tabs = _build_obs_tables(m, pts, {c: i for i, c in enumerate(kfs)}, len(pts))
    table_rows = int(tabs[4][:, D:].sum()) if m.rig is not None else 0
    rig_ok = m.rig is not None and bool((tabs[5][:, D:] == 1).all())
    print(f"{tag} KB8 {'stereo-inertial' if inertial else 'stereo'} {n} frames: tracked "
          f"{len(est)}/{n}" + (f", IMU initialized at frame {imu_frame}" if inertial else "")
          + f", keyframes {slam.n_keyframes()}, map points {slam.n_map_points()}, right-camera rows "
          f"{n_right} in the map, {table_rows} in the BA tables, metric ATE of trajectory() "
          f"{ate * 1e3:.3f} mm, max_memory_allocated {peak / 2**20:.1f} MiB; {solver} calls "
          f"{len(right_rows)}, right rows in the last {right_rows[-1] if right_rows else None}; "
          f"track_stereo_fisheye host ms on {len(frame_ms)} frames without a keyframe "
          "(median / p75): " + (f"{np.median(frame_ms):.3f} / {np.percentile(frame_ms, 75):.3f}"
                                if frame_ms else "none"))
    _check_launches(tag, launches, calls)
    if inertial:
        viba_rows = [r for r in right_rows if r > 0]
        if imu_frame is None or len(est) < 0.95 * n or not ate < 0.08 or not viba_rows:
            raise AssertionError(f"{tag}: IMU initialized at {imu_frame}, tracked {len(est)} of "
                                 f"{n}, ATE {ate:.4f} m, inertial local BAs with right rows "
                                 f"{len(viba_rows)} (bars: initialized, >= 95 %, < 8 cm, >= 1)")
    elif (not rig_ok or n_right <= 50 or len(est) <= 30 or not ate < 0.10 or table_rows <= 50
          or not right_rows or right_rows[-1] <= 50):
        raise AssertionError(f"{tag}: rig {rig_ok}, {n_right} right rows, tracked {len(est)}, ATE "
                             f"{ate:.4f} m, {table_rows} rows in the tables, last local BA "
                             f"{right_rows[-1] if right_rows else None} (bars: > 50, > 30, < 10 cm, "
                             "> 50, > 50)")
    rig_ba = _rig_ba_cost(tag, solve, kept[0], D)
    return launches, calls, dict(
        rig_ba=rig_ba, tracked=len(est), imu_init_frame=imu_frame, keyframes=slam.n_keyframes(),
        points=slam.n_map_points(), right_rows_map=n_right, right_rows_tables=table_rows,
        ba_calls=len(right_rows), ba_calls_with_right_rows=sum(r > 0 for r in right_rows),
        right_rows_last_ba=right_rows[-1] if right_rows else None, ate_metric_m=ate,
        peak_mib=peak / 2**20,
        frame_ms={"median": float(np.median(frame_ms)) if frame_ms else None,
                  "p75": float(np.percentile(frame_ms, 75)) if frame_ms else None})


def phase_group_inertial(window_match, device, work):
    """Phases 7-9: (paths, recorded arguments, results)."""
    paths, recorded = {}, {}
    t0 = time.perf_counter()
    n, calls, rec, vi_stereo, vi_stages = phase7_stereo_inertial(window_match, device)
    paths["stereo-inertial"] = dict(calls, launches=n)
    recorded.update(rec)
    print(f"phase7 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n, calls, vi_rgbd = phase8_rgbd_inertial(window_match, device)
    paths["rgbd-inertial"] = dict(calls, launches=n)
    print(f"phase8 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n, calls, vi_mono = phase9_mono_inertial(window_match, device)
    paths["mono-inertial"] = dict(calls, launches=n)
    print(f"phase9 passed in {time.perf_counter() - t0:.1f} s")
    # two of phase 14 (c)'s four modes of phase 7's frames, in this process,
    # which has the time (phase 7 runs the synchronous inline one, phase
    # 14's process the pipelined one with the worker)
    t0 = time.perf_counter()
    modes = {}
    for pipelined, worker, key in ((True, False, "stereo-inertial pipelined inline 150"),
                                   (False, True, "stereo-inertial worker 150")):
        n, calls, modes[key] = phase14_stereo_inertial(window_match, device, PHASE7_FRAMES,
                                                       pipelined, worker)
        paths[key] = dict(calls, launches=n)
    print(f"phase14 (c) pipelined inline and synchronous with the worker passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return paths, recorded, {"stereo-inertial": vi_stereo, "rgbd-inertial": vi_rgbd,
                             "mono-inertial": vi_mono, "stages": vi_stages, **modes}


def phase_group_loop(window_match, device, work):
    """Phase 10, (d) on phase 4's map saved in WORK."""
    paths, recorded, loop = {}, {}, {}
    t0 = time.perf_counter()
    n, calls, loop["feature_loop"] = phase10_feature_loop(window_match, device)
    paths["feature loop"] = dict(calls, launches=n)
    n, calls, loop["merge"] = phase10_merge(window_match, device)
    paths["kidnap and merge"] = dict(calls, launches=n)
    n, calls, rec, loop["image_loop"], loop["stages"] = phase10_image_loop(window_match, device)
    paths["image loop"] = dict(calls, launches=n)
    recorded.update(rec)
    phase4_map = torch.load(os.path.join(work, "phase4_map.pt"), weights_only=False)
    loop["global_ba"] = phase10_global_ba(phase4_map, device)
    print(f"phase10 passed in {time.perf_counter() - t0:.1f} s")
    return paths, recorded, loop


def phase_group_inertial_loop(window_match, device, work):
    """Phase 11."""
    paths, recorded, loop = {}, {}, {}
    t0 = time.perf_counter()
    n, calls, rec, loop["inertial_loop"], snap = phase11_inertial_loop(window_match, device)
    paths["stereo-inertial loop"] = dict(calls, launches=n)
    recorded.update(rec)
    n, calls, loop["inertial_merge"] = phase11_kidnap(window_match, device)
    paths["inertial kidnap and merge"] = dict(calls, launches=n)
    loop["full_inertial_ba"] = phase11_full_inertial_ba(snap, device)
    print(f"phase11 passed in {time.perf_counter() - t0:.1f} s")
    return paths, recorded, loop


def phase_group_fisheye(window_match, device, work):
    """Phase 12."""
    paths, recorded, fisheye = {}, {}, {}
    t0 = time.perf_counter()
    n, calls, rec, fisheye["mono"] = phase12_mono_fisheye(window_match, device)
    paths["mono fisheye"] = dict(calls, launches=n)
    recorded.update(rec)
    t1 = time.perf_counter()
    inputs = fisheye_stereo_inputs(PHASE12_VI_FRAMES)
    print(f"phase12 rendered {PHASE12_VI_FRAMES} KB8 stereo pairs in {time.perf_counter() - t1:.1f} s")
    for key, inertial in (("stereo fisheye", False), ("stereo-inertial fisheye", True)):
        n, calls, fisheye[key] = phase12_stereo_fisheye(window_match, device, inputs, inertial)
        paths[key] = dict(calls, launches=n)
    print(f"phase12 passed in {time.perf_counter() - t0:.1f} s")
    return paths, recorded, fisheye


# ------------------------------------------------------------------ phase 14
# asynchronous mapping and the deep pipeline: (a) phase 4's frames with the
# mapping worker and loop closing on, beside a synchronous run of the same
# frames; (b) bench.py's mono pass (its config, 300 frames of
# circular_trajectory(300) in scene 7) through track_monocular_pipelined;
# (c) stereo-inertial through track_stereo_pipelined, the 60 frames and
# config of tests/test_stereo_pipelined.py and phase 7's 150; (d) phase 10
# (a)'s feature loop, its whole-map BA on the loop closer's thread
PHASE14_BENCH_FRAMES = 300
PHASE14_BENCH_WARMUP = 12  # bench.py's _mono_pass warm-up frames
PHASE14_VI_FRAMES = 60     # tests/test_stereo_pipelined.py
# the last fuse of (a)'s async run, made on the mapping worker's thread,
# for phase 1
RECORD_AT_ASYNC = {"fuse": None}


def _frame_ms(fn) -> float:
    """Milliseconds of fn() on the host clock, ending in a sync of the
    caller's stream (which the tracking entry points leave waiting on the
    tracking stream): the frame's own work, not the mapping worker's."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.current_stream().synchronize()
    return (time.perf_counter() - t0) * 1e3


def _ms_stats(v) -> dict:
    return {"n": len(v), "median_ms": float(np.median(v)), "p75_ms": float(np.percentile(v, 75)),
            "max_ms": float(max(v))}


def _watch_worker(slam) -> dict:
    """Counts on a SLAM's mapper: keyframes it processed, and (with
    asynchronous mapping) the frames whose keyframe a busy mapper held back
    (the tracker would have inserted one with an idle mapper: an empty
    queue, no keyframe being mapped). Instance attributes: the run's end
    puts nothing back."""
    seen = {"worker_keyframes": 0, "held_back": 0, "busy": 0}
    process = slam.mapper.process_keyframe

    def counted(kf):
        seen["busy"] += 1
        try:
            return process(kf)
        finally:
            seen["busy"] -= 1
            seen["worker_keyframes"] += 1

    need = slam.tracker._need_new_kf

    def probed(*args, **kwargs):
        t = slam.tracker
        out = need(*args, **kwargs)
        if not out and t.queue_probe is not None and (t.queue_probe() > 0 or t.mapper_busy()):
            hooks = t.queue_probe, t.mapper_busy, t.interrupt_ba
            t.queue_probe, t.mapper_busy, t.interrupt_ba = (lambda: 0), (lambda: False), None
            try:
                seen["held_back"] += bool(need(*args, **kwargs))
            finally:
                t.queue_probe, t.mapper_busy, t.interrupt_ba = hooks
        return out

    slam.mapper.process_keyframe = counted
    slam.tracker._need_new_kf = probed
    return seen


def phase14_async_mono(wm_mod, device):
    """(a) Phase 4's 120 frames through `track_monocular` at the default
    config (loop closing on), once synchronously and once with
    `async_mapping=True`, in this process. Fails unless the async run meets
    phase 4's bars (>= 90 % tracked after init, >= 3 keyframes, > 200
    points, Sim(3) ATE < 5 cm), its worker raised nothing, and the window
    match launched once per matcher call. Prints both runs' per-frame host
    ms (every frame, keyframes included: median, p75, the worst), the
    keyframes the worker processed, the frames the queue probe held back
    and the launches per thread. Returns (launches, calls, recorded
    arguments, results)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    frames, _, poses = render_sequence(PHASE4_FRAMES)
    gt = synthetic.gt_trajectory(poses[:PHASE4_FRAMES])
    out, recorded = {}, {}
    for mode in ("sync", "async"):
        slam = SLAM(cameras.euroc_cam0(), SlamConfig(async_mapping=mode == "async"),
                    device=device)
        calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
        restore = _count_loop_matchers(wm_mod, slam, calls, recorded,
                                       RECORD_AT_ASYNC if mode == "async" else {}, "async ")
        seen = _watch_worker(slam) if mode == "async" else {}
        torch.cuda.synchronize()
        wm_mod.launches = 0
        wm_mod.launches_by_thread.clear()
        try:
            ms, tracked, init_frame = [], [], None
            t0 = time.perf_counter()
            for i in range(PHASE4_FRAMES):
                box = {}
                ms.append(_frame_ms(lambda: box.update(
                    pose=slam.track_monocular(frames[i], i * 0.05))))
                if box["pose"] is not None:
                    init_frame = i if init_frame is None else init_frame
                    tracked.append(i)
            slam.wait_idle()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches, by_thread = wm_mod.launches, dict(wm_mod.launches_by_thread)
        finally:
            restore()
        if init_frame is None:
            raise AssertionError(f"phase14 (a) {mode}: the run never initialized")
        after = PHASE4_FRAMES - 1 - init_frame
        n_after = sum(1 for i in tracked if i > init_frame)
        ate = evaluation.ate_rmse(slam.trajectory(), gt, with_scale=True)
        stats = _ms_stats(ms[init_frame + 1:])
        out[mode] = dict(init_frame=init_frame, tracked_after_init=n_after, after=after,
                         keyframes=slam.n_keyframes(), points=slam.n_map_points(), ate_m=ate,
                         frames=stats, wall_s=wall, launches=launches, calls=calls,
                         launches_by_thread=by_thread, worker_errors=slam.worker_errors,
                         loops=slam.loopcloser.n_loops, **seen)
        print(f"phase14 (a) {mode} mono {PHASE4_FRAMES} frames: initialized at frame "
              f"{init_frame}, tracked {n_after}/{after} after init, keyframes "
              f"{slam.n_keyframes()}, map points {slam.n_map_points()}, Sim(3)-aligned ATE "
              f"{ate * 1e3:.3f} mm, worker_errors {slam.worker_errors}, wall {wall:.1f} s")
        print(f"phase14 (a) {mode} per-frame host ms after init, keyframe frames included "
              f"(median / p75 / worst): {stats['median_ms']:.3f} / {stats['p75_ms']:.3f} / "
              f"{stats['max_ms']:.3f}")
        if mode == "async":
            print(f"phase14 (a) async: keyframes the worker processed {seen['worker_keyframes']}, "
                  f"frames "
                  f"whose keyframe the busy mapper held back {seen['held_back']}, "
                  f"window_match launches by thread {by_thread}")
        _check_launches(f"phase14 (a) {mode}", launches, calls)
        if n_after < 0.9 * after or slam.n_keyframes() < 3 or slam.n_map_points() <= 200:
            raise AssertionError(f"phase14 (a) {mode}: < 90 % tracked, < 3 keyframes or <= 200 "
                                 "points")
        if not ate < 0.05 or slam.worker_errors != 0:
            raise AssertionError(f"phase14 (a) {mode}: ATE {ate:.4f} m >= 5 cm or "
                                 f"{slam.worker_errors} worker errors")
        del slam
    if out["async"]["launches_by_thread"].get("mapping", 0) == 0 or "async fuse" not in recorded:
        raise AssertionError("phase14 (a): the worker thread launched no fuse")
    a = out["async"]
    return a["launches"], a["calls"], recorded, out


def phase14_bench_mono(wm_mod, device):
    """(b) bench.py's mono pass on the port: its config (1024 features,
    local map 4096, local BA 2048, a keyframe at least every 10 frames,
    min_init_matches 60, async mapping), 300 frames of
    circular_trajectory(300) in scene 7 through `track_monocular_pipelined`,
    then `flush_pipeline()` and `wait_idle()`. Fails unless the Sim(3) ATE
    of the trajectory is < 5 cm, the worker raised nothing and the window
    match launched once per matcher call. Frames per second as bench.py
    takes them (1 / the median per-call host time after 12 warm-up calls),
    and over the run's wall clock."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    frames, _, poses = render_sequence(PHASE14_BENCH_FRAMES)
    cfg = SlamConfig(n_features=1024, local_points_cap=4096, local_ba_points=2048,
                     max_frames_between_kf=10, min_init_matches=60, async_mapping=True)
    slam = SLAM(cameras.euroc_cam0(), cfg, device=device)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        ms = []
        t0 = time.perf_counter()
        for i in range(PHASE14_BENCH_FRAMES):
            ms.append(_frame_ms(lambda: slam.track_monocular_pipelined(frames[i], i * 0.05)))
        slam.flush_pipeline()
        slam.wait_idle()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
    ate = evaluation.ate_rmse(slam.trajectory(), synthetic.gt_trajectory(poses), with_scale=True)
    stats = _ms_stats(ms[PHASE14_BENCH_WARMUP:])
    fps = 1e3 / stats["median_ms"]
    print(f"phase14 (b) bench mono pass, {PHASE14_BENCH_FRAMES} frames pipelined with async "
          f"mapping: {len(slam.trajectory())} poses, keyframes {slam.n_keyframes()}, map points "
          f"{slam.n_map_points()}, loops {slam.loopcloser.n_loops}, Sim(3)-aligned ATE "
          f"{ate * 1e3:.3f} mm, worker_errors {slam.worker_errors}")
    print(f"phase14 (b) frames per second {fps:.2f} (1 / median call after "
          f"{PHASE14_BENCH_WARMUP} warm-up calls), {PHASE14_BENCH_FRAMES / wall:.2f} over the "
          f"wall clock ({wall:.1f} s, flush and drain included); per-call host ms (median / p75 / "
          f"worst): {stats['median_ms']:.3f} / {stats['p75_ms']:.3f} / {stats['max_ms']:.3f}")
    _check_launches("phase14 (b)", launches, calls)
    if not ate < 0.05 or slam.worker_errors != 0:
        raise AssertionError(f"phase14 (b): ATE {ate:.4f} m >= 5 cm or {slam.worker_errors} "
                             "worker errors")
    return launches, calls, dict(fps=fps, fps_wall=PHASE14_BENCH_FRAMES / wall, wall_s=wall,
                                 frames=stats, ate_m=ate, keyframes=slam.n_keyframes(),
                                 poses=len(slam.trajectory()))


PHASE14_MODES = {(True, True): "pipelined, worker", (True, False): "pipelined, inline",
                 (False, True): "synchronous, worker", (False, False): "synchronous, inline"}


def phase14_stereo_inertial(wm_mod, device, n: int, pipelined: bool = True,
                            async_mapping: bool = True):
    """(c) Stereo-inertial SLAM over the first n frames of `vi_sequence(n)`
    (scene 7, the right view b to the right), through
    `track_stereo_pipelined` (or `track_stereo` when not `pipelined`), with
    the mapping worker (or inline when not `async_mapping`): n = 60 at
    tests/test_stereo_pipelined.py's config (768 features, local map and BA
    2048, a keyframe every 5 frames) to its bars (IMU initialized, > 45
    poses, metric ATE < 15 cm; pipelined < 4 cm, ROADMAP C17); n = 150 at
    phase 7's config to phase 7's bars (IMU initialized, >= 95 % tracked,
    metric ATE < 8 cm). Loop closing off, as both. The tracker's VI refinement must be captured into its
    CUDA graph and replayed (beside the worker, when there is one); fails
    also on a worker error or launches that differ from the matcher calls.
    Prints the frames the tracker refined with the IMU."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config, evaluation

    mode = PHASE14_MODES[(pipelined, async_mapping)]
    left, right, rows, times, poses = vi_inputs(n, 7, "right")
    widths = (dict(n_features=768, local_points_cap=2048, local_ba_points=2048,
                   max_frames_between_kf=5) if n == PHASE14_VI_FRAMES else
              dict(n_features=1024, local_points_cap=4096, local_ba_points=2048,
                   max_frames_between_kf=10, min_init_matches=60))
    cfg = config.SlamConfig(sensor=config.IMU_STEREO, enable_loop_closing=False,
                            async_mapping=async_mapping, **widths)
    slam = SLAM(cameras.euroc_cam0(), cfg, imu_calib=imu_calib(), device=device)
    seen = _watch_worker(slam)
    graph = slam.tracker._pose_inertial
    capture, replays, captured_busy = graph._capture, [0], []

    def watched_capture(*args):
        queued = slam._map_queue is not None and slam._map_queue.qsize() > 0
        captured_busy.append(seen["busy"] > 0 or queued)
        return capture(*args)

    graph._capture = watched_capture
    run_graph = slam.tracker._pose_inertial

    def counted_graph(*args):
        replays[0] += 1
        return run_graph(*args)

    slam.tracker._pose_inertial = counted_graph
    # frames the tracker refined with the IMU (an IMU-initialized map)
    vi_refine, refines = slam.tracker._vi_refine, [0]

    def counted_refine(*args):
        refines[0] += 1
        return vi_refine(*args)

    slam.tracker._vi_refine = counted_refine
    track = slam.track_stereo_pipelined if pipelined else slam.track_stereo
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    originals = _count_matchers(wm_mod, calls, ThreadStack(), {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        ms = []
        for i in range(n):
            ms.append(_frame_ms(lambda: track(left[i], right[i], times[i],
                                              imu_samples=rows[i])))
        if pipelined:
            slam.flush_pipeline()
        slam.wait_idle()
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    traj = slam.trajectory()
    ate = evaluation.ate_rmse(traj, vi_gt(poses, times), with_scale=False)
    imu_init = slam.map.map_imu_init.get(slam.map.active_map, False)
    stats = _ms_stats(ms[slam.cfg.pipeline_depth if pipelined else 0:])
    print(f"phase14 (c) stereo-inertial {mode}, {n} frames: IMU initialized {imu_init}, "
          f"poses {len(traj)}, keyframes {slam.n_keyframes()} (the mapper processed "
          f"{seen['worker_keyframes']}, the busy mapper held back {seen['held_back']}), metric ATE "
          f"{ate * 1e3:.3f} mm, worker_errors {slam.worker_errors}; VI refinement graphs "
          f"captured {len(captured_busy)} (with the worker busy: {sum(captured_busy)}), calls "
          f"{replays[0]}, IMU-refined frames {refines[0]}; per-call host ms (median / p75 / worst) "
          f"{stats['median_ms']:.3f} / {stats['p75_ms']:.3f} / {stats['max_ms']:.3f}")
    _check_launches(f"phase14 (c) {mode} {n}", launches, calls)
    if n == PHASE14_VI_FRAMES:
        # < 40 mm: on an H100 the deep pipeline's stale seed after the
        # initialization (ROADMAP C17) put these 60 frames at 55.5-59.1 mm;
        # without it they land at 14-17 mm, and at 28 mm once beside the
        # other phase groups
        ok = imu_init and len(traj) > 45 and ate < (0.04 if pipelined else 0.15)
    else:
        ok = imu_init and len(traj) >= 0.95 * n and ate < 0.08
    if not ok or slam.worker_errors != 0:
        raise AssertionError(f"phase14 (c) {mode} {n}: IMU init {imu_init}, {len(traj)} poses, "
                             f"metric ATE {ate:.4f} m, {slam.worker_errors} worker errors")
    if not captured_busy or replays[0] == 0 or calls["init"] != 0:
        raise AssertionError(f"phase14 (c) {mode} {n}: the VI refinement's graph was not "
                             "captured and replayed, or the two-view init ran")
    return launches, calls, dict(mode=mode, imu_init=bool(imu_init), poses=len(traj), ate_m=ate,
                                 keyframes=slam.n_keyframes(), frames=stats,
                                 graphs_captured=len(captured_busy),
                                 captured_with_worker_busy=sum(captured_busy),
                                 graph_calls=replays[0], **seen)


def phase14_background_gba(wm_mod, device):
    """(d) Phase 10 (a)'s feature loop with async mapping, the tracker never
    waiting for the worker: it must meet phase 10 (a)'s bars (a loop or
    merge, > 70 poses, Sim(3) ATE < 8 cm, finite points), a loop's
    whole-map BA must have run on the loop closer's thread and been joined
    by `wait_idle`, the worker must have raised nothing, and the window
    match must have launched once per matcher call."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic

    cam = cameras.euroc_cam0()
    world = synthetic.make_ring_world(13)
    poses = synthetic.circular_trajectory(PHASE10_FEATURE_FRAMES, arc=1.06, outward=True)
    feats = [synthetic.render_features(world, cam, R, t, n_feat=512, seed=1300 + i, noise_px=0.7,
                                       device=device)[0] for i, (R, t) in enumerate(poses)]
    slam = SLAM(cam, _loop_cfg(n_features=512, local_points_cap=2048, local_ba_points=2048,
                               min_init_matches=60, async_mapping=True), device=device)
    gba_threads = []
    for name in ("global_ba", "full_inertial_ba"):
        fn = getattr(slam.mapper, name)

        def on_thread(*args, _fn=fn, **kwargs):
            gba_threads.append(threading.current_thread().name)
            return _fn(*args, **kwargs)

        setattr(slam.mapper, name, on_thread)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    restore = _count_loop_matchers(wm_mod, slam, calls, {}, {})
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        est = []
        for i in range(PHASE10_FEATURE_FRAMES):
            pose = slam.track_features(feats[i], i * 0.05)
            if pose is not None:
                est.append((i * 0.05, pose))
        slam.wait_idle()
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
    lc = slam.loopcloser
    tag = "phase14 (d)"
    ate = evaluation.ate_rmse(est, synthetic.gt_trajectory(poses), with_scale=True)
    finite = bool(np.isfinite(slam.map.mp_pos[slam.map.mp_ids()]).all())
    print(f"{tag} feature loop with async mapping, {PHASE10_FEATURE_FRAMES} frames: poses "
          f"{len(est)}, loops {lc.n_loops}, merges {lc.n_merges}, keyframes {slam.n_keyframes()}, "
          f"whole-map BAs on threads {gba_threads}, running after wait_idle {lc.gba_running}, "
          f"Sim(3)-aligned ATE {ate * 1e3:.3f} mm, points finite {finite}, worker_errors "
          f"{slam.worker_errors}")
    _check_launches(tag, launches, calls)
    if len(est) <= 70 or not ate < 0.08 or not finite or slam.worker_errors != 0:
        raise AssertionError(f"{tag}: <= 70 poses, ATE >= 8 cm, a non-finite point, or "
                             f"{slam.worker_errors} worker errors")
    if lc.n_loops + lc.n_merges < 1:
        raise AssertionError(f"{tag}: no loop or merge")
    if lc.n_loops and (set(gba_threads) != {"gba"} or lc.gba_running):
        raise AssertionError(f"{tag}: the whole-map BA ran on {gba_threads}, not on its own "
                             "thread, or was not joined")
    return launches, calls, dict(poses=len(est), loops=lc.n_loops, merges=lc.n_merges, ate_m=ate,
                                 gba_threads=gba_threads, keyframes=slam.n_keyframes())


def phase_group_async(window_match, device, work):
    """Phase 14."""
    paths, recorded, out = {}, {}, {}
    t0 = time.perf_counter()
    n, calls, rec, out["async_mono"] = phase14_async_mono(window_match, device)
    paths["async mono"] = dict(calls, launches=n)
    recorded.update(rec)
    print(f"phase14 (a) passed in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    n, calls, out["bench_mono"] = phase14_bench_mono(window_match, device)
    paths["bench mono pipelined"] = dict(calls, launches=n)
    print(f"phase14 (b) passed in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for frames_n, key in ((PHASE14_VI_FRAMES, "stereo-inertial pipelined 60"),
                          (PHASE7_FRAMES, "stereo-inertial pipelined 150")):
        n, calls, out[key] = phase14_stereo_inertial(window_match, device, frames_n)
        paths[key] = dict(calls, launches=n)
    print(f"phase14 (c) passed in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    n, calls, out["background_gba"] = phase14_background_gba(window_match, device)
    paths["feature loop async"] = dict(calls, launches=n)
    print(f"phase14 (d) passed in {time.perf_counter() - t1:.1f} s")
    print(f"phase14 passed in {time.perf_counter() - t0:.1f} s")
    return paths, recorded, out


# ------------------------------------------------------------------ phase 15
# the tools users run beside the engine (orb_slam3_comments_ghr_torch/scripts),
# on a stand-in EuRoC ground truth: the JAX package's own estimate of MH01's
# real motion (results/, 3637 poses at 20 Hz) written in EuRoC's layout.
# (a) run_gt_replay, features, mono, the first PHASE15_MONO_FRAMES frames, to
# tests/test_gt_replay.py's bars; (b) run_gt_replay, rendered stereo images
# with the IMU and loop closing on, the first PHASE15_VI_FRAMES frames, to
# tests/test_torch_gt_replay.py's stereo bars and an initialized IMU; (c)
# phase 10 (a)'s loop with the 100k-word tree; (d) train_vocabulary on the
# card, its file round trip, and eval_vocabulary of the two shipped trees
PHASE15_TUM = os.path.join("results", "mh01_img_stereo_full_r5.tum")
PHASE15_MONO_FRAMES = 600
PHASE15_VI_FRAMES = 200
PHASE15_VOC_KF = 150      # database keyframes of (d) (as many queries)
PHASE15_TRAIN = ["--synthetic", "60", "--k", "10", "--L", "3"]
# the window-match call of (a) kept for phase 1: its 300th tracking call
RECORD_AT_GT = {"tracking": 300}


def repo_root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def phase15_stand_in_gt(work: str) -> None:
    """Write PHASE15_TUM as WORK/euroc_gt/MH01_GT.txt and point the port's
    `gt_replay.GT_DIR` there."""
    from orb_slam3_comments_ghr_torch.utils import gt_replay

    folder = os.path.join(work, "euroc_gt")
    os.makedirs(folder, exist_ok=True)
    n = gt_replay.euroc_gt_from_tum(os.path.join(repo_root(), PHASE15_TUM),
                                    os.path.join(folder, "MH01_GT.txt"))
    gt_replay.GT_DIR = folder
    print(f"phase15 stand-in ground truth: {n} poses of {PHASE15_TUM} as MH01_GT.txt")


def phase15_gt_replay(wm_mod, argv, tag: str, record_at: dict):
    """`scripts/run_gt_replay` with `argv` on the card, the window match's
    launches counted from 0 against its callers' calls (the loop closer's
    apart) and its arguments recorded as `record_at` says under "gt replay
    ...". Returns (launches, calls, recorded, the JSON line's dict, the
    SLAM)."""
    from orb_slam3_comments_ghr_torch.scripts import run_gt_replay

    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded, box = {}, {}

    def on_start(slam):
        box["restore"] = _count_loop_matchers(wm_mod, slam, calls, recorded, record_at,
                                              "gt replay ")
        torch.cuda.synchronize()
        wm_mod.launches = 0

    try:
        result, slam = run_gt_replay.replay(run_gt_replay.parse_args(argv), on_start=on_start)
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        if "restore" in box:
            box["restore"]()
    print(f"{tag} run_gt_replay {' '.join(argv)}: {json.dumps(result)}")
    _check_launches(tag, launches, calls)
    return launches, calls, recorded, result, slam


def phase15_replay_mono(wm_mod):
    """(a) Fails unless > 90 % of the frames are tracked in one map with a
    Sim(3) ATE < 5 cm (tests/test_gt_replay.py)."""
    n, calls, rec, r, _ = phase15_gt_replay(
        wm_mod, ["--sensor", "mono", "--render", "features", "--max-frames",
                 str(PHASE15_MONO_FRAMES)], "phase15 (a)", RECORD_AT_GT)
    if not (r["tracked"] > 0.9 * r["frames"] and r["maps"] == 1 and r["ate_rmse_m"] < 0.05):
        raise AssertionError(f"phase15 (a): {r}")
    return n, calls, rec, r


def phase15_replay_stereo_inertial(wm_mod):
    """(b) Fails unless > 90 % of the frames are tracked in one map with no
    reset, the IMU initialized and the metric ATE < 5 cm
    (tests/test_torch_gt_replay.py's stereo image replay)."""
    n, calls, _, r, slam = phase15_gt_replay(
        wm_mod, ["--sensor", "imu-stereo", "--render", "images", "--max-frames",
                 str(PHASE15_VI_FRAMES)], "phase15 (b)", {})
    r["imu_init"] = bool(slam.map.map_imu_init.get(slam.map.active_map, False))
    resets = r["map_resets"] + r["lost_resets"] + r["submap_spawns"]
    print(f"phase15 (b) IMU initialized {r['imu_init']}, worker_errors {slam.worker_errors}")
    if not (r["tracked"] > 0.9 * r["frames"] and r["maps"] == 1 and resets == 0
            and r["imu_init"] and r["ate_rmse_noscale_m"] < 0.05):
        raise AssertionError(f"phase15 (b): {r}")
    return n, calls, r


def _same_vocabulary(a, b) -> bool:
    return (a.k == b.k and a.L == b.L and a.idf.tobytes() == b.idf.tobytes()
            and all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                    for x, y in zip(a.levels, b.levels)))


def phase15_vocabulary(device, work: str) -> dict:
    """(d) train_vocabulary on PHASE15_TRAIN's synthetic views, its file
    loaded and saved again bit for bit; then eval_vocabulary on
    PHASE15_VOC_KF database keyframes of the stand-in motion: the shipped
    10k and 100k trees must both reach p@1 >= 0.9 (the trained tree is
    scored beside them)."""
    from orb_slam3_comments_ghr_torch.retrieval.vocabulary import Vocabulary
    from orb_slam3_comments_ghr_torch.scripts import eval_vocabulary, train_vocabulary

    path = os.path.join(work, "voc_trained.npz")
    t0 = time.perf_counter()
    voc = train_vocabulary.train(train_vocabulary.parse_args(PHASE15_TRAIN + ["--out", path]))
    train_s = time.perf_counter() - t0
    loaded = Vocabulary.load(path, device=device)
    again = os.path.join(work, "voc_trained_again.npz")
    loaded.save(again)
    round_trip = _same_vocabulary(voc, loaded) and _same_vocabulary(
        loaded, Vocabulary.load(again, device=device))
    print(f"phase15 (d) train_vocabulary {' '.join(PHASE15_TRAIN)}: {voc.n_words} words in "
          f"{train_s:.1f} s; save / load bit for bit {round_trip}")
    t0 = time.perf_counter()
    frames = eval_vocabulary._build_frames(PHASE15_VOC_KF, 1024, 7, device)
    retrieval = os.path.join(repo_root(), "orb_slam3_comments_ghr_torch", "retrieval")
    scores = {}
    for name, p in (("10k", os.path.join(retrieval, "default_voc.npz")),
                    ("100k", os.path.join(retrieval, "voc_100k.npz")), ("trained", path)):
        scores[name] = eval_vocabulary._score(p, frames, 2.0, device)
        print(f"phase15 (d) eval_vocabulary {name}: {json.dumps(scores[name])}")
    print(f"phase15 (d) eval over {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    if not round_trip:
        raise AssertionError("phase15 (d): the trained vocabulary did not round-trip bit for bit")
    if not all(scores[k]["precision_at_1"] >= 0.9 for k in ("10k", "100k")):
        raise AssertionError(f"phase15 (d): p@1 under 0.9: {scores}")
    return dict(train_s=train_s, n_words=voc.n_words, round_trip=round_trip, scores=scores)


def phase_group_gt_tools(window_match, device, work):
    """Phase 15."""
    paths, recorded, out = {}, {}, {}
    t0 = time.perf_counter()
    phase15_stand_in_gt(work)
    n, calls, rec, out["gt_replay_mono"] = phase15_replay_mono(window_match)
    paths["gt replay mono"] = dict(calls, launches=n)
    recorded.update(rec)
    print(f"phase15 (a) passed in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    n, calls, out["gt_replay_stereo_inertial"] = phase15_replay_stereo_inertial(window_match)
    paths["gt replay stereo-inertial"] = dict(calls, launches=n)
    print(f"phase15 (b) passed in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    voc_100k = os.path.join(repo_root(), "orb_slam3_comments_ghr_torch", "retrieval",
                            "voc_100k.npz")
    n, calls, out["feature_loop_100k"] = phase10_feature_loop(window_match, device, voc_100k,
                                                              "phase15 (c)")
    paths["feature loop 100k"] = dict(calls, launches=n)
    print(f"phase15 (c) passed in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["vocabulary"] = phase15_vocabulary(device, work)
    print(f"phase15 (d) passed in {time.perf_counter() - t1:.1f} s")
    print(f"phase15 passed in {time.perf_counter() - t0:.1f} s")
    return paths, recorded, out


# ------------------------------------------------------------------ phase 13
# EuRoC-like timestamps of the CLI's dataset folders (nanoseconds in the files)
PHASE13_T0 = 1403636579.0
# the window-match calls of the CLI runs kept for phase 1: in (a) the 60th
# tracking call and the last fuse, in (b) the 60th tracking call; in (c)'s
# second session the loop closer's last projection count and first fuse,
# where it makes them
RECORD_AT_CLI = {"tracking": 60, "fuse": None}
RECORD_AT_CLI_STEREO = {"tracking": 60}
RECORD_AT_SESSION2 = {"loop_count": None, "loop_fuse": 1}
# (c): the second session re-tracks phase 4's first frames, 100 s later
PHASE13_SESSION2_FRAMES = 40
PHASE13_SESSION2_CHECK = 25  # > 10 of these first frames must be tracked
# (d): the problem of __graft_entry__.dryrun_multichip (64 keyframes, 16384
# points, 8 observations each) on DBA_RANKS ranks sharing the card
DBA_K, DBA_P, DBA_D = 64, 16384, 8
DBA_ITERS = 10
DBA_RANKS = 2
ALLREDUCE_REPS = 20
# (e): the live whole-map BA's iterations (tests/test_parallel.py)
GBA_ITERS = 6
WORKER_TIMEOUT_S = 600


def scratch_dir() -> str:
    """The checkout's git-ignored `build/` directory, for phase 13's files."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(d, exist_ok=True)
    return d


def euroc_stereo_yaml(path: str, cam) -> None:
    """A v1.0 ORB-SLAM3 settings file of the rectified EuRoC rig: cam0's
    intrinsics, the baseline as Stereo.b, the default ORB budget."""
    rows = ['%YAML:1.0', 'File.version: "1.0"', 'Camera.type: "PinHole"',
            *(f"Camera1.{k}: {getattr(cam, k)!r}" for k in ("fx", "fy", "cx", "cy")),
            f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
            f"Camera.fps: {cam.fps!r}", f"Stereo.b: {cam.bf / cam.fx!r}",
            "ORBextractor.nFeatures: 1024", "ORBextractor.scaleFactor: 1.2",
            "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20", "ORBextractor.minThFAST: 7"]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def run_cli(wm_mod, argv, calls: dict, recorded: dict, record_at: dict, prefix: str):
    """`io.run_slam.main(argv)` with the window match's callers counted (and
    recorded as `_recording` says) on the SLAM it makes. Returns (its JSON
    result, the SLAM, launches, peak device bytes, wall seconds)."""
    import contextlib
    import io

    from orb_slam3_comments_ghr_torch import system
    from orb_slam3_comments_ghr_torch.io import run_slam

    made, restores = [], []
    base = system.SLAM

    class CountedSLAM(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
            restores.append(_count_loop_matchers(wm_mod, self, calls, recorded, record_at,
                                                 prefix))

    system.SLAM = CountedSLAM
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm_mod.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run_slam.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wm_mod.launches
    finally:
        system.SLAM = base
        for restore in restores:
            restore()
    if len(made) != 1:
        raise AssertionError(f"the CLI made {len(made)} SLAM objects")
    return (json.loads(buf.getvalue().strip().splitlines()[-1]), made[0], launches,
            torch.cuda.max_memory_allocated(), wall)


def init_frame(slam, t0: float, stereo: bool):
    """The index (20 Hz from t0) of the frame that initialized the map: the
    first keyframe's (stereo) or the second's (the current frame of the
    two-view init), or None without them."""
    kf = 0 if stereo else 1
    if slam.map.n_kf <= kf:
        return None
    return int(round((slam.map.kf_time[kf] - t0) / 0.05))


def phase13_cli(wm_mod, seq, right=None):
    """(a) without `right`: `python -m orb_slam3_comments_ghr_torch.io.run_slam
    --sensor mono` (through `run_slam.main`, on the card: no --device) over
    phase 4's 120 frames written as an EuRoC folder (npy) with a TUM
    ground-truth file. Fails unless the CLI reports 120 frames, >= 90 % of
    the frames after the init tracked, >= 3 keyframes, > 200 points and a
    Sim(3) ATE < 5 cm. (b) with `right` (phase 5's rectified right views as
    cam1): `--sensor stereo --settings` a v1.0 settings file of the rig
    (PyYAML reads it). Fails unless 120 frames, tracking from frame 0, >= 90
    % tracked, Sim(3) ATE < 6 cm. Both: the window match launched once per
    matcher call. Returns (launches, calls, recorded arguments, results)."""
    import tempfile

    from orb_slam3_comments_ghr_torch.io import config_yaml, datasets, native_loader
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.utils import config, synthetic

    frames, _, poses = seq
    n = PHASE4_FRAMES
    stereo = right is not None
    tag = "phase13 (b) CLI stereo" if stereo else "phase13 (a) CLI mono"
    prefix = "cli stereo " if stereo else "cli "
    cam = cameras.euroc_cam0()
    times = [PHASE13_T0 + i * 0.05 for i in range(n)]
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded = {}
    with tempfile.TemporaryDirectory(prefix="phase13_", dir=scratch_dir()) as root:
        t0 = time.perf_counter()
        datasets.write_synthetic_euroc(root, list(frames[:n]), times,
                                       images_right=list(right[:n]) if stereo else None)
        gt = os.path.join(root, "groundtruth.txt")
        synthetic.write_tum_groundtruth(gt, poses[:n], times)
        write_s = time.perf_counter() - t0
        argv = ["--dataset", "euroc", "--root", root, "--sensor", "stereo" if stereo else "mono",
                "--out", os.path.join(root, "trajectory_tum.txt"), "--gt", gt]
        if stereo:
            settings = os.path.join(root, "EuRoC_stereo.yaml")
            euroc_stereo_yaml(settings, cam)
            loaded = config_yaml.load_settings(settings, sensor=config.STEREO)[0]
            if (loaded.fx, loaded.fy, loaded.cx, loaded.cy) != (cam.fx, cam.fy, cam.cx, cam.cy) \
                    or abs(loaded.bf - cam.bf) > 1e-9 * cam.bf:
                raise AssertionError(f"{tag}: the settings file gave {loaded}, not {cam}")
            argv += ["--settings", settings]
        probe = native_loader.PrefetchLoader([os.path.join(root, "mav0", "cam0", "data",
                                                           f"{int(times[0] * 1e9)}.npy")])
        native = probe.native
        probe.close()
        res, slam, launches, peak, wall = run_cli(
            wm_mod, argv, calls, recorded, RECORD_AT_CLI_STEREO if stereo else RECORD_AT_CLI,
            prefix)
        traj_lines = len(open(os.path.join(root, "trajectory_tum.txt")).read().splitlines())
    init = init_frame(slam, PHASE13_T0, stereo)
    print(f"{tag}: {json.dumps(res)}")
    print(f"{tag}: wrote the folder in {write_s:.1f} s; native prefetcher {native}; "
          f"initialized at frame {init}; {traj_lines} trajectory lines; {wall:.1f} s in main; "
          f"max_memory_allocated {peak / 2**20:.1f} MiB; loops {slam.loopcloser.n_loops}, "
          f"merges {slam.loopcloser.n_merges}")
    _check_launches(tag, launches, calls)
    if res["frames"] != n or init is None:
        raise AssertionError(f"{tag}: {res['frames']} frames, initialized at frame {init}")
    if stereo:
        if init != 0 or res["tracked"] < 0.9 * n or not res["ate_rmse"] < 0.06:
            raise AssertionError(f"{tag}: initialized at frame {init}, tracked {res['tracked']}, ATE "
                                 f"{res['ate_rmse']} m (bars: 0, >= 90 %, < 6 cm)")
        if calls["init"] != 0:
            raise AssertionError(f"{tag}: the two-view init ran")
    else:
        after = n - 1 - init
        if (res["tracked"] - 1 < 0.9 * after or res["keyframes"] < 3
                or res["map_points"] <= 200 or not res["ate_rmse"] < 0.05):
            raise AssertionError(f"{tag}: tracked {res['tracked'] - 1} of {after} after the "
                                 f"init, {res['keyframes']} keyframes, {res['map_points']} "
                                 f"points, ATE {res['ate_rmse']} m (bars: >= 90 %, >= 3, > 200, "
                                 "< 5 cm)")
        if calls["init"] == 0 or calls["fuse"] == 0:
            raise AssertionError(f"{tag}: the init or the fuse path never ran")
    return launches, calls, recorded, dict(res, init_frame=init, native_prefetcher=native,
                                           peak_mib=peak / 2**20, main_s=wall)


ATLAS_COUNTERS = ("n_kf", "n_mp", "active_map", "n_maps", "version", "_mp_free", "map_imu_init",
                  "map_viba1", "map_viba2", "rig")


def phase13_save_atlas(slam, root: str, device) -> dict:
    """(c), first half, on phase 4's final SLAM: `save_atlas`, then
    `load_atlas(new_session=False)` into a new SLAM of phase 4's
    configuration. Fails unless every array of the file and every counter
    comes back bit for bit. Also writes the atlas of a copy of the map with
    phase 10 (d)'s seeded noise (`_perturb`), for (e). Returns the files'
    paths, the first one's bytes, the save and load ms, and session 1's
    keyframes."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.map import persistence
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    path = os.path.join(root, "phase4_atlas.npz")
    save_ms = host_ms(lambda: slam.save_atlas(path))
    read_ms = host_ms(lambda: persistence.load_atlas(path, voc=slam.voc))
    fresh = SLAM(cameras.euroc_cam0(), SlamConfig(enable_loop_closing=False), device=device)
    load_ms = host_ms(lambda: fresh.load_atlas(path, new_session=False))
    for k in persistence._ARRAYS:
        a, b = getattr(fresh.map, k), getattr(slam.map, k)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"phase13 (c): {k} differs after the round trip")
    for k in ATLAS_COUNTERS:
        if getattr(fresh.map, k) != getattr(slam.map, k):
            raise AssertionError(f"phase13 (c): the counter {k} differs after the round trip")
    noisy = os.path.join(root, "phase4_atlas_perturbed.npz")
    persistence.save_atlas(convert.map_state_from_numpy(_perturb(convert.map_state_to_numpy(
        slam.map))), noisy, voc=slam.voc)
    out = dict(path=path, perturbed_path=noisy, bytes=os.path.getsize(path), save_ms=save_ms,
               read_ms=read_ms, load_ms=load_ms, keyframes=slam.n_keyframes(),
               points=slam.n_map_points(), maps=slam.map.n_maps)
    print(f"phase13 (c) atlas of phase 4's final map ({out['keyframes']} keyframes, "
          f"{out['points']} points, {out['maps']} maps): {out['bytes']} bytes; save_atlas "
          f"{save_ms:.1f} ms, persistence.load_atlas {read_ms:.1f} ms, SLAM.load_atlas "
          f"(new_session=False; the database refilled) {load_ms:.1f} ms; every array and "
          "counter bit-equal")
    return out


def phase13_second_session(wm_mod, seq, atlas: dict, device):
    """(c), second half: a new SLAM (the default configuration: loop
    closing on) loads the atlas with new_session=True and tracks phase 4's
    frames 0..PHASE13_SESSION2_FRAMES-1 again, 100 s later, through
    `track_monocular`. Fails unless the new sub-map is the active one after
    the load, > 10 of the first 25 frames are tracked, session 1's
    keyframes are all still valid, and the window match launched once per
    matcher call. Returns (launches, calls, recorded arguments, results)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM

    frames = seq[0]
    slam = SLAM(cameras.euroc_cam0(), device=device)
    slam.load_atlas(atlas["path"], new_session=True)
    active_after_load = slam.map.active_map
    loaded = slam.map.kf_ids(0)
    calls = {"tracking": 0, "init": 0, "fuse": 0, "loop_count": 0, "loop_fuse": 0}
    recorded = {}
    restore = _count_loop_matchers(wm_mod, slam, calls, recorded, RECORD_AT_SESSION2, "atlas ")
    torch.cuda.synchronize()
    wm_mod.launches = 0
    try:
        tracked = [slam.track_monocular(frames[i], 100.0 + i * 0.05) is not None
                   for i in range(PHASE13_SESSION2_FRAMES)]
        torch.cuda.synchronize()
        launches = wm_mod.launches
    finally:
        restore()
    lc = slam.loopcloser
    still_valid = int(slam.map.kf_valid[loaded].sum())
    first = sum(tracked[:PHASE13_SESSION2_CHECK])
    out = dict(active_after_load=int(active_after_load), tracked=sum(tracked),
               tracked_first=first, session1_keyframes=len(loaded),
               session1_still_valid=still_valid, active_map_keyframes=slam.n_keyframes(),
               maps=slam.map.n_maps, active_map=int(slam.map.active_map), merges=lc.n_merges,
               loops=lc.n_loops, into_map0=bool(lc.n_merges or slam.map.active_map == 0))
    print(f"phase13 (c) second session: active map {active_after_load} after the load; tracked "
          f"{first}/{PHASE13_SESSION2_CHECK} of the first frames, {sum(tracked)}/"
          f"{PHASE13_SESSION2_FRAMES} in all; session 1's keyframes still valid {still_valid}/"
          f"{len(loaded)}; merges {lc.n_merges}, loops {lc.n_loops}, active map "
          f"{slam.map.active_map} of {slam.map.n_maps}: "
          + ("merged or relocalized into map 0" if out["into_map0"] else
             "tracking went on in the new sub-map"))
    _check_launches("phase13 (c) second session", launches, calls)
    if active_after_load != 1 or first <= 10 or still_valid < len(loaded):
        raise AssertionError("phase13 (c): the new sub-map is not active after the load, <= 10 "
                             "of the first frames tracked, or a loaded keyframe was lost")
    return launches, calls, recorded, out


def dryrun_problem(seed: int = 0) -> dict:
    """The whole-map BA problem of __graft_entry__.dryrun_multichip, drawn
    with numpy from `seed`: DBA_K keyframes on a 4 m line, DBA_P points 6-12
    m out, each seen by a contiguous window of DBA_D cameras from a random
    start, noise-free pixels, the points 1 cm off, the first keyframe
    fixed. Returns the BAProblem's arrays."""
    from orb_slam3_comments_ghr_torch.ops import cameras

    cam = cameras.euroc_cam0()
    rng = np.random.default_rng(seed)
    K, P, D = DBA_K, DBA_P, DBA_D
    uv = (rng.uniform(size=(P, 2)) * np.array([700.0, 440.0]) + 20.0).astype(np.float32)
    rays = cameras.unproject(cam, torch.from_numpy(uv)).numpy()
    pts = (rays * (rng.uniform(size=(P, 1)) * 6 + 6)).astype(np.float32)
    cam_t = -np.stack([np.linspace(-2.0, 2.0, K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    obs_cam = (rng.integers(0, K - D, size=P)[:, None] + np.arange(D)[None]).astype(np.int32)
    pc = torch.from_numpy(pts[:, None, :] + cam_t[obs_cam])  # R = I
    uv_obs = cameras.project(cam, pc)
    valid = cameras.in_image(cam, uv_obs, 2.0) & (pc[..., 2] > 0.5)
    return dict(cam_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), cam_t=cam_t,
                cam_fixed=np.arange(K) < 1, p=pts + np.float32(0.01), p_valid=np.ones(P, bool),
                obs_cam=obs_cam, obs_uv=uv_obs.numpy(), obs_ur=np.full((P, D), -1.0, np.float32),
                obs_level=np.zeros((P, D), np.int32), obs_valid=valid.numpy())


def dba_worker(rank: int, port: int, atlases, device="cuda") -> int:
    """One rank of phase 13 (d) and (e) (`--dba-worker RANK`): the world of
    DBA_RANKS ranks on this card through `parallel.distributed.initialize`
    (gloo: they share the card); (d) the sharded BA of `dryrun_problem`,
    timed per LM iteration, and the camera system's all_reduce alone; (e)
    for each atlas (phase 4's map, its perturbed copy) a SLAM with
    dba_devices=-1 loads it and runs `mapper.global_ba` with a spy on the
    sharded BA. Writes its results beside the first atlas."""
    import torch.distributed as dist

    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.parallel import dba, distributed
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    if not distributed.initialize(f"127.0.0.1:{port}", DBA_RANKS, rank, device=device):
        raise AssertionError("distributed.initialize did not form the world")
    info = distributed.process_info()
    mesh = distributed.global_mesh()
    cam = cameras.euroc_cam0()
    local = dba.shard_problem(convert.ba_problem_from_numpy(dryrun_problem(), device=device),
                              mesh)
    dba.bundle_adjust_sharded(cam, local, mesh, iters=1)  # warm-up
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    R, t, _, _, cost, _ = dba.bundle_adjust_sharded(cam, local, mesh, iters=DBA_ITERS)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3 / DBA_ITERS
    peak = torch.cuda.max_memory_allocated()
    flat = torch.zeros(36 * DBA_K * DBA_K + 12 * DBA_K + 1, device=device)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPS

    live = {}
    sharded = dba.bundle_adjust_sharded
    for key, path in zip(("final", "perturbed"), atlases):
        slam = SLAM(cam, SlamConfig(dba_devices=-1), device=device)
        slam.load_atlas(path, new_session=False)
        calls = []

        def spy(*args, **kwargs):
            calls.append(1)
            return sharded(*args, **kwargs)

        dba.bundle_adjust_sharded = spy
        try:
            live[f"{key}_ms"] = host_ms(lambda: slam.mapper.global_ba(iters=GBA_ITERS))
        finally:
            dba.bundle_adjust_sharded = sharded
        kfs = slam.map.kf_ids()
        live.update({f"{key}_calls": len(calls), f"{key}_kfs": kfs,
                     f"{key}_kf_R": slam.map.kf_R[kfs], f"{key}_kf_t": slam.map.kf_t[kfs],
                     f"{key}_mp_pos": slam.map.mp_pos[slam.map.mp_ids()]})
    np.savez(os.path.join(os.path.dirname(atlases[0]), f"dba_rank{rank}.npz"),
             R=R.cpu().numpy(), t=t.cpu().numpy(), cost=cost.item(), iter_ms=iter_ms,
             allreduce_ms=allreduce_ms, allreduce_bytes=flat.numel() * 4, peak_mib=peak / 2**20,
             backend=str(info["backend"]), world=info["process_count"], **live)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase13_distributed(atlas: dict, device) -> dict:
    """(d) and (e): DBA_RANKS ranks of this script (`--dba-worker`) on the
    one card over gloo. (d) fails unless the ranks' cameras are the same
    bits, the backend is gloo, and against a single-process
    `ba.bundle_adjust` of the same problem on the card the rotations agree
    within 5e-4, the translations within 5e-3 and the cost within 5 %
    (tests/test_parallel.py), with a finite cost below the start. (e) fails
    unless, on both atlases (phase 4's map, where the BA may find nothing
    to move, and its perturbed copy), every rank's `global_ba` went through
    the sharded BA, the ranks' keyframe poses and points are the same bits,
    and they are within 5e-3 of a single-process `global_ba` on the same
    atlas. Returns the times, bytes and peak memory of each rank and of the
    single process."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import ba
    from orb_slam3_comments_ghr_torch.system import SLAM

    root = os.path.dirname(atlas["path"])
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(DBA_RANKS):
            logs.append(open(os.path.join(root, f"dba_rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dba-worker", str(rank),
                 "--dba-port", str(port), "--atlas", atlas["path"], atlas["perturbed_path"]],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=WORKER_TIMEOUT_S)
            if rc != 0:
                with open(os.path.join(root, f"dba_rank{rank}.log")) as f:
                    raise AssertionError(f"phase13 (d) rank {rank} exited {rc}:\n"
                                         f"{f.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    workers_s = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(root, f"dba_rank{r}.npz"))) for r in range(DBA_RANKS)]

    cam = cameras.euroc_cam0()
    prob = convert.ba_problem_from_numpy(dryrun_problem(), device=device)
    chi2, delta2 = ba._obs_terms(cam, prob, prob.cam_R, prob.cam_t, prob.p, False)[4::2]
    cost_start = ba._cost(chi2, delta2, prob.obs_valid, False).item()
    ba.bundle_adjust(cam, prob, iters=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box = {}
    single_ms = host_ms(lambda: box.update(out=ba.bundle_adjust(cam, prob, iters=DBA_ITERS)))
    R1, t1, _, _, c1 = box["out"]
    single_peak = torch.cuda.max_memory_allocated()
    R1, t1, c1 = R1.cpu().numpy(), t1.cpu().numpy(), c1.item()
    r0 = ranks[0]
    dR, dt = float(np.abs(r0["R"] - R1).max()), float(np.abs(r0["t"] - t1).max())
    dcost = abs(float(r0["cost"]) - c1) / max(c1, 1.0)
    same = all(np.array_equal(r["R"], r0["R"]) and np.array_equal(r["t"], r0["t"])
               for r in ranks[1:])
    print(f"phase13 (d) sharded BA of the dryrun problem ({DBA_K} keyframes, {DBA_P} points, "
          f"{DBA_D} observations each), {DBA_RANKS} ranks on one card, backend "
          f"{', '.join(str(r['backend']) for r in ranks)}: ms per LM iteration per rank "
          + ", ".join(f"{float(r['iter_ms']):.3f}" for r in ranks)
          + f" (single process {single_ms / DBA_ITERS:.3f}); the camera system's all_reduce "
          f"{int(r0['allreduce_bytes'])} bytes, ms "
          + ", ".join(f"{float(r['allreduce_ms']):.3f}" for r in ranks)
          + "; max_memory_allocated MiB per rank "
          + ", ".join(f"{float(r['peak_mib']):.1f}" for r in ranks)
          + f" (single process {single_peak / 2**20:.1f}); cost {cost_start:.4f} -> "
          f"{float(r0['cost']):.4f} (single process {c1:.4f}); against the single process "
          f"|dR| {dR:.2e}, |dt| {dt:.2e}, cost {100 * dcost:.3f} %; cameras bit-equal across "
          f"ranks {same}; workers {workers_s:.1f} s")
    if any(str(r["backend"]) != "gloo" or int(r["world"]) != DBA_RANKS for r in ranks):
        raise AssertionError("phase13 (d): the ranks did not form a gloo world of "
                             f"{DBA_RANKS}")
    if not same or dR > 5e-4 or dt > 5e-3 or dcost >= 0.05:
        raise AssertionError("phase13 (d): the ranks' cameras differ, or the sharded BA is off "
                             "the single-process one (bars 5e-4, 5e-3, 5 %)")
    if not (np.isfinite(float(r0["cost"])) and float(r0["cost"]) < cost_start):
        raise AssertionError("phase13 (d): the cost is not finite or did not drop")

    live = {}
    for key in ("final", "perturbed"):
        single = SLAM(cam, device=device)
        single.load_atlas(atlas["path" if key == "final" else "perturbed_path"],
                          new_session=False)
        kfs = single.map.kf_ids()
        t_before = single.map.kf_t[kfs].copy()
        single.mapper.global_ba(iters=GBA_ITERS)
        R_k, t_k = single.map.kf_R[kfs], single.map.kf_t[kfs]
        gR = float(np.abs(R_k - r0[f"{key}_kf_R"]).max())
        gt = float(np.abs(t_k - r0[f"{key}_kf_t"]).max())
        moved = float(np.abs(t_k - t_before).max())
        same_live = all(np.array_equal(r[f"{key}_{k}"], r0[f"{key}_{k}"]) for r in ranks[1:]
                        for k in ("kfs", "kf_R", "kf_t", "mp_pos"))
        calls = [int(r[f"{key}_calls"]) for r in ranks]
        print(f"phase13 (e) global_ba(iters={GBA_ITERS}) with dba_devices=-1 on the atlas of phase "
              f"4's {key} map: sharded BA calls per rank {calls}, host ms per rank "
              + ", ".join(f"{float(r[f'{key}_ms']):.1f}" for r in ranks)
              + f"; keyframes moved up to {moved:.2e} m; keyframe poses and points bit-equal "
              f"across ranks {same_live}; against the single-process global_ba |dR| {gR:.2e}, "
              f"|dt| {gt:.2e}")
        if min(calls) < 1 or not same_live:
            raise AssertionError(f"phase13 (e) {key}: a rank's global_ba did not shard, or the "
                                 "ranks' maps differ")
        if not np.array_equal(kfs, r0[f"{key}_kfs"]) or gR > 5e-3 or gt > 5e-3:
            raise AssertionError(f"phase13 (e) {key}: the sharded global_ba is more than 5e-3 "
                                 "off the single-process one")
        live[key] = dict(calls=calls, host_ms=[float(r[f"{key}_ms"]) for r in ranks],
                         moved_m=moved, max_dR=gR, max_dt=gt, keyframes=len(kfs))
    return dict(
        dba=dict(ranks=DBA_RANKS, backend=str(r0["backend"]),
                 iter_ms=[float(r["iter_ms"]) for r in ranks], single_iter_ms=single_ms / DBA_ITERS,
                 allreduce_ms=[float(r["allreduce_ms"]) for r in ranks],
                 allreduce_bytes=int(r0["allreduce_bytes"]),
                 peak_mib=[float(r["peak_mib"]) for r in ranks],
                 single_peak_mib=single_peak / 2**20, cost_start=cost_start,
                 cost=float(r0["cost"]), single_cost=c1, max_dR=dR, max_dt=dt,
                 workers_s=workers_s),
        live=live)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the PyTorch port on a CUDA card.")
    ap.add_argument("--save-caller-inputs", metavar="FILE",
                    help="also write the window-match arguments recorded in phase 4 to FILE "
                         "(torch.save, CPU tensors) for utils/time_window_match.py")
    ap.add_argument("--dba-worker", type=int, metavar="RANK",
                    help="run one rank of phase 13 (d) and (e) (started by phase 13)")
    ap.add_argument("--dba-port", type=int, help="rank 0's TCP port (with --dba-worker)")
    ap.add_argument("--atlas", nargs=2, help="phase 13 (c)'s atlas files, phase 4's map and "
                    "its perturbed copy (with --dba-worker)")
    ap.add_argument("--phase-group", choices=tuple(CHILD_GROUPS),
                    help="run one group of phases 7-14 (started by the main run)")
    ap.add_argument("--work", help="the main run's working directory (with --phase-group)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    try:
        from orb_slam3_comments_ghr_torch.ops import matching, window_match
    except ModuleNotFoundError as e:
        raise SystemExit(f"chip_smoke.py runs from the root of a checkout of the repo: {e}")
    if opts.dba_worker is not None:
        return dba_worker(opts.dba_worker, opts.dba_port, opts.atlas)
    if opts.phase_group is not None:
        return run_group(opts.phase_group, opts.work)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=scratch_dir()) as work:
        return run_phases(opts, matching, window_match, work)


# phases 7-12 and 14 run in processes of their own, one per group, beside the main
# process's phases 5, 6 and 13 (a)-(c): every phase is bound by its host's
# Python and launches (the card is idle most of the time), so on the
# machine's cores the groups take about the time of the longest, not the sum
CHILD_GROUPS = {"7-9": phase_group_inertial, "10": phase_group_loop,
                "11": phase_group_inertial_loop, "12": phase_group_fisheye,
                "14": phase_group_async, "15": phase_group_gt_tools}
GROUP_TIMEOUT_S = 1100


def start_groups(work: str) -> dict:
    """Start one process of this script per CHILD_GROUPS entry
    (`--phase-group NAME --work DIR`), its output to DIR/group_NAME.log."""
    children = {}
    for name in CHILD_GROUPS:
        log = open(os.path.join(work, f"group_{name}.log"), "w")
        children[name] = (subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--phase-group", name, "--work",
             work],
            stdout=log, stderr=subprocess.STDOUT), log, time.perf_counter())
    return children


def join_groups(children: dict, work: str) -> dict:
    """Wait for the group processes, print each one's output, and return
    what each saved ({name: {"paths", "recorded", "results"}}); fails, with
    every process stopped, when one did not exit 0."""
    out = {}
    try:
        for name, (proc, log, t0) in children.items():
            rc = proc.wait(timeout=max(1.0, GROUP_TIMEOUT_S - (time.perf_counter() - t0)))
            log.close()
            with open(os.path.join(work, f"group_{name}.log")) as f:
                print(f"--- phases {name}, a process of their own ({time.perf_counter() - t0:.1f} "
                      "s from its start):")
                print(f.read().rstrip())
            if rc != 0:
                raise AssertionError(f"phases {name} exited {rc}")
            out[name] = torch.load(os.path.join(work, f"group_{name}.pt"), weights_only=False)
    finally:
        stop_groups(children)
    return out


def stop_groups(children: dict) -> None:
    """Stop the group processes still running and close their logs."""
    for proc, log, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def run_group(name: str, work: str) -> int:
    """One CHILD_GROUPS entry in this process (`--phase-group NAME`): its
    phases with their counts, checks and prints as the main process runs
    the others; saves (paths, recorded window-match arguments on the CPU,
    results) to WORK/group_NAME.pt."""
    from orb_slam3_comments_ghr_torch.ops import window_match

    window_match.build()  # built by the main process already: a cache hit
    paths, recorded, results = CHILD_GROUPS[name](window_match, torch.device("cuda", 0), work)
    torch.save({"paths": paths, "recorded": {k: tuple(a.cpu() for a in v)
                                             for k, v in recorded.items()},
                "results": results}, os.path.join(work, f"group_{name}.pt"))
    return 0


def run_phases(opts, matching, window_match, work: str) -> int:
    """Phases 1-13 in order; `work` holds phase 13's files."""
    card = card_line()
    print(card)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = window_match.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")

    max_err, synthetic_times = phase1_kernel(window_match, matching, device)
    print("phase1 passed")
    t0 = time.perf_counter()
    seq = render_sequence(PHASE4_FRAMES)
    print(f"rendered {PHASE4_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    _, frame, pts = phase2_slice(device, window_match, seq)
    print("phase2 passed")
    phase3_against_cpu(device, frame, pts, seq[2][0])
    print("phase3 passed")
    t0 = time.perf_counter()
    launches, calls, slam, recorded = phase4_slam(window_match, seq)
    paths = {"mono": dict(calls, launches=launches)}
    lb_launches, lb_calls = phase4_lost_and_back(window_match, slam, seq)
    paths["mono lost-and-back"] = dict(lb_calls, launches=lb_launches)
    print(f"phase4 passed in {time.perf_counter() - t0:.1f} s")
    from orb_slam3_comments_ghr_torch import convert

    # phase 10's whole-map BA runs on phase 4's map, in a process of its own
    torch.save(convert.map_state_to_numpy(slam.map), os.path.join(work, "phase4_map.pt"))
    atlas = phase13_save_atlas(slam, work, device)  # phase 13 (c) goes on from it
    del slam
    children = start_groups(work)
    try:  # phases 5, 6 and 13 (a)-(c) beside the group processes
        t0 = time.perf_counter()
        right, depth = second_inputs(seq, "stereo"), second_inputs(seq, "rgbd")
        print(f"rendered {PHASE5_FRAMES} right views and depth maps in "
              f"{time.perf_counter() - t0:.1f} s")
        stages, depth_frame_ms = {}, {}
        for mode, second in (("stereo", right), ("rgbd", depth)):
            t0 = time.perf_counter()
            n, calls, rec, slam, depth_frame_ms[mode] = phase_depth_slam(window_match, seq,
                                                                         second, mode)
            paths[mode] = dict(calls, launches=n)
            recorded.update(rec)
            if mode == "stereo":
                stages.update(depth_stages_against_cpu(device, seq, right, depth, slam))
            else:
                stages.update(rectify_clahe_against_cpu(device, seq, right))
            print(f"phase{5 if mode == 'stereo' else 6} passed in {time.perf_counter() - t0:.1f} s")
        del slam

        t0 = time.perf_counter()
        entry = {}
        for key, second in (("cli mono", None), ("cli stereo", right)):
            n, calls, rec, entry[key] = phase13_cli(window_match, seq, second)
            paths[key] = dict(calls, launches=n)
            recorded.update(rec)
        n, calls, rec, entry["atlas"] = phase13_second_session(window_match, seq, atlas, device)
        paths["atlas second session"] = dict(calls, launches=n)
        recorded.update(rec)
        entry["atlas"]["file"] = {k: v for k, v in atlas.items() if not k.endswith("path")}
        print(f"phase13 (a)-(c) passed in {time.perf_counter() - t0:.1f} s")
        results = join_groups(children, work)
        for name in CHILD_GROUPS:
            paths.update(results[name]["paths"])
            recorded.update(results[name]["recorded"])
        inertial_results = results["7-9"]["results"]
        vi_stereo = inertial_results["stereo-inertial"]
        v = depth_frame_ms["stereo"]
        print(f"phase7 per-frame ms without a keyframe (median / p75), this call: track_stereo "
              f"(phase 5) {np.median(v):.3f} / {np.percentile(v, 75):.3f}; stereo-inertial "
              f"before the "
              f"IMU init {vi_stereo['frames']['before_imu_init']['median_ms']:.3f} / "
              f"{vi_stereo['frames']['before_imu_init']['p75_ms']:.3f}, IMU-ready "
              f"{vi_stereo['frames']['imu_ready']['median_ms']:.3f} / "
              f"{vi_stereo['frames']['imu_ready']['p75_ms']:.3f} (phases 5 and 7 ran beside other "
              "phases' processes)")
        modes = {**inertial_results, **results["14"]["results"]}
        print(f"phase14 (c) stereo-inertial, {PHASE7_FRAMES} frames, metric ATE (mm) by mode: "
              f"synchronous inline (phase 7) {vi_stereo['ate_m'] * 1e3:.3f}, synchronous "
              f"worker {modes['stereo-inertial worker 150']['ate_m'] * 1e3:.3f}, pipelined "
              f"inline {modes['stereo-inertial pipelined inline 150']['ate_m'] * 1e3:.3f}, "
              f"pipelined worker {modes['stereo-inertial pipelined 150']['ate_m'] * 1e3:.3f}")
        t0 = time.perf_counter()
        entry.update(phase13_distributed(atlas, device))
        print(f"phase13 (d), (e) passed in {time.perf_counter() - t0:.1f} s")
        if opts.save_caller_inputs:
            torch.save({k: tuple(a.cpu() for a in v) for k, v in recorded.items()},
                       opts.save_caller_inputs)
        err, callers = phase1_callers(window_match, matching, recorded, device,
                                      [*RECORD_AT, *(f"{m} {c}" for m in ("stereo", "rgbd")
                                                     for c in RECORD_AT_DEPTH),
                                       *(f"stereo-inertial {c}" for c in RECORD_AT_VI),
                                       *RECORD_AT_LOOP,
                                       *(f"inertial {c}" for c in RECORD_AT_INERTIAL_LOOP),
                                       *(f"fisheye {c}" for c in RECORD_AT_FISHEYE),
                                       *(f"cli {c}" for c in RECORD_AT_CLI),
                                       *(f"cli stereo {c}" for c in RECORD_AT_CLI_STEREO),
                                       *(f"atlas {c}" for c in RECORD_AT_SESSION2
                                         if f"atlas {c}" in recorded),
                                       *(f"async {c}" for c in RECORD_AT_ASYNC),
                                       *(f"gt replay {c}" for c in RECORD_AT_GT)])
        max_err = max(max_err, err)
        print("phase1 on the recorded caller inputs passed")

        track = callers["tracking"]
        print(card)
        print(json.dumps({"kernels": [{
            "name": "window_match", "route": "cuda",
            "source": "orb_slam3_comments_ghr_torch/csrc/window_match.cu",
            "replaces": "orb_slam3_comments_ghr_tpu/ops/pallas_match.py:88",
            # launches over the main runs of phases 4-14, each counted from 0
            "launches": sum(paths[p]["launches"] for p in (
                "mono", "stereo", "rgbd", "stereo-inertial", "rgbd-inertial", "mono-inertial",
                "feature loop", "kidnap and merge", "image loop", "stereo-inertial loop",
                "inertial kidnap and merge", "mono fisheye", "stereo fisheye",
                "stereo-inertial fisheye", "cli mono", "cli stereo", "atlas second session",
                "async mono", "bench mono pipelined", "stereo-inertial pipelined 60",
                "stereo-inertial pipelined 150", "stereo-inertial pipelined inline 150",
                "stereo-inertial worker 150", "feature loop async", "gt replay mono",
                "gt replay stereo-inertial", "feature loop 100k")),
            "max_abs_err": max_err,
            # device time per launch on the recorded mono tracking call (CUDA graph)
            "ms": track["device_ms"], "plain_ms": track["plain_ms"],
            "bound_ms": track["bound_ms"], "bound_by": track["bound_by"], "library_ms": None,
            "paths": paths, "callers": callers, "random_4096x1024_r80": synthetic_times,
        }], "plain_stages": stages, "inertial": inertial_results,
            "loop_closing": {**results["10"]["results"], **results["11"]["results"]},
            "fisheye": results["12"]["results"], "entry_points": entry,
            "async": results["14"]["results"], "tools": results["15"]["results"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        stop_groups(children)


if __name__ == "__main__":
    sys.exit(main())
