"""Run the PyTorch port on a CUDA card: the window-match kernel against
its plain version, the per-frame tracking program, and monocular SLAM end
to end.

    python3 chip_smoke.py

Builds the window-match kernel from `orb_slam3_comments_ghr_torch/csrc`
and holds it against its plain PyTorch version at the shapes of its three
callers: tracking, two-view initialization and the mapper's fuse (phase 1).
Renders 752x480 EuRoC-cam0 frames of a synthetic two-plane scene, builds a
4096-point local map from four keyframes and tracks frames 1-24 through
`programs.extract_and_track` at 1024 features / 8 levels (phase 2), then
holds one frame against the port on the CPU (phase 3). Phase 4 drives
`SLAM.track_monocular` at the default (full) width over 120 frames:
two-view initialization, tracking, keyframes, local mapping with local BA,
and the trajectory, checked against ground truth; then blank frames lose
tracking, relocalization has to bring it back, and a frame rolled about
the optical axis has to go through the reference-keyframe fallback. Any
failure raises. The
last lines are the card's name and power limit, a JSON line of per-kernel
results, and the JSON status line. Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median milliseconds of fn() on the card, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    read once and each output written once (bytes); a window test of ~8
    operations for every (query, target) pair, plus 8 XOR, 8 POPC and 8
    adds for every pair inside a window (operations, counted on this data)."""
    n, m = args[0].shape[0], args[5].shape[0]
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * 4 * n
    mask = matching_mod.window_mask(args[1], args[6], args[7], args[8] > 0, args[2],
                                    args[3], args[4])
    ops = 8 * n * m + 24 * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase1_kernel(window_match_mod, matching_mod, device):
    """Kernel against plain on the card; returns (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)."""
    wm = window_match_mod.window_match
    cases = [(0, 4096, 1024, 80.0, "track"), (1, 4096, 1024, 15.0, "track"),
             (2, 4096, 1024, 300.0, "track"), (3, 1000, 777, 80.0, "track"),
             (4, 1000, 777, 0.0, "track"), (5, 1024, 1024, 100.0, "init"),
             (6, 4096, 1024, None, "fuse")]
    max_err = 0
    for seed, n, m, radius, caller in cases:
        args = match_problem(seed, n, m, radius, device, caller)
        idx, best, second = wm(*args)
        idx_p, best_p, second_p = window_match_mod.window_match_plain(*args)
        torch.cuda.synchronize()
        err = max(int((best - best_p).abs().max()), int((second - second_p).abs().max()))
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"case {seed}: best/second differ from plain by {err}")
        # idx equal, or where it differs, at a column whose distance is `best`
        dist = matching_mod.hamming_matrix(args[0], args[5])
        took = dist.gather(1, idx.long()[:, None])[:, 0]
        differ = (idx != idx_p) & (best < matching_mod.BIG)
        if bool((differ & (took != best)).any()) or bool(((idx != idx_p) & (best >= matching_mod.BIG)).any()):
            raise AssertionError(f"case {seed}: argmin differs beyond ties")
        if radius == 0.0 and not bool((best == matching_mod.BIG).all()):
            raise AssertionError("radius-0 rows must be empty")
        print(f"phase1 case {caller} seed={seed} N={n} M={m} r={radius}: ok "
              f"(rows with a match {int((best < matching_mod.BIG).sum())}, idx ties {int(differ.sum())})")
    args = match_problem(0, 4096, 1024, 80.0, device)
    ms = cuda_ms(lambda: wm(*args))
    plain_ms = cuda_ms(lambda: window_match_mod.window_match_plain(*args))
    bound_ms, bound_by = window_match_bound(args, matching_mod)
    print(f"phase1 window_match 4096x1024 r=80: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    return max_err, ms, plain_ms, bound_ms, bound_by


def host_ms(fn) -> float:
    """Milliseconds of fn() on the host clock, ending in a device sync."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


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
    frames = [np.clip(np.round(synthetic.render_image(scene, cam, *poses[i])), 0, 255)
              .astype(np.uint8) for i in range(n)]
    return frames, scene, poses


def phase2_slice(device, wm, seq):
    """Track frames 1..24 against a 4096-point map from keyframes 0/10/20/30.
    Checks accuracy and the kernel's launch count, prints per-frame times and
    returns (launches, frame 1, the map)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
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
    wm.launches = 0
    for i in range(1, PHASE2_FRAMES + 1):
        _, res = programs.extract_and_track(cam, cam, frames[i], pts, R, t)
        R, t = res.R, res.t
        Rn, tn = R.cpu().numpy(), t.cpu().numpy()
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            raise AssertionError(f"frame {i}: non-finite pose")
        errs.append(float(np.linalg.norm(camera_centre(Rn, tn) - camera_centre(*poses[i]))))
        inliers.append(int(res.n_inliers))
    torch.cuda.synchronize()
    launches = wm.launches
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
        trk.append(host_ms(lambda: programs.track_only(cam, box["f"], pts, *starts[i])))
        fused.append(host_ms(lambda: programs.extract_and_track(cam, cam, frames[i], pts, *starts[i])))
    print(f"phase2 per-frame ms over {PHASE2_FRAMES} frames (median / p75): " + ", ".join(
        f"{k} {np.median(v):.3f} / {np.percentile(v, 75):.3f}"
        for k, v in (("extract_only", ext), ("track_only", trk), ("extract_and_track", fused))))
    return launches, frames[1], pts


def phase3_against_cpu(device, frame, pts, pose):
    """The same frame through the port on the CPU (plain window match) and
    on the card: keypoints, descriptors and the tracked pose must agree."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.pipeline import programs

    cam = cameras.euroc_cam0()
    cpu = torch.device("cpu")
    R0, t0 = (torch.from_numpy(a) for a in pose)
    f_g, r_g = programs.extract_and_track(cam, cam, frame, pts, R0.to(device), t0.to(device))
    f_c, r_c = programs.extract_and_track(
        cam, cam, frame.to(cpu), type(pts)(*(x.to(cpu) for x in pts)), R0, t0)
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


def _count_calls(module, name: str, counts: dict, key: str):
    """Replace module.name by a wrapper that counts its calls under `key`;
    returns the original, to put back."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    return fn


def phase4_slam(wm, seq):
    """`SLAM.track_monocular` over frames 0..119 (20 Hz timestamps) at the
    default, full-width configuration, loop closing off. Fails unless the
    run initializes, tracks >= 90 % of the frames after init, ends with >= 3
    keyframes and > 200 map points and a Sim(3)-aligned ATE < 5 cm, and the
    window match launched once per matcher call on its three paths. Returns
    the launch count."""
    from orb_slam3_comments_ghr_torch.ops import cameras, matching
    from orb_slam3_comments_ghr_torch.pipeline import programs
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    frames, _, poses = seq
    slam = SLAM(cameras.euroc_cam0(), SlamConfig(enable_loop_closing=False), device="cuda")
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    originals = [
        (programs, "track_against_points",
         _count_calls(programs, "track_against_points", calls, "tracking")),
        (matching, "search_for_initialization",
         _count_calls(matching, "search_for_initialization", calls, "init")),
        (programs, "fuse_project", _count_calls(programs, "fuse_project", calls, "fuse")),
    ]
    kf_ms = []
    process_keyframe = slam.mapper.process_keyframe

    def timed_process_keyframe(kf):
        kf_ms.append(host_ms(lambda: process_keyframe(kf)))

    slam.mapper.process_keyframe = timed_process_keyframe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm.launches = 0
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
        launches = wm.launches
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
    return launches, slam


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


def phase4_lost_and_back(wm, slam, seq):
    """Continue phase 4's run: blank frames lose tracking, then the camera
    comes back at RETURN_POSES. Fails unless tracking is lost on the first
    blank frame, relocalization brings the state back to OK on the first
    returned frame, the reference-keyframe fallback tracks the rolled frame,
    >= 90 % of the returned frames are tracked, the Sim(3)-aligned ATE of the
    whole trajectory stays under 5 cm, and the window match launched once
    per matcher call in this window. Returns the launch count."""
    from orb_slam3_comments_ghr_torch.ops import cameras, matching
    from orb_slam3_comments_ghr_torch.pipeline import programs
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
    calls = {"tracking": 0, "init": 0, "fuse": 0}
    originals = [
        (programs, "track_against_points",
         _count_calls(programs, "track_against_points", calls, "tracking")),
        (matching, "search_for_initialization",
         _count_calls(matching, "search_for_initialization", calls, "init")),
        (programs, "fuse_project", _count_calls(programs, "fuse_project", calls, "fuse")),
    ]
    outcomes = {}
    for name in ("_relocalize", "_track_reference_kf"):
        _count_outcomes(slam.tracker, name, outcomes)
    torch.cuda.synchronize()
    wm.launches = 0
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
        launches = wm.launches
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    from orb_slam3_comments_ghr_torch.ops import matching, window_match

    card = card_line()
    print(card)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = window_match.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")

    max_err, ms, plain_ms, bound_ms, bound_by = phase1_kernel(window_match, matching, device)
    print("phase1 passed")
    t0 = time.perf_counter()
    seq = render_sequence(PHASE4_FRAMES)
    print(f"rendered {PHASE4_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    _, frame, pts = phase2_slice(device, window_match.window_match, seq)
    print("phase2 passed")
    phase3_against_cpu(device, frame, pts, seq[2][0])
    print("phase3 passed")
    t0 = time.perf_counter()
    launches, slam = phase4_slam(window_match.window_match, seq)
    phase4_lost_and_back(window_match.window_match, slam, seq)
    print(f"phase4 passed in {time.perf_counter() - t0:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "window_match", "route": "cuda",
        "source": "orb_slam3_comments_ghr_torch/csrc/window_match.cu",
        "replaces": "orb_slam3_comments_ghr_tpu/ops/pallas_match.py:88",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
