"""Run the PyTorch port's per-frame tracking program once on a CUDA card.

    python3 chip_smoke.py

Builds the window-match kernel from `orb_slam3_comments_ghr_torch/csrc`,
holds it against its plain PyTorch version at the tracking path's shapes
(phase 1), then renders 752x480 EuRoC-cam0 frames of a synthetic two-plane
scene, builds a 4096-point local map from four keyframes and tracks 40
frames through `programs.extract_and_track` at 1024 features / 8 levels
(phase 2). Any failure raises. The last lines are the card's name and power
limit, a JSON line of per-kernel results, and the JSON status line.
Needs one CUDA card; exits non-zero without one.
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


def match_problem(seed: int, n: int, m: int, radius: float, device):
    """Random descriptors, predicted pixels, radii and octave bands, as the
    JAX package's kernel test builds them."""
    rng = np.random.default_rng(seed)
    qd = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    td = rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32)
    quv = rng.random((n, 2), np.float32) * np.float32(600)
    txy = rng.random((m, 2), np.float32) * np.float32(600)
    qlo = rng.integers(0, 3, n).astype(np.float32)
    tlvl = rng.integers(0, 8, m).astype(np.float32)
    tval = (rng.random(m) > 0.1).astype(np.float32)
    arrays = (qd, quv, np.full(n, radius, np.float32), qlo, qlo + 2, td, txy, tlvl, tval)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def phase1_kernel(window_match_mod, matching_mod, device):
    """Kernel against plain on the card; returns (max_abs_err, ms, plain_ms)."""
    wm = window_match_mod.window_match
    cases = [(0, 4096, 1024, 80.0), (1, 4096, 1024, 15.0), (2, 4096, 1024, 300.0),
             (3, 1000, 777, 80.0), (4, 1000, 777, 0.0)]
    max_err = 0
    for seed, n, m, radius in cases:
        args = match_problem(seed, n, m, radius, device)
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
        print(f"phase1 case seed={seed} N={n} M={m} r={radius}: ok "
              f"(rows with a match {int((best < matching_mod.BIG).sum())}, idx ties {int(differ.sum())})")
    args = match_problem(0, 4096, 1024, 80.0, device)
    ms = cuda_ms(lambda: wm(*args))
    plain_ms = cuda_ms(lambda: window_match_mod.window_match_plain(*args))
    print(f"phase1 window_match 4096x1024 r=80: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def host_ms(fn) -> float:
    """Milliseconds of fn() on the host clock, ending in a device sync."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def camera_centre(R, t) -> np.ndarray:
    return -(np.asarray(R, np.float64).T @ np.asarray(t, np.float64))


def phase2_slice(device, wm):
    """Track frames 1..40 against a 4096-point map from keyframes 0/10/20/30.
    Checks accuracy and the kernel's launch count, prints per-frame times and
    returns (launches, frame 1, the map, the poses)."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.pipeline import programs
    from orb_slam3_comments_ghr_torch.utils import synthetic

    cam = cameras.euroc_cam0()
    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(300)
    # uint8 frames, as a camera delivers them
    frames = [
        torch.from_numpy(np.clip(np.round(synthetic.render_image(scene, cam, *poses[i])),
                                 0, 255).astype(np.uint8)).to(device)
        for i in range(41)
    ]
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
    for i in range(1, 41):
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
    print(f"phase2 40 frames: centre error median {np.median(errs) * 1e3:.3f} mm, "
          f"max {errs.max() * 1e3:.3f} mm; inliers min {inliers.min()}, "
          f"median {np.median(inliers):.0f}; window_match launches {launches}")
    if errs.max() >= 0.02:
        raise AssertionError(f"camera-centre error {errs.max():.4f} m >= 2 cm")
    if inliers.min() < 300:
        raise AssertionError(f"a frame has {inliers.min()} < 300 inliers")
    if launches != 40:
        raise AssertionError(f"window_match launched {launches} times for 40 frames")

    # per-frame times after warm-up (the 40 frames above), host clock with a
    # device sync around each call; each frame starts from the previous pose
    starts = [tuple(torch.from_numpy(a).to(device) for a in poses[i - 1]) for i in range(41)]
    ext, trk, fused = [], [], []
    for i in range(1, 41):
        box = {}
        ext.append(host_ms(lambda: box.update(f=programs.extract_only(cam, frames[i]))))
        trk.append(host_ms(lambda: programs.track_only(cam, box["f"], pts, *starts[i])))
        fused.append(host_ms(lambda: programs.extract_and_track(cam, cam, frames[i], pts, *starts[i])))
    # p75 is the highest percentile with ten of the 40 samples beyond it
    print("phase2 per-frame ms over 40 frames (median / p75): " + ", ".join(
        f"{k} {np.median(v):.3f} / {np.percentile(v, 75):.3f}"
        for k, v in (("extract_only", ext), ("track_only", trk), ("extract_and_track", fused))))
    return launches, frames[1], pts, poses


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

    max_err, ms, plain_ms = phase1_kernel(window_match, matching, device)
    print("phase1 passed")
    launches, frame, pts, poses = phase2_slice(device, window_match.window_match)
    print("phase2 passed")
    phase3_against_cpu(device, frame, pts, poses[0])
    print("phase3 passed")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "window_match", "route": "cuda",
        "source": "orb_slam3_comments_ghr_torch/csrc/window_match.cu",
        "replaces": "orb_slam3_comments_ghr_tpu/ops/pallas_match.py:88",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
