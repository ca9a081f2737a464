"""Where the time of monocular, stereo, RGB-D or stereo-inertial SLAM goes
on a CUDA card.

    python -m orb_slam3_comments_ghr_torch.utils.profile_slam \
        [--sensor mono|stereo|rgbd|imu_stereo] [--frames N] [--warmup 10]

Drives `SLAM.track_monocular` (or `track_stereo` on rectified pairs, or
`track_rgbd` with the exact depth map) over the `chip_smoke.py` sequence of
phases 4-6 (`make_textured_scene(7)`, `circular_trajectory(300)`, 20 Hz,
default full-width config, loop closing off; 120 frames by default); or,
`imu_stereo`, `track_stereo` with the IMU rows over phase 7's sequence
(`vi_sequence(150)` rendered from the same scene, its stereo-inertial
config; 150 frames). Every frame after the first `--warmup` runs under
`torch.profiler`. For the per-frame call, its stages (`extract_batched`,
once per image; `stereo_match` or `depth_to_stereo`;
`track_against_points`; with the IMU `preintegrate` and
`preintegrate_continue`, and the tracker's `_vi_refine`), the tracker's
host bookkeeping (`Tracker.track`: result fetch, map statistics, keyframe
insertion; for RGB-D it also runs the tracking) and the stages of
`LocalMapper.process_keyframe` (with the IMU also `maybe_initialize_imu`
and `vi_bundle_adjust`, the inertial local BA) it prints the calls, the
host milliseconds (each call ending in a device sync; inflated by the
profiler's host cost), the device milliseconds of the kernels and copies
each launched, and the kernel launches and copies it issued (a stage's
device time and launches include the stages inside it). Then, for the
whole profiled run:
device busy time (one stream, so kernels do not overlap), kernel and copy
count, the device idle share (1 - busy / wall, the wall inflated by the
profiler), the window-match kernel's launches and device time, and the
kernels with the most device time.

It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

MAPPER_STAGES = ("cull_map_points", "create_new_points", "fuse_neighbors", "local_ba", "cull_keyframes")
# the host-side CUDA runtime calls that issue one kernel or copy each
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def _timed(obj, name: str, times: dict, key: str):
    """Wrap obj.name in a profiler range named `key`, and append each
    call's host ms (ending in a sync) to times[key]."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(key):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapper)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensor", choices=("mono", "stereo", "rgbd", "imu_stereo"), default="mono")
    ap.add_argument("--frames", type=int, default=None, help="120, or 150 for imu_stereo")
    ap.add_argument("--warmup", type=int, default=10, help="frames run before profiling")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slam needs a CUDA card")
    from ..frontend import stereo
    from ..ops import cameras
    from ..optim import imu as imu_mod, vi_ba
    from ..pipeline import programs
    from ..system import SLAM
    from . import config, synthetic

    cam = cameras.euroc_cam0()
    scene = synthetic.make_textured_scene(7)
    inertial = args.sensor == "imu_stereo"
    n = args.frames or (150 if inertial else 120)
    if inertial:
        # chip_smoke.py phase 7: bench.py's stereo-inertial pass, synchronous
        poses, imu_rows, stamps = synthetic.vi_sequence(150)
        poses, stamps = poses[:n], stamps[:n]
        cfg = config.SlamConfig(sensor=config.IMU_STEREO, n_features=1024, local_points_cap=4096,
                                local_ba_points=2048, max_frames_between_kf=10,
                                min_init_matches=60, enable_loop_closing=False)
        calib = imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                                 noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
        rows = [imu_rows[(imu_rows[:, 0] > (stamps[i - 1] if i else -1.0))
                         & (imu_rows[:, 0] <= stamps[i])] for i in range(n)]
    else:
        poses = synthetic.circular_trajectory(300)[:n]
        stamps = [i * 0.05 for i in range(n)]
        sensor = dict(mono=config.MONOCULAR, stereo=config.STEREO, rgbd=config.RGBD)[args.sensor]
        cfg, calib = config.SlamConfig(sensor=sensor, enable_loop_closing=False), None
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    frames = [u8(synthetic.render_image(scene, cam, *p)) for p in poses]
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    if args.sensor in ("stereo", "imu_stereo"):
        second = [u8(synthetic.render_image(scene, cam, R, t - b)) for R, t in poses]
    elif args.sensor == "rgbd":
        second = [synthetic.depth_map(scene, cam, *p) for p in poses]
    slam = SLAM(cam, cfg, imu_calib=calib, device="cuda")
    method = {"mono": "track_monocular", "rgbd": "track_rgbd"}.get(args.sensor, "track_stereo")
    times = collections.defaultdict(list)
    _timed(slam, method, times, f"SLAM.{method}")
    track = getattr(slam, method)
    if args.sensor == "mono":
        step = lambda i: track(frames[i], stamps[i])
    elif inertial:
        step = lambda i: track(frames[i], second[i], stamps[i], imu_samples=rows[i])
    else:
        step = lambda i: track(frames[i], second[i], stamps[i])
    _timed(programs, "extract_batched", times, "extract_batched")
    _timed(stereo, "stereo_match", times, "stereo_match")
    _timed(stereo, "depth_to_stereo", times, "depth_to_stereo")
    _timed(programs, "track_against_points", times, "track_against_points")
    _timed(slam.tracker, "track", times, "tracker.track (host bookkeeping)")
    for stage in MAPPER_STAGES:
        _timed(slam.mapper, stage, times, f"mapper.{stage}")
    if inertial:
        _timed(imu_mod, "preintegrate", times, "preintegrate")
        _timed(imu_mod, "preintegrate_continue", times, "preintegrate_continue")
        _timed(slam.tracker, "_vi_refine", times, "tracker._vi_refine")
        _timed(slam.mapper, "maybe_initialize_imu", times, "mapper.maybe_initialize_imu")
        _timed(vi_ba, "vi_bundle_adjust", times, "vi_bundle_adjust")

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    for v in times.values():
        v.clear()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(args.warmup, n):
            step(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    events = prof.events()
    device_ms = collections.Counter()
    spans = collections.defaultdict(list)
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        if e.name in times and e.device_type == cpu:
            device_ms[e.name] += e.device_time_total / 1e3
            spans[e.name].append((e.time_range.start, e.time_range.end))
    launch_at = np.sort([e.time_range.start for e in events
                         if e.device_type == cpu and e.name in LAUNCH_CALLS])
    print(torch.cuda.get_device_name(0))
    print(f"{args.sensor}: frames {args.warmup}-{n - 1} profiled; keyframes {slam.n_keyframes()}, "
          f"map points {slam.n_map_points()}")
    for key, v in times.items():
        if not v:
            print(f"{key}: calls 0")
            continue
        launches = sum(int(np.searchsorted(launch_at, b1) - np.searchsorted(launch_at, a))
                       for a, b1 in spans[key])
        print(f"{key}: calls {len(v)}, host median {np.median(v):.3f} ms, p75 "
              f"{np.percentile(v, 75):.3f} ms, total {np.sum(v):.1f} ms; device total "
              f"{device_ms[key]:.3f} ms; launches {launches} ({launches / len(v):.0f} per call)")
    # kernels and copies on the card (one stream: they do not overlap); the
    # ranges above also leave a device-side annotation span, left out here
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in times]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profiled run: wall {wall_ms:.1f} ms, device busy {busy_ms:.3f} ms, kernels and "
          f"copies {len(kernels)}, device idle share {1 - busy_ms / wall_ms:.3f}")
    wm = [e.time_range.elapsed_us() for e in kernels if "window_match" in e.name]
    print(f"window_match kernel: launches {len(wm)}, device total {sum(wm) / 1e3:.3f} ms, "
          f"median {np.median(wm) if wm else 0.0:.2f} us per launch")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    for name, us in by_name.most_common(8):
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
