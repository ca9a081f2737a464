"""Replay a EuRoC ground-truth trajectory through the port and score ATE
against the same file: the port of `scripts/run_gt_replay.py` (the
reference's dataset-run validation, re-created without image data; see
`utils/gt_replay.py`).

    python -m orb_slam3_comments_ghr_torch.scripts.run_gt_replay --seq MH01 \\
        --sensor mono|imu-mono|stereo|imu-stereo|rgbd|imu-rgbd \\
        [--render features|images] [--stride 1] [--start-frame 0] \\
        [--max-frames 0] [--async-mapping] [--no-loop] [--out traj.tum] \\
        [--device cpu]

The ground truth is `{seq}_GT.txt` in the folder that `EUROC_GT_DIR` names
(`utils/gt_replay.GT_DIR`); `gt_replay.euroc_gt_from_tum` writes a stand-in
from a TUM trajectory. Runs on the CUDA card unless `--device` names
another. Prints one JSON line with the keys of the JAX script: ATE RMSE
(m, Sim(3) and metric, and metric over the largest map), tracked frames and
share, the median frame rate, keyframes, points, maps, loops, merges and
the reset counters.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

import numpy as np

SENSORS = ("mono", "imu-mono", "stereo", "imu-stereo", "rgbd", "imu-rgbd")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", default="MH01")
    ap.add_argument("--sensor", choices=SENSORS, default="mono")
    ap.add_argument("--render", choices=["features", "images"], default="features")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--start-frame", type=int, default=0)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--async-mapping", action="store_true",
                    help="run the mapper and the loop closer on a worker thread "
                         "(default: the offline synchronous mode)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closing / merging (isolation runs)")
    ap.add_argument("--out", default=None, help="TUM trajectory output path")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' for the host)")
    return ap.parse_args(argv)


def replay(args, on_start=None):
    """Run the replay that `args` (from `parse_args`) describes; returns
    (the JSON line's dict, the SLAM). `on_start(slam)` is called once the
    SLAM is built, before the first frame."""
    from ..ops import cameras
    from ..optim import imu as imu_mod
    from ..system import SLAM
    from ..utils import evaluation, gt_replay, synthetic
    from ..utils.config import (IMU_MONOCULAR, IMU_RGBD, IMU_STEREO, MONOCULAR, RGBD, STEREO,
                                SlamConfig)

    times, R_cw, t_cw, p_wc, q_wc = gt_replay.load_euroc_gt(args.seq)
    n = len(times)
    if args.max_frames:
        n = min(n, args.max_frames)
    idx = list(range(args.start_frame, n, args.stride))

    cam = cameras.euroc_cam0()
    sensor = {"mono": MONOCULAR, "imu-mono": IMU_MONOCULAR, "stereo": STEREO,
              "imu-stereo": IMU_STEREO, "rgbd": RGBD, "imu-rgbd": IMU_RGBD}[args.sensor]
    stereo = sensor in (STEREO, IMU_STEREO)
    rgbd = sensor in (RGBD, IMU_RGBD)
    cfg = SlamConfig(sensor=sensor, n_features=args.n_features,
                     min_init_matches=max(40, args.n_features // 10), max_frames_between_kf=10,
                     async_mapping=args.async_mapping, enable_loop_closing=not args.no_loop)
    imu_rows = imu_calib = None
    if cfg.is_inertial:
        imu_hz = 200.0
        imu_rows = gt_replay.synthesize_imu(times[:n], p_wc[:n], q_wc[:n], imu_hz=imu_hz)
        # EuRoC's continuous noise densities as per-sample sigmas, as the
        # reference's Settings converts them (Tracking.cc:680-681)
        sf = imu_hz ** 0.5
        imu_calib = imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32),
                                     tbc=np.zeros(3, np.float32), noise_g=1.7e-4 * sf,
                                     noise_a=2e-3 * sf, walk_g=2e-5 / sf, walk_a=3e-3 / sf)
    slam = SLAM(cam, cfg, imu_calib=imu_calib, device=args.device)

    if args.render == "features":
        # dense enough that any hover view clears the 500-keypoint stereo
        # init gate (sparser worlds starve views facing the hall's far end)
        world = gt_replay.make_hall_world(11, p_wc[:n], n_points=48000)
    else:
        scene = gt_replay.make_room_scene(11, p_wc[:n])
    b = np.array([float(cam.bf) / float(cam.fx), 0.0, 0.0], np.float32)
    if on_start is not None:
        on_start(slam)

    n_tracked = 0
    t_last_imu = -1.0
    frame_times = []
    t0_wall = time.perf_counter()
    for j, i in enumerate(idx):
        ts = float(times[i])
        if imu_rows is not None:
            chunk = imu_rows[(imu_rows[:, 0] > t_last_imu) & (imu_rows[:, 0] <= ts)]
            if len(chunk):
                slam.feed_imu(chunk)
            t_last_imu = ts
        t_f = time.perf_counter()
        if args.render == "features":
            feats, _ = synthetic.render_features(world, cam, R_cw[i], t_cw[i],
                                                 n_feat=args.n_features, seed=1000 + i,
                                                 stereo=stereo or rgbd, device=slam.device)
            pose = slam.track_features(feats, ts)
        elif rgbd:
            img, depth = gt_replay.render_room(scene, cam, R_cw[i], t_cw[i], return_depth=True)
            pose = slam.track_rgbd(img, depth, ts)
        elif stereo:
            # the right camera b along the left one's x axis: t_r = t_l - [b, 0, 0]
            pose = slam.track_stereo(gt_replay.render_room(scene, cam, R_cw[i], t_cw[i]),
                                     gt_replay.render_room(scene, cam, R_cw[i], t_cw[i] - b),
                                     ts)
        else:
            pose = slam.track_monocular(gt_replay.render_room(scene, cam, R_cw[i], t_cw[i]), ts)
        frame_times.append(time.perf_counter() - t_f)
        if pose is not None:
            n_tracked += 1
        if j % 200 == 0:
            print(f"[{j}/{len(idx)}] tracked={n_tracked} kf={slam.n_keyframes()} "
                  f"mp={slam.n_map_points()} maps={slam.map.n_maps}", file=sys.stderr)
    wall = time.perf_counter() - t0_wall

    slam.wait_idle()
    est = slam.trajectory()
    gt = gt_replay.gt_as_tum(times[:n], R_cw[:n], t_cw[:n])
    ate = evaluation.ate_rmse(est, gt, with_scale=True)
    ate_noscale = evaluation.ate_rmse(est, gt, with_scale=False)
    # the largest map's ATE: frames whose reference keyframe lives in it
    # (sub-maps have unrelated world frames; one Horn alignment over them
    # means nothing)
    recs = [r for r in slam.tracker.records if not r.lost and r.ref_kf >= 0]
    mid_of = lambda r: int(slam.map.kf_map_id[r.ref_kf])
    counts = Counter(mid_of(r) for r in recs)
    ate_main, main_frac = float("nan"), 0.0
    if counts:
        main_map, n_main = counts.most_common(1)[0]
        main_ts = {r.timestamp for r in recs if mid_of(r) == main_map}
        ate_main = evaluation.ate_rmse([e for e in est if e[0] in main_ts], gt,
                                       with_scale=False)
        main_frac = n_main / max(len(recs), 1)
    med = float(np.median(frame_times[10:])) if len(frame_times) > 20 else 0.0
    if args.out:
        slam.save_trajectory_tum(args.out)
    return {
        "seq": args.seq, "sensor": args.sensor, "render": args.render,
        "frames": len(idx), "tracked": n_tracked,
        "tracked_ratio": round(n_tracked / max(len(idx), 1), 3),
        "ate_rmse_m": round(float(ate), 4),
        "ate_rmse_noscale_m": round(float(ate_noscale), 4),
        "ate_main_map_noscale_m": round(float(ate_main), 4),
        "main_map_frame_frac": round(main_frac, 3),
        "fps_median": round(1.0 / max(med, 1e-9), 2),
        "wall_s": round(wall, 1),
        "keyframes": slam.n_keyframes(), "map_points": slam.n_map_points(),
        "maps": slam.map.n_maps, "loops": slam.loopcloser.n_loops,
        "kf_removed": slam.map.n_kf_removed,
        "map_resets": slam.n_map_resets,
        "lost_resets": slam.tracker.n_lost_resets,
        "submap_spawns": slam.tracker.n_submap_spawns,
        "merges": slam.loopcloser.n_merges,
    }, slam


def main(argv=None) -> int:
    result, _ = replay(parse_args(argv))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
