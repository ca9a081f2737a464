"""CLI driver: run SLAM on a dataset directory and export the trajectory.

Replaces the reference's example executables (Examples/ROS nodes; upstream
mono_euroc/stereo_euroc drivers):

    python -m orb_slam3_comments_ghr_torch.io.run_slam \
        --dataset euroc --root /data/MH01 --sensor mono \
        --out traj_tum.txt [--gt groundtruth.txt] [--device cpu]

Port of `orb_slam3_comments_ghr_tpu/io/run_slam.py`: the same flags, loop
and one-line JSON result, plus `--device` (the card unless the caller names
another). Under a multi-process launch (`parallel/distributed.py`'s
environment) every rank runs the same loop and the whole-map BA of
`SlamConfig(dba_devices != 0)` is sharded over them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["euroc", "tum"], required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--sensor",
                    choices=["mono", "stereo", "rgbd", "imu-mono",
                             "imu-stereo", "imu-rgbd"],
                    default="mono")
    ap.add_argument("--settings", default=None,
                    help="ORB-SLAM3 YAML settings file (v1.0 or legacy "
                         "schema); overrides the built-in EuRoC intrinsics")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None, help="TUM-format ground truth for ATE")
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viz", default=None,
                    help="directory for map/frame PNG renders (Viewer analog)")
    ap.add_argument("--viewer-port", type=int, default=None,
                    help="serve the live HTTP viewer (frame/map/state; the "
                         "Pangolin Viewer analog) on this port; 0 = any")
    ap.add_argument("--clahe", action="store_true",
                    help="CLAHE-equalize frames (clip 3.0, 8x8 tiles) like "
                         "the reference ROS drivers "
                         "(ros_stereo_inertial.cc:68-69)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from dataclasses import replace

    from ..parallel import distributed

    # no-op unless a multi-process launch is set up
    distributed.initialize(device=args.device)

    from ..ops import cameras
    from ..system import SLAM
    from ..utils.config import (
        SlamConfig, MONOCULAR, STEREO, RGBD, IMU_MONOCULAR, IMU_STEREO,
        IMU_RGBD,
    )
    from . import datasets

    sensor = {
        "mono": MONOCULAR, "stereo": STEREO, "rgbd": RGBD,
        "imu-mono": IMU_MONOCULAR, "imu-stereo": IMU_STEREO,
        "imu-rgbd": IMU_RGBD,
    }[args.sensor]
    imu_calib = None
    if args.settings:
        # Settings-file path (Settings.cc): camera intrinsics, stereo bf,
        # ORB budget, and IMU noise/extrinsics all come from the YAML
        from .config_yaml import load_settings

        cam, cfg, imu_calib = load_settings(args.settings, sensor=sensor)
        cfg = replace(
            cfg, min_init_matches=max(40, cfg.n_features // 10),
        )
    else:
        cam = cameras.euroc_cam0()
        # init-match gate scales with the feature budget (ref: 100 @ ~1000)
        cfg = SlamConfig(
            sensor=sensor, n_features=args.n_features,
            min_init_matches=max(40, args.n_features // 10),
        )
    slam = SLAM(cam, cfg, imu_calib=imu_calib, device=args.device)

    use_stereo = sensor in (STEREO, IMU_STEREO)
    use_imu = cfg.is_inertial
    # raw (unrectified) stereo YAML: per-frame rectification through the
    # precomputed maps (Settings.h:153-163 / cv::remap in the ROS drivers)
    rig = None
    if use_stereo and args.settings:
        from .config_yaml import load_stereo_rig

        rig = load_stereo_rig(args.settings)
    equalize = None
    if args.clahe:
        from ..frontend.clahe import clahe as equalize
    if args.dataset == "euroc":
        ds = datasets.EurocDataset(args.root, stereo=use_stereo, imu=use_imu)
    else:
        ds = datasets.TumRgbdDataset(args.root)

    viewer = None
    if args.viewer_port is not None:
        from ..utils.live_viewer import LiveViewer

        viewer = LiveViewer(slam, port=args.viewer_port)
        port = viewer.start()
        print(f"live viewer: http://127.0.0.1:{port}/", file=sys.stderr)

    n_tracked = 0
    t0 = time.perf_counter()
    for i, fr in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        if fr.imu is not None and len(fr.imu):
            slam.feed_imu(fr.imu)
        img, img_r = fr.img, fr.img_right
        if equalize is not None:
            img = equalize(torch.as_tensor(img, device=slam.device))
            if img_r is not None:
                img_r = equalize(torch.as_tensor(img_r, device=slam.device))
        if rig is not None and img_r is not None:
            img, img_r = rig.rectify(img, img_r, device=slam.device)
        if use_stereo and img_r is not None:
            pose = slam.track_stereo(img, img_r, fr.timestamp)
        elif sensor in (RGBD, IMU_RGBD) and fr.depth is not None:
            pose = slam.track_rgbd(img, fr.depth, fr.timestamp)
        else:
            pose = slam.track_monocular(img, fr.timestamp)
        if pose is not None:
            n_tracked += 1
        if viewer is not None:
            viewer.publish(img)
    wall = time.perf_counter() - t0
    if viewer is not None:
        viewer.stop()

    slam.shutdown()  # drains the mapping worker and a whole-map BA, if any
    slam.save_trajectory_tum(args.out)
    if args.viz:
        import os as _os
        from ..utils import viz
        _os.makedirs(args.viz, exist_ok=True)
        viz.draw_map(slam.map, path=_os.path.join(args.viz, "map.png"))
    result = {
        "frames": len(ds), "tracked": n_tracked,
        "fps": round(len(ds) / max(wall, 1e-9), 2),
        "keyframes": slam.n_keyframes(), "map_points": slam.n_map_points(),
        "out": args.out,
    }
    if args.gt:
        from ..utils import evaluation

        gt = []
        with open(args.gt) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                if len(v) < 8:
                    continue
                from ..ops import lie

                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = lie.quat_to_mat(
                    torch.tensor([v[7], v[4], v[5], v[6]], dtype=torch.float32)).numpy()
                T[:3, 3] = v[1:4]
                gt.append((v[0], np.linalg.inv(T)))  # file stores T_wc
        result["ate_rmse"] = round(
            evaluation.ate_rmse(slam.trajectory(), gt, with_scale=True), 4
        )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
