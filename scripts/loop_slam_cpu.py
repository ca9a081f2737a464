"""Loop closing of either package on the CPU, on the runs of
`chip_smoke.py` phase 10:

- `--run feature_loop` (a): `tests/test_loopclosing.py`'s loop, 160 frames
  of 512 rendered features (ring world 13, 1.06 outward turns, 0.7 px
  noise) through `SLAM.track_features`;
- `--run merge` (b): `tests/test_merge.py`'s kidnap, ring world 23,
  frames 0-59, 14 blank frames, then poses 5-55 again;
- `--run image_loop` (c): `tests/test_image_loopclosing.py`'s 150 EuRoC
  cam0 frames (752x480) rendered in room scene 33 along a full outward
  circle, through `SLAM.track_monocular` with that test's configuration
  (768 features, local map 2048, local BA 1024 points).

Loop closing is on (the default), asynchronous mapping off. Prints one
JSON line: tracked frames, keyframes, map points, maps, loops and merges,
the active map, and the Sim(3)-aligned ATE (of the per-frame poses for (a),
of `SLAM.trajectory()` for (c)).

    python scripts/loop_slam_cpu.py --package jax|torch --run feature_loop|merge|image_loop \\
        [--threads 4]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

WIDTHS = {
    "feature_loop": dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
                         max_frames_between_kf=5, min_init_matches=60),
    "merge": dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
                  max_frames_between_kf=5, min_init_matches=60, recently_lost_secs=0.4,
                  loop_min_kfs=8),
    "image_loop": dict(n_features=768, local_points_cap=2048, local_ba_points=1024,
                       max_frames_between_kf=5, min_init_matches=50),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--run", choices=tuple(WIDTHS), required=True)
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args(argv)

    # worlds, trajectories and room frames from the port's numpy copies,
    # the same draws as the JAX package's
    from orb_slam3_comments_ghr_torch.utils import evaluation, gt_replay, synthetic

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_comments_ghr_tpu.frontend.types import empty_features
        from orb_slam3_comments_ghr_tpu.ops import cameras
        from orb_slam3_comments_ghr_tpu.system import SLAM
        from orb_slam3_comments_ghr_tpu.utils import config
        from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic

        make = lambda cfg: SLAM(cameras.euroc_cam0(), cfg)
        feats_of = lambda *a, **k: jsynthetic.render_features(*a, **k)[0]
        blank = lambda n: empty_features(n)
    else:
        import torch

        torch.set_num_threads(args.threads)
        from orb_slam3_comments_ghr_torch.frontend.types import empty_features
        from orb_slam3_comments_ghr_torch.ops import cameras
        from orb_slam3_comments_ghr_torch.system import SLAM
        from orb_slam3_comments_ghr_torch.utils import config

        make = lambda cfg: SLAM(cameras.euroc_cam0(), cfg, device="cpu")
        feats_of = lambda *a, **k: synthetic.render_features(*a, device="cpu", **k)[0]
        blank = lambda n: empty_features(n, device="cpu")

    cam = cameras.euroc_cam0()
    slam = make(config.SlamConfig(**WIDTHS[args.run]))
    t0 = time.time()
    out = dict(package=args.package, run=args.run)
    if args.run == "feature_loop":
        world = synthetic.make_ring_world(13)
        poses = synthetic.circular_trajectory(160, arc=1.06, outward=True)
        est = []
        for i, (R, t) in enumerate(poses):
            pose = slam.track_features(feats_of(world, cam, R, t, n_feat=512, seed=1300 + i,
                                                noise_px=0.7), i * 0.05)
            if pose is not None:
                est.append((i * 0.05, pose))
        out.update(tracked=len(est), ate_m=evaluation.ate_rmse(
            est, synthetic.gt_trajectory(poses), with_scale=True))
    elif args.run == "merge":
        world = synthetic.make_ring_world(23)
        poses = synthetic.circular_trajectory(160, arc=1.0, outward=True)
        for i in range(60):
            slam.track_features(feats_of(world, cam, *poses[i], n_feat=512, seed=2300 + i), i * 0.05)
        out["kfs_before"] = slam.n_keyframes()
        for j in range(14):
            slam.track_features(blank(512), 3.0 + j * 0.05)
        out["maps_after_kidnap"] = slam.map.n_maps
        out["tracked"] = sum(
            slam.track_features(feats_of(world, cam, *poses[i], n_feat=512, seed=9300 + i),
                                4.0 + j * 0.05) is not None for j, i in enumerate(range(5, 56)))
    else:
        poses = synthetic.circular_trajectory(150, arc=1.0, outward=True)
        centers = np.stack([-R.T @ t for R, t in poses])
        scene = gt_replay.make_room_scene(33, centers, margin=4.0, span=20.0)
        tracked = 0
        for i, (R, t) in enumerate(poses):
            tracked += slam.track_monocular(gt_replay.render_room(scene, cam, R, t), i * 0.05) is not None
            print(i, slam.state, slam.n_keyframes(), slam.loopcloser.n_loops, flush=True)
        out.update(tracked=tracked, ate_m=evaluation.ate_rmse(
            slam.trajectory(), synthetic.gt_trajectory(poses), with_scale=True))
    lc = slam.loopcloser
    out.update(keyframes=slam.n_keyframes(), points=slam.n_map_points(), maps=slam.map.n_maps,
               loops=lc.n_loops, merges=lc.n_merges, active_map=int(slam.map.active_map),
               seconds=round(time.time() - t0, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
