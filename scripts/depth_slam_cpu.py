"""Stereo or RGB-D SLAM of either package on the CPU, on the sequence of
`chip_smoke.py` phases 5 and 6: frames 0..N-1 of `make_textured_scene(7)`
along `circular_trajectory(300)` at 20 Hz, EuRoC cam0 (752x480, bf 47.906),
the default full-width `SlamConfig`, loop closing off. The right view is a
rectified rig's (t_r = t - [b, 0, 0]); RGB-D takes the exact depth map.

    python scripts/depth_slam_cpu.py --package jax|torch --sensor stereo|rgbd \\
        [--frames 120] [--stereo-count once|twice] [--threads 4]

`--stereo-count twice` runs the JAX package's keyframe decision with the
reference's count of stereo observations (MapPoint::AddObservation counts
a stereo one twice), the count the port uses; `once` (the default) runs the
JAX package as it stands. Prints one line per frame (state, keyframes,
points) and a JSON line: the first tracked frame, tracked frames,
keyframes, map points, and the metric ATE (no scale fit) of the per-frame
estimates and of `SLAM.trajectory()`.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _stereo_count_twice(jtracker):
    """Wrap the JAX tracker's `_need_new_kf` so that it sees each point's
    observations with the stereo ones counted twice."""
    need_new_kf = jtracker.Tracker._need_new_kf

    def patched(self, *args, **kwargs):
        m = self.map
        saved = m.mp_n_obs
        kf, fi = m.mp_obs_kf, m.mp_obs_idx
        ur = m.kf_feat_ur[np.clip(kf, 0, None), np.clip(fi, 0, None)]
        m.mp_n_obs = saved + ((kf >= 0) & (fi >= 0) & (ur >= 0)).sum(axis=1).astype(np.int32)
        try:
            return need_new_kf(self, *args, **kwargs)
        finally:
            m.mp_n_obs = saved

    jtracker.Tracker._need_new_kf = patched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--sensor", choices=("stereo", "rgbd"), required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--stereo-count", choices=("once", "twice"), default="once",
                    help="JAX package only: how its keyframe decision counts stereo observations")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args(argv)

    # the scene, the arc and the depth map are the port's numpy copies, bit-equal
    # to the JAX package's (tests/test_torch_synthetic.py)
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_comments_ghr_tpu.ops import cameras
        from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
        from orb_slam3_comments_ghr_tpu.system import SLAM
        from orb_slam3_comments_ghr_tpu.utils import config

        if args.stereo_count == "twice":
            _stereo_count_twice(jtracker)
        make = lambda cfg: SLAM(cameras.euroc_cam0(), cfg)
    else:
        import torch

        torch.set_num_threads(args.threads)
        from orb_slam3_comments_ghr_torch.ops import cameras
        from orb_slam3_comments_ghr_torch.system import SLAM
        from orb_slam3_comments_ghr_torch.utils import config

        make = lambda cfg: SLAM(cameras.euroc_cam0(), cfg, device="cpu")

    cam = cameras.euroc_cam0()
    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(300)[:args.frames]
    sensor = config.STEREO if args.sensor == "stereo" else config.RGBD
    slam = make(config.SlamConfig(sensor=sensor, enable_loop_closing=False))
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    est, first = [], None
    t0 = time.time()
    for i, (R, t) in enumerate(poses):
        img = u8(synthetic.render_image(scene, cam, R, t))
        if args.sensor == "stereo":
            pose = slam.track_stereo(img, u8(synthetic.render_image(scene, cam, R, t - b)), i * 0.05)
        else:
            pose = slam.track_rgbd(img, synthetic.depth_map(scene, cam, R, t), i * 0.05)
        if pose is not None:
            first = i if first is None else first
            est.append((i * 0.05, pose))
        print(i, slam.state, slam.n_keyframes(), slam.n_map_points(), f"{time.time() - t0:.1f}s",
              flush=True)
    gt = synthetic.gt_trajectory(poses)
    print(json.dumps(dict(
        package=args.package, sensor=args.sensor, stereo_count=args.stereo_count,
        first_tracked=first, tracked=len(est), frames=args.frames, keyframes=slam.n_keyframes(),
        points=slam.n_map_points(), ate_estimates_m=evaluation.ate_rmse(est, gt, with_scale=False),
        ate_trajectory_m=evaluation.ate_rmse(slam.trajectory(), gt, with_scale=False))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
