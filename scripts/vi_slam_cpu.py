"""Visual-inertial SLAM of either package on the CPU, on the sequences of
`chip_smoke.py` phases 7 and 8.

- `--sensor imu_stereo` (phase 7): 150 frames of `vi_sequence(150)`, left
  and right views rendered from `make_textured_scene(7)` (a rectified rig,
  t_r = t - [b, 0, 0], as `bench.py` renders its stereo-inertial input),
  EuRoC cam0 (752x480, bf 47.906), `SlamConfig(sensor=IMU_STEREO,
  n_features=1024, local_points_cap=4096, local_ba_points=2048,
  max_frames_between_kf=10, min_init_matches=60)` (the stereo-inertial
  pass of `bench.py`), loop closing and asynchronous mapping off.
- `--sensor imu_rgbd` (phase 8): 60 frames of `vi_sequence(60)` over
  `make_textured_scene(61)` with the exact depth map, the configuration of
  `tests/test_rgbd_inertial.py`.

Both use the near-ideal IMU calibration of `bench.py` (noise 1e-4 / 1e-3,
walk 1e-6 / 1e-5) and feed each frame the IMU rows in (t_{i-1}, t_i].

    python scripts/vi_slam_cpu.py --package jax|torch --sensor imu_stereo|imu_rgbd \\
        [--frames N] [--arc TURNS] [--loop-closing] [--stereo-count once|twice] \\
        [--pipelined [--pipeline-depth N]] [--async-mapping] [--threads 4] \\
        [--dump FILE.npz] [--out traj.tum]

- `--setup stereo_pipelined` (`--setup` is another name of `--sensor`;
  phase 14 (c) at 60 frames): the 60 frames of `vi_sequence(60)` and the
  configuration of `tests/test_stereo_pipelined.py` (scene 7, 768
  features, local map and BA 2048, a keyframe at least every 5 frames,
  loop closing off), left and right views as `imu_stereo`.

`--pipelined` tracks a rectified pair through `SLAM.track_stereo_pipelined`
(the pose returned is that of the frame `pipeline_depth` calls earlier;
`flush_pipeline()` finishes the rest), and `--async-mapping` sets
`SlamConfig(async_mapping=True)`: the mapper runs on a worker thread,
drained by `wait_idle()` before the trajectory is read. With either, the
per-frame line's state and the IMU-init frame are read at the call, which
runs `pipeline_depth` frames ahead of the bookkeeping when pipelined and
ahead of the worker's mapping when asynchronous.

- `--sensor imu_stereo_loop` (phase 11 (a)): the configuration of
  `imu_stereo` with loop closing on (`loop_requires_viba2=False`,
  `loop_min_kfs=8`, the gates of `tests/test_inertial_merge.py`), on
  `vi_sequence(N, arc=TURNS, outward=True)`, an outward-looking turn
  inside the textured room of `tests/test_image_loopclosing.py`
  (`gt_replay.make_room_scene(33, ...)`), left and right views.

- `--sensor imu_stereo_fisheye` (phase 12 (c)): the configuration of
  `imu_stereo` on the non-rectified KB8 fisheye pair of
  `tests/test_fisheye_stereo.py` (752x480, x_l = R_lr x_r + t_lr, an 11 cm
  baseline) through `SLAM.track_stereo_fisheye`, both views rendered from
  `vi_sequence(150)`'s poses in room scene 33 built around them.

`--arc` sets TURNS (default the setup's) and runs `vi_sequence(N,
arc=TURNS)` over the N frames in place of the setup's sequence.

`--stereo-count twice` runs the JAX package's keyframe decision with the
count of stereo observations the port uses (see scripts/depth_slam_cpu.py).

Prints one line per frame (state, keyframes, points, IMU initialized) and
a JSON line: the first tracked frame, the frame of the IMU initialization,
whether VIBA1 ran, tracked frames, keyframes, map points, and the metric
ATE (no scale fit) of `SLAM.trajectory()`. `--dump` writes, after each
`process_keyframe`, the keyframe's id and the poses, velocities and biases
of every live keyframe to FILE (`scripts/vi_slam_diff.py` compares two such
files).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (scene seed, frames, config) of each sensor
SETUPS = {
    "imu_stereo": (7, 150, dict(n_features=1024, local_points_cap=4096, local_ba_points=2048,
                                max_frames_between_kf=10, min_init_matches=60)),
    "stereo_pipelined": (7, 60, dict(n_features=768, local_points_cap=2048, local_ba_points=2048,
                                     max_frames_between_kf=5)),
    "imu_rgbd": (61, 60, dict(n_features=768, local_points_cap=2048, local_ba_points=2048,
                              max_frames_between_kf=5)),
    "imu_stereo_fisheye": (33, 150, dict(n_features=1024, local_points_cap=4096,
                                         local_ba_points=2048, max_frames_between_kf=10,
                                         min_init_matches=60)),
    "imu_stereo_loop": (33, 200, dict(n_features=1024, local_points_cap=4096,
                                      local_ba_points=2048, max_frames_between_kf=10,
                                      min_init_matches=60, enable_loop_closing=True,
                                      loop_requires_viba2=False, loop_min_kfs=8)),
}
LOOP_ARC = 1.1  # turns of imu_stereo_loop's sequence
NOISE = dict(noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)


def fisheye_pair(cameras_mod, so3_exp):
    """The KB8 pair of tests/test_fisheye_stereo.py in `cameras_mod`'s
    Camera (the left one with bf = fx * baseline, for the depth threshold)
    and its extrinsics x_l = R_lr x_r + t_lr; `so3_exp` maps a float32
    (3,) array to the rotation."""
    t_lr = np.array([0.11, 0.001, -0.002], np.float32)
    cam_l = cameras_mod.Camera(
        kind=cameras_mod.KANNALA_BRANDT8, fx=380.0, fy=380.0, cx=376.0, cy=240.0,
        k1=0.01, k2=-0.002, k3=0.001, k4=-0.0005, width=752, height=480,
        bf=380.0 * float(t_lr[0]))
    cam_r = cameras_mod.Camera(
        kind=cameras_mod.KANNALA_BRANDT8, fx=382.0, fy=382.0, cx=370.0, cy=244.0,
        k1=0.012, k2=-0.001, k3=0.0008, k4=-0.0004, width=752, height=480)
    R_lr = np.asarray(so3_exp(np.array([0.0, 0.02, 0.0], np.float32)), np.float32)
    return cam_l, cam_r, R_lr, t_lr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--sensor", "--setup", dest="sensor", choices=tuple(SETUPS), required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--arc", type=float, default=None,
                    help="turns of vi_sequence over the frames (default: the setup's sequence)")
    ap.add_argument("--stereo-count", choices=("once", "twice"), default="once",
                    help="JAX package only: how its keyframe decision counts stereo observations")
    ap.add_argument("--pipelined", action="store_true",
                    help="rectified stereo through track_stereo_pipelined")
    ap.add_argument("--async-mapping", action="store_true",
                    help="SlamConfig(async_mapping=True): the mapper on a worker thread")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="SlamConfig.pipeline_depth (frames in flight) with --pipelined")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--dump", default=None, help="write the keyframe states after each "
                    "process_keyframe to this .npz")
    ap.add_argument("--out", default=None, help="write the trajectory (TUM) to this file")
    args = ap.parse_args(argv)

    # the scene, the IMU sequence and the depth map are the port's numpy
    # copies, bit-equal to the JAX package's (tests/test_torch_synthetic.py)
    from orb_slam3_comments_ghr_torch.utils import evaluation, synthetic

    if args.package == "jax":
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_comments_ghr_tpu.ops import cameras
        from orb_slam3_comments_ghr_tpu.optim import imu as imu_mod
        from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
        from orb_slam3_comments_ghr_tpu.system import SLAM
        from orb_slam3_comments_ghr_tpu.utils import config

        if args.stereo_count == "twice":
            from depth_slam_cpu import _stereo_count_twice

            _stereo_count_twice(jtracker)
        from orb_slam3_comments_ghr_tpu.ops import lie

        calib = imu_mod.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), **NOISE)
        make = lambda cam, cfg: SLAM(cam, cfg, imu_calib=calib)
        so3_exp = lambda w: lie.so3_exp(jnp.asarray(w))
    else:
        import torch

        torch.set_num_threads(args.threads)
        from orb_slam3_comments_ghr_torch.ops import cameras
        from orb_slam3_comments_ghr_torch.optim import imu as imu_mod
        from orb_slam3_comments_ghr_torch.system import SLAM
        from orb_slam3_comments_ghr_torch.utils import config

        from orb_slam3_comments_ghr_torch.ops import lie

        calib = imu_mod.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                                 **NOISE)
        make = lambda cam, cfg: SLAM(cam, cfg, imu_calib=calib, device="cpu")
        so3_exp = lambda w: lie.so3_exp(torch.from_numpy(w)).numpy()

    seed, n, widths = SETUPS[args.sensor]
    n = args.frames or n
    cam = cameras.euroc_cam0()
    fisheye = args.sensor == "imu_stereo_fisheye"
    if fisheye:
        cam, cam_r, R_lr, t_lr = fisheye_pair(cameras, so3_exp)
        R_rl, t_rl = R_lr.T, -R_lr.T @ t_lr
    ring = args.sensor == "imu_stereo_loop"
    arc = args.arc or (LOOP_ARC if ring else None)
    poses, imu_rows, times = (synthetic.vi_sequence(SETUPS[args.sensor][1]) if arc is None
                              else synthetic.vi_sequence(n, arc=arc, outward=ring))
    if ring or fisheye:
        from orb_slam3_comments_ghr_torch.utils import gt_replay

        room = gt_replay.make_room_scene(seed, np.stack([-R.T @ t for R, t in poses]),
                                         margin=4.0, span=20.0)
        render = lambda R, t: gt_replay.render_room(room, cam, R, t)
    else:
        scene = synthetic.make_textured_scene(seed)
        render = lambda R, t: synthetic.render_image(scene, cam, R, t)
    stereo = args.sensor != "imu_rgbd"
    if args.pipelined and (fisheye or not stereo):
        ap.error("--pipelined takes a rectified stereo setup")
    slam = make(cam, config.SlamConfig(sensor=config.IMU_STEREO if stereo else config.IMU_RGBD,
                                       async_mapping=args.async_mapping,
                                       **{"enable_loop_closing": False, **widths},
                                       **({} if args.pipeline_depth is None else
                                          {"pipeline_depth": args.pipeline_depth})))
    dumps = []
    if args.dump:
        process_keyframe = slam.mapper.process_keyframe

        def dumped(kf):
            process_keyframe(kf)
            m = slam.map
            ids = m.kf_ids()
            dumps.append(dict(kf=kf, ids=ids, R=m.kf_R[ids].copy(), t=m.kf_t[ids].copy(),
                              vel=m.kf_vel[ids].copy(), bias=m.kf_bias[ids].copy()))

        slam.mapper.process_keyframe = dumped
    retired = [0]  # frames the deep pipeline finished with a pose
    if args.pipelined:
        retire = slam._retire_oldest

        def counted_retire():
            pose = retire()
            retired[0] += pose is not None
            return pose

        slam._retire_oldest = counted_retire
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    tracked, first, imu_init_frame = 0, None, None
    t0 = time.time()
    for i in range(n):
        R, t = poses[i]
        chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0))
                         & (imu_rows[:, 0] <= times[i])]
        rows = chunk if len(chunk) else None
        img = u8(render(R, t))
        if fisheye:
            img_r = u8(gt_replay.render_room(room, cam_r, (R_rl @ R).astype(np.float32),
                                             (R_rl @ t + t_rl).astype(np.float32)))
            pose = slam.track_stereo_fisheye(img, img_r, cam_r, R_lr, t_lr, times[i],
                                             imu_samples=rows)
        elif args.pipelined:
            pose = slam.track_stereo_pipelined(img, u8(render(R, t - b)), times[i],
                                               imu_samples=rows)
        elif stereo:
            pose = slam.track_stereo(img, u8(render(R, t - b)), times[i], imu_samples=rows)
        else:
            pose = slam.track_rgbd(img, synthetic.depth_map(scene, cam, R, t), times[i],
                                   imu_samples=rows)
        if pose is not None:
            first = i if first is None else first
            tracked += 1
        init = bool(slam.map.map_imu_init.get(slam.map.active_map, False))
        if init and imu_init_frame is None:
            imu_init_frame = i
        print(i, slam.state, slam.n_keyframes(), slam.n_map_points(), init,
              f"{time.time() - t0:.1f}s", flush=True)
    if args.pipelined:
        slam.flush_pipeline()
        tracked = retired[0]
    slam.wait_idle()
    if args.out:
        slam.save_trajectory_tum(args.out)
    if args.dump:
        np.savez(args.dump, **{f"{j}_{k}": v for j, d in enumerate(dumps) for k, v in d.items()})
    gt = [(times[i], np.vstack([np.hstack([poses[i][0], poses[i][1][:, None]]), [0, 0, 0, 1]])
           .astype(np.float32)) for i in range(n)]
    print(json.dumps(dict(
        package=args.package, sensor=args.sensor, stereo_count=args.stereo_count, frames=n,
        pipelined=args.pipelined, async_mapping=args.async_mapping,
        worker_errors=slam.worker_errors, poses=len(slam.trajectory()),
        arc=arc, loops=getattr(slam.loopcloser, "n_loops", 0),
        merges=getattr(slam.loopcloser, "n_merges", 0), maps=slam.map.n_maps,
        right_rows=int((slam.map.mp_obs_r_level >= 0).sum()),
        first_tracked=first, imu_init_frame=imu_init_frame, viba1=bool(slam.mapper.viba1_done), tracked=tracked,
        keyframes=slam.n_keyframes(), points=slam.n_map_points(),
        ate_trajectory_m=evaluation.ate_rmse(slam.trajectory(), gt, with_scale=False))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
