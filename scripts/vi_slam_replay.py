"""Replay one `LocalMapper.process_keyframe` of the JAX package's
stereo-inertial run through both packages, from one map snapshot.

Runs the JAX package on the sequence of `chip_smoke.py` phase 7 (as
`scripts/vi_slam_cpu.py --sensor imu_stereo --stereo-count twice` does)
until its `process_keyframe` call number `--call` (0-based), keeps the map,
the keyframe preintegrations, the IMU bias and the mapper's staging state
just before it, then runs that call again on copies of the snapshot in a
new JAX mapper and in the port's mapper (on the CPU) and prints the
largest differences between the two results: keyframe centres (m),
rotations, velocities (m/s), biases and live map points (m, and the
median over the points), and whether the same keyframes and points are
live. A difference at float32 rounding
means the packages agree on that call, and the runs part by drift.

    python scripts/vi_slam_replay.py --call N [--threads 4]

Needs both packages (JAX on the CPU).
"""

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the mapper's state besides the map and the preintegrations
_STAGING = ("recent_mps", "t_imu_init", "viba1_done", "viba2_done", "last_scale_refine_t",
            "_imu_init_failures", "_staging_map", "t_init_accum", "_t_accum_by_map",
            "_last_motion_kf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--call", type=int, required=True)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    from depth_slam_cpu import _stereo_count_twice
    from vi_slam_cpu import NOISE, SETUPS
    from orb_slam3_comments_ghr_tpu.map import state as jstate
    from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
    from orb_slam3_comments_ghr_tpu.optim import imu as jimu
    from orb_slam3_comments_ghr_tpu.pipeline import imu_frontend as jfront, mapper as jmapper
    from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
    from orb_slam3_comments_ghr_tpu.system import SLAM
    from orb_slam3_comments_ghr_tpu.utils import config as jconfig
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
    from orb_slam3_comments_ghr_torch.pipeline import imu_frontend as tfront, mapper as tmapper
    from orb_slam3_comments_ghr_torch.utils import synthetic

    _stereo_count_twice(jtracker)
    seed, n, widths = SETUPS["imu_stereo"]
    calib = jimu.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), **NOISE)
    cfg = jconfig.SlamConfig(sensor=jconfig.IMU_STEREO, enable_loop_closing=False, **widths)
    slam = SLAM(jcameras.euroc_cam0(), cfg, imu_calib=calib)
    np_tree = lambda tree: {k: np.asarray(v) for k, v in tree._asdict().items()}
    box, count = {}, [0]
    process_keyframe = slam.mapper.process_keyframe

    def recorded(kf):
        if count[0] == args.call:
            mp = slam.mapper
            box.update(kf=kf, map=convert.map_state_to_numpy(slam.map),
                       preint={k: np_tree(v) for k, v in mp.kf_preint.items()},
                       bias=np.asarray(mp.imu.bias).copy(),
                       staging={k: copy.deepcopy(getattr(mp, k)) for k in _STAGING})
        count[0] += 1
        process_keyframe(kf)

    slam.mapper.process_keyframe = recorded
    cam = tcameras.euroc_cam0()
    scene = synthetic.make_textured_scene(seed)
    poses, imu_rows, times = synthetic.vi_sequence(n)
    u8 = lambda img: np.clip(np.round(img), 0, 255).astype(np.uint8)
    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    for i in range(n):
        if "kf" in box:
            break
        R, t = poses[i]
        rows = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1.0)) & (imu_rows[:, 0] <= times[i])]
        slam.track_stereo(u8(synthetic.render_image(scene, cam, R, t)),
                          u8(synthetic.render_image(scene, cam, R, t - b)), times[i],
                          imu_samples=rows if len(rows) else None)
    if "kf" not in box:
        raise SystemExit(f"the run made fewer than {args.call + 1} process_keyframe calls")

    # the same call in a new JAX mapper and in the port's, from the snapshot
    jm = jstate.MapState(jstate.MapConfig(**box["map"]["cfg"]))
    for k, v in box["map"].items():
        if k != "cfg":
            setattr(jm, k, v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
    jmp = jmapper.LocalMapper(jcameras.euroc_cam0(), cfg, jm)
    jmp.imu = jfront.ImuFrontend(calib)
    jmp.kf_preint = {k: jimu.Preintegrated(**{f: jnp.asarray(a) for f, a in v.items()})
                     for k, v in box["preint"].items()}
    tm = convert.map_state_from_numpy(box["map"])
    tmp = tmapper.LocalMapper(cam, convert.config_from_jax(cfg), tm, device="cpu")
    tmp.imu = tfront.ImuFrontend(convert.imu_calib_from_jax(calib), device="cpu")
    tmp.kf_preint = {k: convert.preintegrated_from_numpy(v, device="cpu")
                     for k, v in box["preint"].items()}
    for mp in (jmp, tmp):
        mp.imu.bias = box["bias"].copy()
        for k, v in box["staging"].items():
            setattr(mp, k, copy.deepcopy(v))
        mp.process_keyframe(box["kf"])

    kfs = np.nonzero(jm.kf_valid & tm.kf_valid)[0]
    pts = np.nonzero(jm.mp_valid & tm.mp_valid)[0]
    centre = lambda m: -np.einsum("kji,kj->ki", m.kf_R[kfs].astype(np.float64),
                                  m.kf_t[kfs].astype(np.float64))
    print(json.dumps(dict(
        call=args.call, kf=int(box["kf"]), keyframes=len(kfs), points=len(pts),
        same_keyframes=bool((jm.kf_valid == tm.kf_valid).all()),
        same_points=bool((jm.mp_valid == tm.mp_valid).all()),
        imu_init=[bool(jm.map_imu_init.get(jm.active_map, False)),
                  bool(tm.map_imu_init.get(tm.active_map, False))],
        centre_m=float(np.linalg.norm(centre(jm) - centre(tm), axis=1).max()),
        rotation=float(np.abs(jm.kf_R[kfs] - tm.kf_R[kfs]).max()),
        velocity_mps=float(np.abs(jm.kf_vel[kfs] - tm.kf_vel[kfs]).max()),
        bias=float(np.abs(jm.kf_bias[kfs] - tm.kf_bias[kfs]).max()),
        points_m=float(np.abs(jm.mp_pos[pts] - tm.mp_pos[pts]).max()) if len(pts) else 0.0,
        points_m_median=float(np.median(np.linalg.norm(jm.mp_pos[pts] - tm.mp_pos[pts], axis=1)))
        if len(pts) else 0.0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
