"""`SLAM.reset()` through the port: it must leave the state a new `SLAM`
has (ROADMAP C3). The JAX package keeps its keyframe database, the
mapper's inertial clocks, the IMU queue and bias and the tracker's
velocity across a reset; the port starts a fresh session, a deliberate
divergence.

- Monocular, loop closing on (the default): 40 frames of rendered features
  with a keyframe every 4 frames, `reset()`, 12 frames of another arc: the
  keyframe database then holds exactly the new map's keyframes, the loop
  closer has no pending hypothesis, and every part shares the new map and
  database.
- Stereo-inertial (the sequence of `tests/test_torch_vi_slam.py`): a run
  past the IMU initialization, `reset()`, then the sequence from its
  start: the IMU initializes at the same frame, with the same keyframe
  poses and VIBA stages, as the first time."""

import dataclasses

import numpy as np
import torch

from test_torch_vi_slam import CFG as VI_CFG, TCAL
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.utils import config as tconfig, synthetic as tsynthetic

torch.set_num_threads(1)

TCAM = tcameras.euroc_cam0()


def test_reset_gives_a_fresh_session():
    world = tsynthetic.World(**dataclasses.asdict(jsynthetic.make_world(3, n_points=3000)))
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(n_features=512, local_points_cap=2048,
                                                 local_ba_points=2048, max_frames_between_kf=4,
                                                 min_init_matches=60), device="cpu")

    def track(poses, seed):
        for i, (R, t) in enumerate(poses):
            feats, _ = tsynthetic.render_features(world, TCAM, R, t, n_feat=512, seed=seed + i,
                                                  device="cpu")
            slam.track_features(feats, i * 0.05)

    track(jsynthetic.circular_trajectory(40), 3000)
    assert slam.n_keyframes() >= 3
    slam.loopcloser._pendings.append({"region": {0}, "hits": 1, "misses": 0})
    slam.reset()
    assert slam.kfdb.present.sum() == 0 and slam.loopcloser._pendings == []
    track(jsynthetic.circular_trajectory(12, radius=1.5), 5000)
    kfs = set(int(k) for k in slam.map.kf_ids())
    assert len(kfs) >= 2
    assert set(np.nonzero(slam.kfdb.present)[0].tolist()) == kfs
    assert slam.loopcloser._pendings == []
    for part in (slam.tracker, slam.mapper, slam.loopcloser):
        assert part.map is slam.map and part.kfdb is slam.kfdb


def _vi_run(slam, seq, world, frames, until):
    """Feed `frames` of the stereo-inertial sequence; returns the first of
    them after which `until()` holds, or None."""
    poses, imu_rows, times = seq
    for i in frames:
        R, t = poses[i]
        chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1)) & (imu_rows[:, 0] <= times[i])]
        if len(chunk):
            slam.feed_imu(chunk)
        feats, _ = tsynthetic.render_features(world, TCAM, R, t, n_feat=VI_CFG["n_features"],
                                              seed=5100 + i, stereo=True, device="cpu")
        slam.track_features(feats, times[i])
        if until():
            return i
    return None


def test_reset_restarts_the_inertial_staging():
    """A session runs past its IMU initialization (its staging clocks
    running), is reset and fed the sequence again from the start: the IMU
    initializes at the same frame, to the same keyframe poses and stages,
    as the first time, when the session was new."""
    world = tsynthetic.World(**dataclasses.asdict(jsynthetic.make_world(41, n_points=3000)))
    seq = jsynthetic.vi_sequence(70)
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**VI_CFG), imu_calib=TCAL, device="cpu")
    imu_init = lambda: slam.map.map_imu_init.get(slam.map.active_map, False)
    first = _vi_run(slam, seq, world, range(70), imu_init)
    assert first is not None
    at_init = (slam.map.kf_R[slam.map.kf_ids()].copy(), slam.mapper.t_imu_init,
               slam.mapper.viba1_done, slam.mapper.viba2_done)
    assert _vi_run(slam, seq, world, range(first + 1, 70),
                   lambda: slam.mapper.t_init_accum > 0.0) is not None
    slam.reset()
    assert slam.mapper.t_imu_init is None and slam.mapper.t_init_accum == 0.0
    assert slam.mapper._t_accum_by_map == {} and slam.imu.queue == []
    assert not slam.imu.bias.any() and slam.tracker.velocity is None
    assert slam.kfdb.present.sum() == 0
    assert _vi_run(slam, seq, world, range(70), imu_init) == first
    np.testing.assert_allclose(slam.map.kf_R[slam.map.kf_ids()], at_init[0], atol=1e-5)
    assert (slam.mapper.t_imu_init, slam.mapper.viba1_done, slam.mapper.viba2_done) == at_init[1:]
