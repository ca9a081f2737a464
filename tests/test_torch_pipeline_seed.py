"""ROADMAP C17: the deep pipeline's seed for a frame it prepares with no
motion model and no result in flight to chain from.

Right after a stereo initialization, `track_stereo_pipelined` prepared the
frame `pipeline_depth` calls ahead with the last tracked pose as its seed:
`steps` frames of motion stale, with nothing in flight for
`programs.chain_seed` to advance. On `tests/test_stereo_pipelined.py`'s 60
frames (17 cm a frame) that track settled 40 cm off the true pose, and the
run's metric ATE was 57-58 mm where the synchronous tracker's is 14 mm
(`scripts/vi_slam_cpu.py --setup stereo_pipelined`, both on the CPU). The
port now leaves such a frame to be tracked at its retirement, predicted
from the frame before it; the JAX package keeps the stale seed.

The same start on rendered stereo features (`vi_sequence`'s fast arc in a
landmark hall, `SLAM._pipeline_track_dispatch` as the pipelined entry
points call it): the first frame prepared after the initialization is not
dispatched, and every pose that comes back, that frame's from its
retirement's host-path track, lies within 2 cm of the truth. (On these
ideal features, whose descriptors are unique, the stale seed's track
converges as well; the accuracy bar of the fault is `chip_smoke.py` phase
14 (c)'s on the 60 rendered frames: metric ATE < 40 mm.)
"""

import numpy as np
import torch

from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import gt_replay, synthetic
from orb_slam3_comments_ghr_torch.utils.config import STEREO, SlamConfig

torch.set_num_threads(1)

FRAMES = 7


def test_unchained_frame_after_init_is_tracked_at_retirement():
    cam = cameras.euroc_cam0()
    poses, _, times = synthetic.vi_sequence(FRAMES)
    centres = np.stack([-R.T @ t for R, t in poses])
    world = gt_replay.make_hall_world(3, centres, n_points=12000)
    slam = SLAM(cam, SlamConfig(sensor=STEREO, n_features=512, local_points_cap=1024,
                                local_ba_points=1024, enable_loop_closing=False), device="cpu")
    depth = slam.cfg.pipeline_depth
    dispatched, out = [], []
    for i, (R, t) in enumerate(poses):
        feats, _ = synthetic.render_features(world, cam, R, t, n_feat=512, seed=50 + i,
                                             stereo=True, device="cpu")
        ret = slam._retire_oldest() if len(slam._pipe) >= depth else None
        if ret is not None:
            out.append((len(out), ret))
        slam._pipeline_track_dispatch(feats, float(times[i]), None)
        dispatched.append(slam._pipe[-1]["res"] is not None)
    while slam._pipe:
        ret = slam._retire_oldest()
        if ret is not None:
            out.append((len(out), ret))
    # frames 0..depth-1 are prepared before the initialization (not
    # dispatched); frame `depth`, the first after it, has no motion model
    # and nothing in flight to chain from
    assert dispatched[:depth + 1] == [False] * (depth + 1)
    assert all(dispatched[depth + 1:])
    assert len(out) == FRAMES
    for i, T in out:
        R, t = poses[i]
        centre = -T[:3, :3].T @ T[:3, 3]
        assert np.linalg.norm(centre - (-R.T @ t)) < 0.02, (i, centre, -R.T @ t)
