"""Tracking robustness of the port on the CPU: the twins of
`tests/test_tracking_robustness.py` (the reference-keyframe fallback, the
NeedNewKeyFrame policy, the IMU pose published while recently lost), run
by the port alone to the JAX test's bars, all 8 cases
(`test_mono_backpressure_blocks_insertion` sets the tracker's
`queue_probe`, the mapping queue's length under asynchronous mapping).

The JAX test runs its 40-frame ring sequence once per case; here it runs
once per module. The keyframe-policy cases change tracker attributes only
through `monkeypatch` (restored after them); the two fallback cases then
track one more frame each, in file order: the motion-model failure is
recovered (the tracker stays OK), then the unseen scene is lost."""

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.frontend.types import empty_features
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.pipeline import tracker as trk
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import synthetic
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()


@pytest.fixture(scope="module")
def ring_run():
    world = synthetic.make_ring_world(5)
    poses = synthetic.circular_trajectory(40, arc=0.5, outward=True)
    cfg = SlamConfig(n_features=512, local_points_cap=2048, local_ba_points=2048,
                     max_frames_between_kf=6, min_init_matches=60)
    slam = SLAM(CAM, cfg, device="cpu")
    for i, (R, t) in enumerate(poses):
        feats, _ = synthetic.render_features(world, CAM, R, t, n_feat=512, seed=777 + i,
                                             device="cpu")
        slam.track_features(feats, i * 0.05)
    return slam, world, poses


def _tracker(sensor=0, **kw):
    return SLAM(CAM, SlamConfig(sensor=sensor, n_features=512, max_frames_between_kf=6, **kw),
                device="cpu").tracker


def test_mono_backpressure_blocks_insertion(ring_run, monkeypatch):
    """Mono never inserts while the mapper's queue is not empty
    (Tracking.cc:3904: mono needs an idle mapper)."""
    slam, _, _ = ring_run
    t = slam.tracker
    ref_matches = int((t.map.kf_feat_mp[t.last_kf] >= 0).sum())
    n_low = max(16, int(0.5 * ref_matches))  # c2 satisfied
    monkeypatch.setattr(t, "frames_since_kf", 10)  # c1a satisfied
    monkeypatch.setattr(t, "queue_probe", lambda: 0)
    assert t._need_new_kf(n_low, timestamp=100.0)
    monkeypatch.setattr(t, "queue_probe", lambda: 2)
    assert not t._need_new_kf(n_low, timestamp=100.0)


def test_busy_mapper_holds_mono_and_interrupts_its_ba(ring_run, monkeypatch):
    """A keyframe being mapped makes the mapper busy (AcceptKeyFrames):
    mono inserts none and interrupts the local BA, stereo inserts while
    fewer than 3 wait (Tracking.cc:3896-3910)."""
    slam, _, _ = ring_run
    t = slam.tracker
    ref_matches = int((t.map.kf_feat_mp[t.last_kf] >= 0).sum())
    n_low = max(16, int(0.5 * ref_matches))
    interrupts = []
    monkeypatch.setattr(t, "frames_since_kf", 10)
    monkeypatch.setattr(t, "queue_probe", lambda: 0)
    monkeypatch.setattr(t, "interrupt_ba", lambda: interrupts.append(1))
    monkeypatch.setattr(t, "mapper_busy", lambda: False)
    assert t._need_new_kf(n_low, timestamp=100.0) and not interrupts
    monkeypatch.setattr(t, "mapper_busy", lambda: True)
    assert not t._need_new_kf(n_low, timestamp=100.0) and interrupts == [1]
    monkeypatch.setattr(t.cfg, "sensor", 1)  # stereo
    assert t._need_new_kf(n_low, timestamp=100.0, n_close_untracked=80)
    monkeypatch.setattr(t, "queue_probe", lambda: 3)
    assert not t._need_new_kf(n_low, timestamp=100.0, n_close_untracked=80)


def test_no_insert_right_after_reloc(ring_run, monkeypatch):
    slam, _, _ = ring_run
    t = slam.tracker
    if len(t.map.kf_ids()) <= t.cfg.max_frames_between_kf:
        pytest.skip("map smaller than mMaxFrames; gate vacuous here")
    monkeypatch.setattr(t, "frames_since_kf", 10)
    monkeypatch.setattr(t, "last_reloc_frame", t.frame_id - 1)
    assert not t._need_new_kf(30, timestamp=100.0)


def test_stereo_close_point_deficit_forces_kf(ring_run, monkeypatch):
    """c1c (Tracking.cc:3774): a deficit of tracked close points with many
    untracked close features forces a keyframe before c1a has elapsed."""
    slam, _, _ = ring_run
    t = slam.tracker
    monkeypatch.setattr(t, "cfg", type(t.cfg)(**{**t.cfg.__dict__, "sensor": 1}))  # STEREO
    monkeypatch.setattr(t, "frames_since_kf", 1)
    ref_matches = int((t.map.kf_feat_mp[t.last_kf] >= 0).sum())
    n_inl = max(16, int(0.5 * ref_matches))
    assert t._need_new_kf(n_inl, timestamp=100.0, n_close_tracked=20, n_close_untracked=120)
    # a healthy census, c1a not elapsed: no keyframe
    assert not t._need_new_kf(max(16, int(0.95 * ref_matches)), timestamp=100.0,
                              n_close_tracked=200, n_close_untracked=0)


def test_inertial_cadence_pre_init():
    """Before the IMU init an inertial rig inserts a keyframe every 0.25 s
    whatever the visual conditions (Tracking.cc:3733)."""
    t = _tracker(sensor=3)
    t.last_kf_time = 10.0
    assert not t._need_new_kf(200, timestamp=10.2)
    assert t._need_new_kf(200, timestamp=10.3)


def test_inertial_c3_half_second():
    """After the IMU init, >= 0.5 s since the last keyframe inserts one
    (c3)."""
    t = _tracker(sensor=3)
    t.map.map_imu_init[t.map.active_map] = True
    t.last_kf = 0
    t.map.kf_valid[0] = True
    t.last_kf_time = 10.0
    t.frames_since_kf = 1
    assert not t._need_new_kf(500, timestamp=10.3)
    assert t._need_new_kf(500, timestamp=10.6)


def test_publishes_imu_pose_while_recently_lost():
    """With the IMU initialized, a failed visual track still returns the
    IMU-predicted pose and records the frame as tracked
    (Tracking.cc:2256-2272)."""
    t = _tracker(sensor=3)
    t.state = trk.OK
    t.last_kf = 0
    t.map.kf_valid[0] = True
    t.map.kf_R[0] = np.eye(3, dtype=np.float32)
    t.map.kf_t[0] = np.zeros(3, np.float32)
    t.map.map_imu_init[t.map.active_map] = True
    t.last_R = np.eye(3, dtype=np.float32)
    t.last_t = np.zeros(3, np.float32)
    t.last_time = 1.0
    pred_t = np.array([0.1, 0.0, 0.0], np.float32)
    t._last_prediction = (np.eye(3, dtype=np.float32), pred_t)
    t._imu_ready = lambda: True
    t._track_frame = lambda feats, ts: False
    pose = t.track(empty_features(512, device="cpu"), 1.05)
    assert pose is not None
    assert t.state == trk.RECENTLY_LOST
    np.testing.assert_allclose(pose[:3, 3], pred_t, atol=1e-6)
    assert not t.records[-1].lost


def test_survives_motion_model_failure(ring_run):
    """A corrupted velocity makes the projection track fail; the BoW
    fallback against the reference keyframe recovers the pose in the same
    frame (Tracking.cc:2210)."""
    slam, world, poses = ring_run
    t = slam.tracker
    assert t.state == trk.OK
    true_R, true_t = t.last_R.copy(), t.last_t.copy()
    bad = np.eye(4, dtype=np.float32)
    bad[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    bad[:3, 3] = [5.0, 5.0, 5.0]
    t.velocity = bad
    n = len(poses)
    feats, _ = synthetic.render_features(world, CAM, *poses[n - 1], n_feat=512, seed=4242,
                                         device="cpu")
    pose = slam.track_features(feats, n * 0.05)
    assert pose is not None
    assert t.state == trk.OK
    c_rec = -pose[:3, :3].T @ pose[:3, 3]
    assert np.linalg.norm(c_rec - (-true_R.T @ true_t)) < 0.5


def test_fallback_declines_on_unseen_scene(ring_run):
    """Features that match nothing in the reference keyframe are not
    rescued: the frame is lost."""
    slam, world, poses = ring_run
    t = slam.tracker
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [9.0, 9.0, 9.0]
    t.velocity = bad
    alien = synthetic.make_ring_world(99)
    feats, _ = synthetic.render_features(alien, CAM, *poses[0], n_feat=512, seed=31337,
                                         device="cpu")
    assert slam.track_features(feats, len(poses) * 0.05) is None
    assert t.state in (trk.RECENTLY_LOST, trk.LOST)
