"""Monocular SLAM end to end through the port, on the CPU: the twin of
`tests/test_e2e_mono.py` (40 frames of rendered synthetic features through
`SLAM.track_features`, loop closing off), held against the JAX package on
the same frames; relocalization and the reference-keyframe fallback on the
same map in both packages; exports, modes and the device rules.

Bounds: the two packages draw their RANSAC sets from different generators
and sum in another order, so the runs are compared by outcome: both track
every frame after init, ATE < 5 cm, keyframe counts within 2, map points
within 20 %. On one shared map, relocalization picks the same keyframe and
lands within 1 cm / 0.5 degree of the JAX pose. The JAX run's tracker
takes its velocity after a fallback as the port does (ROADMAP C9,
`jax_velocity_from_previous_frame`)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
from orb_slam3_comments_ghr_tpu.retrieval import database as jdatabase, vocabulary as jvocabulary
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper, tracker as ttracker
from orb_slam3_comments_ghr_torch.retrieval import database as tdatabase, vocabulary as tvocabulary
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic as tsynthetic

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
@contextlib.contextmanager
def jax_velocity_from_previous_frame():
    """The JAX tracker with the port's repair of ROADMAP C9: after the
    reference-keyframe fallback, the constant-velocity model and the body
    velocity are taken against the previous frame's pose, not against the
    pose the fallback just wrote. The JAX `_track_frame` reads last_R /
    last_t after the fallback's re-track; this puts the previous frame's
    pose back for that read (the re-track has taken its start by then), and
    restores the fallback's pose if the re-track then fails, as the port
    keeps it."""
    track_ref, track_frame = jtracker.Tracker._track_reference_kf, jtracker.Tracker._track_frame
    track_against_points = jtracker.programs.track_against_points
    swap = []

    def fallback(self, feats):
        entry = (self.last_R.copy(), self.last_t.copy())
        ok = track_ref(self, feats)
        if ok:
            swap.append((self, entry, (self.last_R, self.last_t)))
        return ok

    def retrack(*args, **kwargs):
        res = track_against_points(*args, **kwargs)
        if swap:
            trk, entry, _ = swap[-1]
            trk.last_R, trk.last_t = entry
        return res

    def frame(self, feats, timestamp):
        try:
            return track_frame(self, feats, timestamp)
        finally:
            if swap:
                _, entry, found = swap.pop()
                if self.last_R is entry[0]:  # the re-track failed
                    self.last_R, self.last_t = found

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker.Tracker, "_track_reference_kf", fallback)
        mp.setattr(jtracker.Tracker, "_track_frame", frame)
        mp.setattr(jtracker.programs, "track_against_points", retrack)
        yield


TVOC = tsystem.os.path.join(tsystem.os.path.dirname(tsystem.__file__), "retrieval", "default_voc.npz")
CFG = dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, min_init_matches=60, enable_loop_closing=False)


def run(pkg, n_frames=40, seed=3):
    """(slam, per-frame estimates, ground truth) of one package."""
    world = jsynthetic.make_world(seed, n_points=3000)
    poses = jsynthetic.circular_trajectory(n_frames)
    if pkg == "torch":
        slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    else:
        slam = jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG))
    est = []
    for i, (R, t) in enumerate(poses):
        if pkg == "torch":
            feats, _ = tsynthetic.render_features(
                tsynthetic.World(**dataclasses.asdict(world)), TCAM, R, t, n_feat=512,
                seed=seed * 1000 + i, device="cpu")
        else:
            feats, _ = jsynthetic.render_features(world, JCAM, R, t, n_feat=512, seed=seed * 1000 + i)
        pose = slam.track_features(feats, i * 0.05)
        if pose is not None:
            est.append((i * 0.05, pose))
    return slam, est, jsynthetic.gt_trajectory(poses)


@pytest.fixture(scope="module")
def seq():
    return run("torch")


@pytest.fixture(scope="module")
def jax_seq():
    with jax_velocity_from_previous_frame():
        return run("jax")


def test_initializes_and_tracks(seq):
    slam, est, _ = seq
    assert slam.state == "OK"
    assert len(est) > 30


def test_builds_map(seq):
    slam, _, _ = seq
    assert slam.n_keyframes() >= 3
    assert slam.n_map_points() > 200


def test_ate_under_threshold(seq):
    _, est, gt = seq
    rmse = evaluation.ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.05, f"ATE {rmse:.4f} m"
    slam = seq[0]
    assert evaluation.ate_rmse(slam.trajectory(), gt, with_scale=True) < 0.05


def test_same_outcome_as_jax(seq, jax_seq):
    (ts, test, gt), (js, jest, _) = seq, jax_seq
    assert len(test) == len(jest)
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 2
    assert abs(ts.n_map_points() - js.n_map_points()) <= 0.2 * js.n_map_points()
    assert evaluation.ate_rmse(jest, gt) < 0.05


def test_trajectory_exports(seq, tmp_path):
    slam, _, _ = seq
    slam.save_trajectory_tum(str(tmp_path / "tum.txt"))
    lines = (tmp_path / "tum.txt").read_text().strip().splitlines()
    assert len(lines) > 30 and len(lines[0].split()) == 8
    q = np.array([float(x) for x in lines[5].split()[4:]])
    assert abs(np.linalg.norm(q) - 1.0) < 1e-5
    slam.save_trajectory_euroc(str(tmp_path / "euroc.txt"))
    first = (tmp_path / "euroc.txt").read_text().split()
    assert first[0].isdigit() and np.allclose([float(x) for x in first[1:4]], [float(x) for x in lines[0].split()[1:4]])
    slam.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    row = np.array([float(x) for x in (tmp_path / "kitti.txt").read_text().splitlines()[0].split()])
    assert row.shape == (12,)
    np.testing.assert_allclose(row.reshape(3, 4), np.linalg.inv(slam.trajectory()[0][1])[:3], atol=1e-6)
    slam.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    assert len((tmp_path / "kf.txt").read_text().splitlines()) == slam.n_keyframes()


def _shared_map(slam):
    """The port SLAM's map, and a JAX MapState with the same arrays."""
    arrays = convert.map_state_to_numpy(slam.map)
    jm = jstate.MapState(jstate.MapConfig(**arrays["cfg"]))
    for k, v in arrays.items():
        if k != "cfg":
            setattr(jm, k, v.copy() if isinstance(v, np.ndarray) else type(v)(v))
    return convert.map_state_from_numpy(arrays), jm


def _trackers(slam):
    tm, jm = _shared_map(slam)
    tvoc = slam.voc
    jvoc = jvocabulary.Vocabulary.load(tsystem.os.path.join(
        tsystem.os.path.dirname(jsystem.__file__), "retrieval", "default_voc.npz"))
    tdb, jdb = tdatabase.KeyFrameDatabase(tvoc, 64), jdatabase.KeyFrameDatabase(jvoc, 64)
    for kf in tm.kf_ids():
        tdb.add(int(kf), tm.kf_feat_desc[kf], tm.kf_feat_valid[kf])
        jdb.add(int(kf), jm.kf_feat_desc[kf], jm.kf_feat_valid[kf])
    cfg = tconfig.SlamConfig(**CFG)
    tt = ttracker.Tracker(TCAM, cfg, tm, kfdb=tdb, device="cpu")
    jt = jtracker.Tracker(JCAM, jconfig.SlamConfig(**CFG), jm, kfdb=jdb)
    return tt, jt


def _query(frame, seed=77):
    world = jsynthetic.make_world(3, n_points=3000)
    R, t = jsynthetic.circular_trajectory(40)[frame]
    jf, _ = jsynthetic.render_features(world, JCAM, R, t, n_feat=512, seed=seed)
    tf = convert.features_from_numpy({k: np.asarray(v) for k, v in jf._asdict().items()}, device="cpu")
    return jf, tf


def _pose_close(tt, jt):
    dR = tt.last_R @ np.asarray(jt.last_R).T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    c_t = -tt.last_R.T @ tt.last_t
    c_j = -np.asarray(jt.last_R).T @ np.asarray(jt.last_t)
    return np.linalg.norm(c_t - c_j), ang


def test_relocalization_matches_jax(seq):
    slam, _, _ = seq
    tt, jt = _trackers(slam)
    jf, tf = _query(23)
    assert tt._relocalize(tf) and jt._relocalize(jf)
    assert tt.last_kf == jt.last_kf
    dc, ang = _pose_close(tt, jt)
    assert dc < 0.01 and ang < 0.5, (dc, ang)


def test_reference_keyframe_fallback_matches_jax(seq):
    slam, _, _ = seq
    tt, jt = _trackers(slam)
    kf = int(slam.map.kf_ids()[-1])
    for t in (tt, jt):
        t.last_kf = kf
        t.last_R = slam.map.kf_R[kf].copy()
        t.last_t = slam.map.kf_t[kf].copy()
    jf, tf = _query(int(np.argmin(np.abs(np.arange(40) * 0.05 - slam.map.kf_time[kf]))) + 1, seed=78)
    assert tt._track_reference_kf(tf) and jt._track_reference_kf(jf)
    dc, ang = _pose_close(tt, jt)
    assert dc < 0.01 and ang < 0.5, (dc, ang)


def test_localization_mode_and_resets():
    slam, _, _ = run("torch", n_frames=14)
    n_kf = slam.n_keyframes()
    world = tsynthetic.make_world(3, n_points=3000)
    poses = tsynthetic.circular_trajectory(40)
    slam.activate_localization_mode()
    for i in range(14, 24):
        feats, _ = tsynthetic.render_features(world, TCAM, *poses[i], n_feat=512, seed=i, device="cpu")
        assert slam.track_features(feats, i * 0.05) is not None
    assert slam.n_keyframes() == n_kf
    slam.deactivate_localization_mode()
    slam.reset_active_map()
    assert slam.state == "NOT_INITIALIZED" and slam.n_keyframes() == 0 and slam.n_map_points() == 0
    slam.reset()
    assert slam.state == "NO_IMAGES_YET" and slam.tracker.records == []


def test_runs_on_the_card_unless_told_otherwise(monkeypatch):
    cfg = tconfig.SlamConfig(enable_loop_closing=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.SLAM(TCAM, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.SLAM(TCAM, cfg, device="cuda")
    assert tsystem.SLAM(TCAM, cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("part", ["tracker", "mapper", "vocabulary"])
def test_parts_run_on_the_card_unless_told_otherwise(monkeypatch, part):
    """The tracker, the mapper and the vocabulary, built on their own, also
    take the card by default and raise without one."""
    cfg = tconfig.SlamConfig(enable_loop_closing=False)
    make = {
        "tracker": lambda **kw: ttracker.Tracker(TCAM, cfg, tstate.MapState(tstate.MapConfig()), **kw),
        "mapper": lambda **kw: tmapper.LocalMapper(TCAM, cfg, tstate.MapState(tstate.MapConfig()), **kw),
        "vocabulary": lambda **kw: tvocabulary.Vocabulary.load(str(TVOC), **kw),
    }[part]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(device="cuda")
    assert make(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("change", [
    {"async_mapping": True},
    {"dba_devices": 2},  # refused until ROADMAP A8 was ported
])
def test_unported_options_raise(change):
    """Both options were refused until their slices came. Distributed BA is
    ported (A8): a SLAM with dba_devices builds, and in one process has no
    ranks to shard over, so its whole-map BA takes the single-device path,
    as the JAX package does on one device. Async mapping is ported (A9): a
    SLAM with it builds its worker thread and unbounded keyframe queue."""
    cfg = dataclasses.replace(tconfig.SlamConfig(enable_loop_closing=False), **change)
    if cfg.dba_devices:
        assert tsystem.SLAM(TCAM, cfg, device="cpu").mapper._dba_mesh() is None
        return
    slam = tsystem.SLAM(TCAM, cfg, device="cpu")
    assert slam._map_worker.is_alive() and slam._map_queue.maxsize == 0
    slam.shutdown()
    assert slam.worker_errors == 0


@pytest.mark.parametrize("sensor", [tconfig.IMU_MONOCULAR, tconfig.IMU_STEREO])
def test_inertial_sensor_with_loop_closing_tracks(sensor):
    """An inertial sensor with loop closing on (the default SlamConfig)
    builds and tracks: the inertial loop closer is ported (ROADMAP A6.3)."""
    cfg = tconfig.SlamConfig(sensor=sensor, n_features=512)
    assert cfg.enable_loop_closing
    slam = tsystem.SLAM(TCAM, cfg, device="cpu")
    world = tsynthetic.make_world(3, n_points=3000)
    R, t = tsynthetic.circular_trajectory(40)[0]
    feats, _ = tsynthetic.render_features(world, TCAM, R, t, n_feat=512, seed=3000,
                                          stereo=sensor == tconfig.IMU_STEREO, device="cpu")
    slam.feed_imu(np.array([[0.0, 0.0, 0.0, 9.81, 0.0, 0.0, 0.0]]))
    slam.track_features(feats, 0.0)
    if sensor == tconfig.IMU_STEREO:  # depth-seeded: a map from the first frame
        assert slam.state == "OK" and slam.n_keyframes() == 1
    assert slam.loopcloser.mapper is slam.mapper


def test_unported_entry_points_raise(tmp_path):
    cfg = tconfig.SlamConfig(enable_loop_closing=False)
    # a KB8 camera was refused until the fisheye slice (ROADMAP A7); now
    # its geometry runs on the virtual pinhole
    fisheye = dataclasses.replace(TCAM, kind=tcameras.KANNALA_BRANDT8, k1=0.01)
    assert tsystem.SLAM(fisheye, cfg, device="cpu").geom_cam.kind == tcameras.PINHOLE
    slam = tsystem.SLAM(TCAM, cfg, device="cpu")
    # IMU samples need an IMU_* sensor (the JAX package's feed_imu)
    with pytest.raises(RuntimeError, match="IMU"):
        slam.track_monocular(np.zeros((480, 752), np.uint8), 0.0, imu_samples=np.zeros((1, 7)))
    # atlas files were refused until ROADMAP A9 was ported; now an empty map
    # goes through save_atlas, shutdown(atlas_path) and load_atlas
    slam.save_atlas(str(tmp_path / "a.npz"))
    slam.shutdown(str(tmp_path / "b.npz"))
    with np.load(str(tmp_path / "a.npz")) as a, np.load(str(tmp_path / "b.npz")) as b:
        assert set(a.files) == set(b.files) and str(a["__meta__"]) == str(b["__meta__"])
    slam.load_atlas(str(tmp_path / "a.npz"))
    assert slam.map.n_maps == 2 and slam.map.active_map == 1 and slam.state == "NO_IMAGES_YET"
