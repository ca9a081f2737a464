"""Asynchronous mapping in the port, on the CPU: the twin of
`tests/test_async_mapping.py` (40 frames of rendered features through
`SLAM.track_features` with the mapping worker running beside tracking), a
drained twin held against the JAX package, and the worker's wiring.

Bounds: the async run meets the JAX test's bars (> 30 poses, >= 3
keyframes, Sim(3) ATE < 8 cm, `worker_errors == 0`). The drained twin runs
the same frames through both packages with `async_mapping=True` and
`wait_idle()` after every frame, so that each run is deterministic; it is
held to `test_torch_slam.py::test_same_outcome_as_jax`'s tolerance: the same
number of poses, keyframe counts within 2, map points within 20 %, both
ATEs < 5 cm; the JAX tracker runs under `jax_velocity_from_previous_frame`
(ROADMAP C9), as the synchronous twins do.

ROADMAP C14: the JAX package's worker leaves the tracker where it was
after a loop or merge correction, where its synchronous path re-seats it;
the port's tracker follows its reference keyframe's corrected pose at the
next frame (`SLAM._follow_worker`). `test_tracker_follows_a_correction`
shows the fault and the repair on a correction that moves the whole map.
ROADMAP C15: the worker never culls a keyframe made after the one it
processes (`test_worker_never_culls_a_queued_keyframe`). ROADMAP C16: a
frame whose local view the worker made stale is tracked again against the
map of the moment before a keyframe is made from it
(`test_stale_view_is_tracked_again`); keyframes made on
stale views carry few points, the bound there is on their mean point count
against a drained run's.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import system as tsystem
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms
from orb_slam3_comments_ghr_torch.pipeline.tracker import Tracker
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic as tsynthetic
from test_torch_slam import JCAM, TCAM, jax_velocity_from_previous_frame

torch.set_num_threads(1)

N_FRAMES = 40
CFG = dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, min_init_matches=60, async_mapping=True)


def _features(pkg: str, n: int = N_FRAMES):
    """The JAX test's frames: world 71, circular_trajectory(n), seeds
    7200 + i, as each package renders them."""
    world = jsynthetic.make_world(71, n_points=3000)
    tworld = tsynthetic.World(**dataclasses.asdict(world))
    for i, (R, t) in enumerate(jsynthetic.circular_trajectory(n)):
        if pkg == "torch":
            yield tsynthetic.render_features(tworld, TCAM, R, t, n_feat=512, seed=7200 + i,
                                             device="cpu")[0]
        else:
            yield jsynthetic.render_features(world, JCAM, R, t, n_feat=512, seed=7200 + i)[0]


def run(pkg: str, drained: bool, n: int = N_FRAMES, slam=None):
    """(slam, per-frame estimates, ground truth); `drained` waits for the
    worker after every frame."""
    if slam is None:
        slam = (tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu") if pkg == "torch"
                else jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG)))
    est = []
    for i, feats in enumerate(_features(pkg, n)):
        pose = slam.track_features(feats, i * 0.05)
        if drained:
            slam.wait_idle()
        if pose is not None:
            est.append((i * 0.05, pose))
    slam.wait_idle()
    return slam, est, jsynthetic.gt_trajectory(jsynthetic.circular_trajectory(n))


@pytest.fixture(scope="module")
def async_run():
    return run("torch", drained=False)


@pytest.fixture(scope="module")
def drained_runs():
    with jax_velocity_from_previous_frame():
        jax_run = run("jax", drained=True)
    return run("torch", drained=True), jax_run


def test_e2e_async(async_run):
    slam, est, gt = async_run
    assert slam.worker_errors == 0
    assert slam.state in ("OK", "RECENTLY_LOST")
    assert len(est) > 30
    assert slam.n_keyframes() >= 3
    rmse = evaluation.ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.08, rmse


def test_drained_same_outcome_as_jax(drained_runs):
    (ts, test, gt), (js, jest, _) = drained_runs
    assert ts.worker_errors == 0 and js.worker_errors == 0
    assert len(test) == len(jest)
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 2
    assert abs(ts.n_map_points() - js.n_map_points()) <= 0.2 * js.n_map_points()
    assert evaluation.ate_rmse(test, gt) < 0.05
    assert evaluation.ate_rmse(jest, gt) < 0.05


def test_queue_is_unbounded_and_probed(async_run):
    """The reference's mlNewKeyFrames is unbounded: tracking never blocks in
    put(); the tracker's and the mapper's probes read its length."""
    slam = async_run[0]
    assert slam._map_queue.maxsize == 0
    assert slam.tracker.queue_probe is not None and slam.mapper.queue_probe is not None
    assert slam.tracker.queue_probe() == 0  # drained
    assert slam.mapper.share_stream


def _threads_holding(obj) -> list:
    return [t for t in threading.enumerate() if any(a is obj for a in getattr(t, "_args", ()))]


def test_reset_and_load_atlas_rewire_the_worker(tmp_path):
    """reset() and load_atlas() with keyframes still queued: the old
    session's worker is drained and stopped, and no thread refers to the
    old mapper; a new worker serves the new session."""
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    feats = list(_features("torch", 16))
    for i, f in enumerate(feats[:12]):
        slam.track_features(f, i * 0.05)
    slam.wait_idle()
    slam.save_atlas(str(tmp_path / "atlas.npz"))
    for i, f in enumerate(feats[12:], 12):
        slam.track_features(f, i * 0.05)  # keyframes may still be queued
    for change in (slam.reset, lambda: slam.load_atlas(str(tmp_path / "atlas.npz"))):
        old_mapper, old_worker = slam.mapper, slam._map_worker
        change()
        assert not old_worker.is_alive()
        assert _threads_holding(old_mapper) == []
        assert _threads_holding(slam.mapper) == [slam._map_worker]
        assert slam._map_worker.is_alive() and slam.mapper.queue_probe == slam._map_queue.qsize
        for i, f in enumerate(feats[:6]):
            slam.track_features(f, 10.0 + i * 0.05)
    slam.wait_idle()
    assert slam.worker_errors == 0


def test_n_map_resets_counts_as_jax():
    ts = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    js = jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG))
    assert ts.n_map_resets == 0
    for _ in range(2):
        ts.reset_active_map()
        js.reset_active_map()
    assert ts.n_map_resets == js.n_map_resets == 2


def _roll_about_z(deg: float) -> np.ndarray:
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32)


def _correcting_run(monkeypatch, follow: bool, at_frame: int = 24):
    """A drained async run whose loop closer, at the first keyframe from
    `at_frame` on, moves the whole active map as a correction would (4
    degrees about z and 0.2 m) and reports a correction. The images do not
    change, so the map stays consistent with them in its new world. With
    `follow=False` the tracker ignores the correction, as the JAX package's
    worker leaves it. Returns (slam, estimates, ground truth, the frame of
    the correction, the frames that fell back to the reference keyframe)."""
    if not follow:
        def transform_only(self):
            self._corrected = False
            moved = self.mapper.take_world_transform()
            if moved is not None:
                self.tracker.apply_world_transform(*moved)

        monkeypatch.setattr(tsystem.SLAM, "_follow_worker", transform_only)
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    corrected, fallbacks = [], []
    process = slam.loopcloser.process_keyframe

    def correcting(kf):
        if not corrected and slam.tracker.frame_id >= at_frame:
            m = slam.map
            m.apply_transform(m.active_map, 1.0, _roll_about_z(4.0),
                              np.array([0.2, 0.05, 0.0], np.float32))
            corrected.append(slam.tracker.frame_id)
            return True
        return process(kf)

    track_ref = slam.tracker._track_reference_kf

    def counted(feats):
        fallbacks.append(slam.tracker.frame_id)
        return track_ref(feats)

    slam.loopcloser.process_keyframe = correcting
    slam.tracker._track_reference_kf = counted
    slam, est, gt = run("torch", drained=True, slam=slam)
    assert corrected, "no keyframe came after the correction frame"
    return slam, est, gt, corrected[0], fallbacks


def test_tracker_follows_a_correction(monkeypatch):
    slam, est, gt, at, fallbacks = _correcting_run(monkeypatch, follow=True)
    assert slam.worker_errors == 0
    assert [f for f in fallbacks if f > at] == [], fallbacks
    assert len(est) > 30
    assert evaluation.ate_rmse(slam.trajectory(), gt, with_scale=True) < 0.05
    # the JAX package's worker: the frame after the correction searches
    # around the uncorrected pose, misses, and falls back
    _, _, _, at, fallbacks = _correcting_run(monkeypatch, follow=False)
    assert at + 1 in fallbacks, (at, fallbacks)


def test_worker_never_culls_a_queued_keyframe():
    """ROADMAP C15: the tracker associates a new keyframe with its tracked
    points when it makes it, so a keyframe still waiting in the queue is
    already covisible with the one the worker processes, and redundant. The
    JAX package's culling takes it (with the worker running, the tracker's
    own reference keyframe: it then inserts none and loses the map); the
    port culls only keyframes older than the one it processes. On the noisy
    map of `test_torch_global_ba.py` (every point seen by 4 of 24
    keyframes, so most keyframes are redundant) it still culls older
    ones."""
    from test_torch_global_ba import both_maps

    m, mapper, tm, tmp, kfs = both_maps(4)
    tmp.queue_probe = lambda: 1  # as the worker's mapper has it
    kf = kfs[12]
    mapper.cull_keyframes(kf)
    tmp.cull_keyframes(kf)
    newer = [k for k in kfs if k > kf]
    assert not m.kf_valid[newer].all()  # the JAX package culls newer keyframes
    assert tm.kf_valid[newer].all()
    assert not tm.kf_valid[[k for k in kfs if k < kf]].all()


def _keyframe_points(stale: bool) -> list[int]:
    """Phase 10 (a)'s first 24 frames of ring-world features through an
    asynchronous SLAM whose worker is stood in for on this thread, so that
    the run is deterministic: each keyframe is mapped after the next frame's
    local view was taken and before that frame is tracked on it (`stale`:
    as the worker does while the card extracts the frame's features), or
    before the view is taken (as a drained run). Returns the points each
    keyframe the tracker made held when it was made."""
    world = tsynthetic.make_ring_world(13)
    poses = tsynthetic.circular_trajectory(160, arc=1.06, outward=True)[:24]
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(
        n_features=512, local_points_cap=2048, local_ba_points=2048, min_init_matches=60,
        max_frames_between_kf=5, async_mapping=True), device="cpu")
    t, waiting, held = slam.tracker, [], []
    slam._map_queue.put = lambda item: waiting.append(item[0])
    make = t._create_new_kf

    def counted(*args):
        make(*args)
        held.append(int((slam.map.kf_feat_mp[t.last_kf] >= 0).sum()))

    def map_waiting():
        while waiting:
            slam.mapper.process_keyframe(waiting.pop(0))

    t._create_new_kf = counted
    for i, (R, tw) in enumerate(poses):
        feats = tsynthetic.render_features(world, TCAM, R, tw, n_feat=512, seed=1300 + i,
                                           noise_px=0.7, device="cpu")[0]
        if not stale:
            map_waiting()
        ready, lp, _, R0, t0 = t.prepare_frame(i * 0.05)
        map_waiting()
        pre = ((tprograms.track_against_points(
            slam.geom_cam, feats, lp, R0, t0, th=t._prepared_th, n_levels=slam.cfg.n_levels,
            scale=slam.cfg.scale_factor),) if ready else None)
        slam.track_features(feats, i * 0.05, precomputed=pre)
    return held


def test_stale_view_is_tracked_again(monkeypatch):
    """ROADMAP C16. With the repair the keyframes made after stale views
    hold as many points as a drained run's (mean >= 85 %: 265 against 279
    on these frames); without it (each frame kept on its stale view, as the
    JAX package keeps it) their points decay keyframe after keyframe (mean
    <= 75 %: 193), which in a longer run stops keyframe insertion."""
    mean = lambda held: float(np.mean(held[1:]))  # the init's second keyframe apart
    drained = mean(_keyframe_points(stale=False))
    assert mean(_keyframe_points(stale=True)) >= 0.85 * drained
    monkeypatch.setattr(Tracker, "_track_again", lambda self, feats: None)
    assert mean(_keyframe_points(stale=True)) <= 0.75 * drained
