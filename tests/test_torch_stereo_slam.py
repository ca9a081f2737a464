"""Stereo SLAM end to end through the port, on the CPU, against the JAX
package:
- the twin of `tests/test_stereo.TestStereoPipeline`: 30 frames of rendered
  stereo features (`render_features(stereo=True)`) through
  `SLAM.track_features`, loop closing off, in both packages;
- the same on an outward arc through a ring of landmarks, where every
  heading sees new structure, so keyframes and mapping must follow;
- the tracker alone: the map that `_initialize_stereo` seeds from depth, the
  close-point census and `_need_new_kf` on stereo inputs;
- one `process_keyframe` on a stereo map;
- `SLAM.track_stereo` and `track_rgbd` on images.
The image-mode RGB-D twin of `tests/test_rgbd.py` is
`tests/test_torch_rgbd_slam.py`.

One difference is deliberate. The JAX map counts every observation once,
where the reference's MapPoint::Observations() counts a stereo one twice;
so in the JAX package the points of a stereo keyframe seen by no other
keyframe never count as tracked by it, and a map whose points all lie
beyond ThDepth (as here) never inserts a keyframe after its first
(`test_jax_package_never_counts_a_lone_stereo_view`). The port counts the
reference's way in its keyframe decision. The comparisons run the JAX
tracker with the same count (`_jax_counts_stereo_twice`, computed here on
its own).

Bounds: the initial map is seeded by the same numpy code from the same
features, so it is bit-equal. The census is integer, so equal; the keyframe
decision is equal on every input. Runs are compared by outcome, since the
pose and BA LMs sum in another order than XLA (float32): the same tracked
count, keyframe counts within 1, metric ATE (no scale fit) < 6 cm in both
and within 5 mm of each other. One `process_keyframe` on the same map: the
same keyframes kept, map points within 2 %, keyframe centres within 1 mm and
rotations within 0.05 degree of JAX's."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import mapper as jmapper, tracker as jtracker
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper, programs as tprograms
from orb_slam3_comments_ghr_torch.pipeline import tracker as ttracker
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation, synthetic as tsynthetic

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
CFG = dict(sensor=tconfig.STEREO, n_features=512, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=8, enable_loop_closing=False)
ATE_GAP = 0.005
KF_TO_SNAPSHOT = 3  # the process_keyframe call whose input map is kept
# the twin of test_stereo: a box of landmarks ahead of a 30-frame arc
BOX = dict(world=lambda: jsynthetic.make_world(21, n_points=3000),
           poses=lambda: jsynthetic.circular_trajectory(30))
# an outward arc through a ring of landmarks: 30 frames over 0.225 turns
RING = dict(world=lambda: jsynthetic.make_ring_world(17),
            poses=lambda: jsynthetic.circular_trajectory(30, outward=True, arc=0.225))


def _stereo_weighted_n_obs(m):
    """Each point's observations, a stereo one (its feature has a right
    coordinate) counted twice (MapPoint::AddObservation)."""
    kf, fi = m.mp_obs_kf, m.mp_obs_idx
    ur = m.kf_feat_ur[np.clip(kf, 0, None), np.clip(fi, 0, None)]
    return m.mp_n_obs + ((kf >= 0) & (fi >= 0) & (ur >= 0)).sum(axis=1).astype(np.int32)


@contextlib.contextmanager
def _jax_counts_stereo_twice():
    """The JAX tracker's keyframe decision with the reference's count of
    stereo observations."""
    need_new_kf = jtracker.Tracker._need_new_kf

    def patched(self, *args, **kwargs):
        saved = self.map.mp_n_obs
        self.map.mp_n_obs = _stereo_weighted_n_obs(self.map)
        try:
            return need_new_kf(self, *args, **kwargs)
        finally:
            self.map.mp_n_obs = saved

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker.Tracker, "_need_new_kf", patched)
        yield


def _stereo_feats(seq: dict, frame: int):
    """(JAX features, port features) of frame `frame` of a sequence."""
    R, t = seq["poses"]()[frame]
    jf, _ = jsynthetic.render_features(seq["world"](), JCAM, R, t, n_feat=512, seed=900 + frame,
                                       stereo=True)
    return jf, convert.features_from_numpy({k: np.asarray(v) for k, v in jf._asdict().items()},
                                           device="cpu")


def _snapshot_before(slam, call: int, box: dict):
    """Keep a copy of the map and of the mapper's young points just before
    the mapper's `call`-th process_keyframe."""
    fn, count = slam.mapper.process_keyframe, [0]

    def wrapped(kf):
        count[0] += 1
        if count[0] == call:
            box.update(kf=kf, map=convert.map_state_to_numpy(slam.map),
                       recent=list(slam.mapper.recent_mps))
        return fn(kf)

    slam.mapper.process_keyframe = wrapped


def _run(pkg: str, seq: dict):
    """(slam, estimates, ground truth, snapshot) of one package's run
    (the snapshot for the port only)."""
    if pkg == "torch":
        slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    else:
        slam = jsystem.SLAM(JCAM, jconfig.SlamConfig(**CFG))
    snap = {}
    if pkg == "torch":
        _snapshot_before(slam, KF_TO_SNAPSHOT, snap)
    world, poses = seq["world"](), seq["poses"]()
    est = []
    for i, (R, t) in enumerate(poses):
        jf, _ = jsynthetic.render_features(world, JCAM, R, t, n_feat=512, seed=900 + i,
                                           stereo=True)
        if pkg == "torch":
            jf = convert.features_from_numpy({k: np.asarray(v) for k, v in jf._asdict().items()},
                                             device="cpu")
        pose = slam.track_features(jf, i * 0.05)
        if pose is not None:
            est.append((i * 0.05, pose))
    return slam, est, jsynthetic.gt_trajectory(poses), snap


def _both(seq):
    with _jax_counts_stereo_twice():
        jax_run = _run("jax", seq)
    return _run("torch", seq), jax_run


@pytest.fixture(scope="module")
def box_runs():
    return _both(BOX)


@pytest.fixture(scope="module")
def ring_runs():
    return _both(RING)


def _assert_same_outcome(runs, min_kfs: int):
    (ts, test, gt, _), (js, jest, _, _) = runs
    assert ts.state == "OK" and js.state == "OK"
    assert len(test) == len(jest) == len(gt)
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    assert ts.n_keyframes() >= min_kfs
    ate_t = evaluation.ate_rmse(test, gt, with_scale=False)  # metric: no scale fit
    ate_j = evaluation.ate_rmse(jest, gt, with_scale=False)
    assert ate_t < 0.06 and ate_j < 0.06, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < ATE_GAP, (ate_t, ate_j)
    assert evaluation.ate_rmse(ts.trajectory(), gt, with_scale=False) < 0.06


def test_stereo_features_twin_of_jax(box_runs):
    _assert_same_outcome(box_runs, min_kfs=1)


def test_stereo_features_outward_arc_matches_jax(ring_runs):
    _assert_same_outcome(ring_runs, min_kfs=3)


def test_jax_package_never_counts_a_lone_stereo_view(ring_runs):
    """The reference fault the port repairs: as the JAX package stands, the
    outward arc keeps its first keyframe and loses tracking."""
    js, est, gt, _ = _run("jax", RING)
    assert js.n_keyframes() == 1 and len(est) < len(gt)
    tt, jt = _trackers()
    jf, tf = _stereo_feats(RING, 0)
    tt.track(tf, 0.0)
    jt.track(jf, 0.0)
    # 150 of the 512 first-keyframe points tracked: under 0.4 of them
    assert tt._need_new_kf(150, 1.0) and not jt._need_new_kf(150, 1.0)


def _trackers(map_arrays=None, **changes):
    """A port tracker and a JAX tracker on the same map (empty, or a copy of
    `map_arrays`), no keyframe database; `changes` to CFG."""
    tcfg, jcfg = tconfig.SlamConfig(**CFG, **changes), jconfig.SlamConfig(**CFG, **changes)
    mc = dict(max_kf=tcfg.max_kf, max_mp=tcfg.max_mp, n_feat=tcfg.n_features,
              obs_cap=tcfg.obs_cap, scale_factor=tcfg.scale_factor, n_levels=tcfg.n_levels)
    if map_arrays is None:
        tm, jm = tstate.MapState(tstate.MapConfig(**mc)), jstate.MapState(jstate.MapConfig(**mc))
    else:
        tm, jm = _maps(map_arrays)
    return (ttracker.Tracker(TCAM, tcfg, tm, device="cpu"),
            jtracker.Tracker(JCAM, jcfg, jm))


def _maps(arrays):
    """A port MapState and a JAX MapState, each with a copy of `arrays`."""
    jm = jstate.MapState(jstate.MapConfig(**arrays["cfg"]))
    for k, v in arrays.items():
        if k != "cfg":
            setattr(jm, k, v.copy() if isinstance(v, np.ndarray) else type(v)(v))
    return convert.map_state_from_numpy(arrays), jm


def _assert_maps_equal(tm, jm):
    at, aj = convert.map_state_to_numpy(tm), convert.map_state_to_numpy(jm)
    assert at.keys() == aj.keys()
    for k in aj:
        if isinstance(aj[k], np.ndarray):
            np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
        else:
            assert at[k] == aj[k], k


def test_initialize_stereo_seeds_the_same_map():
    tt, jt = _trackers()
    jf, tf = _stereo_feats(BOX, 0)
    assert tt.track(tf, 0.0) is not None and jt.track(jf, 0.0) is not None
    assert tt.state == jt.state == ttracker.OK
    n = int(np.asarray(jf.valid).sum())
    assert len(tt.map.mp_ids()) == n > 500  # every keypoint with depth
    _assert_maps_equal(tt.map, jt.map)
    assert tt.pending_kf == jt.pending_kf == 0


def test_initialize_stereo_needs_500_keypoints():
    tt, jt = _trackers()
    jf, tf = _stereo_feats(BOX, 0)
    keep = np.arange(512) < 500
    tf = tf._replace(valid=tf.valid & torch.from_numpy(keep))
    jf = jf._replace(valid=jf.valid & jnp.asarray(keep))
    assert tt.track(tf, 0.0) is None and jt.track(jf, 0.0) is None
    assert tt.state == jt.state == ttracker.NOT_INITIALIZED
    assert tt.map.n_kf == jt.map.n_kf == 0


def _kf_decisions(tt, jt):
    """_need_new_kf of both trackers over a grid of inputs."""
    out = []
    for since in (0, 3, 30):
        for n_inl in (12, 40, 150, 400, 800):
            for n_ct, n_cu in ((50, 100), (150, 100), (50, 50)):
                tt.frames_since_kf = jt.frames_since_kf = since
                with _jax_counts_stereo_twice():
                    decision = jt._need_new_kf(n_inl, 1.0, n_ct, n_cu)
                out.append((tt._need_new_kf(n_inl, 1.0, n_ct, n_cu), decision))
    return out


@pytest.mark.parametrize("map_from", ["init", "run"])
def test_close_point_census_and_kf_decision_match_jax(ring_runs, map_from):
    """On the map of stereo initialization (one keyframe) and on the port's
    outward-arc map before its third mapped keyframe: the close-point
    census of a tracked frame and the keyframe decision on a grid of
    inputs. ThDepth is raised to 100 baselines (11 m; the YAML's
    Stereo.ThDepth), so that the ring's 6-18 m holds close points."""
    if map_from == "init":
        tt, jt = _trackers(depth_th_factor=100.0)
        jf0, tf0 = _stereo_feats(RING, 0)
        tt.track(tf0, 0.0)
        jt.track(jf0, 0.0)
        frame = 1
    else:
        snap = ring_runs[0][3]
        tt, jt = _trackers(snap["map"], depth_th_factor=100.0)
        for t in (tt, jt):
            t.last_kf = snap["kf"]
            t.frame_id = 100
        frame = int(round(snap["map"]["kf_time"][snap["kf"]] / 0.05))
    jf, tf = _stereo_feats(RING, frame)
    lp, ids = tt._local_points_view()
    # the true pose in the map's frame (the first camera's) as the prior
    (R0, t0), (R, t) = RING["poses"]()[0], RING["poses"]()[frame]
    R, t = R @ R0.T, t - R @ R0.T @ t0
    res, close = ttracker._fetch_track(
        tprograms.track_against_points(TCAM, tf, lp, torch.from_numpy(R), torch.from_numpy(t)),
        tt._close_features(tf))
    census = tt._close_point_counts(close, res, ids)
    assert census == jt._close_point_counts(jf, res, ids)
    assert res.n_inliers > 100 and census[0] > 0 and census[1] > 0
    decisions = _kf_decisions(tt, jt)
    assert all(a == b for a, b in decisions), decisions
    assert any(a for a, _ in decisions) and not all(a for a, _ in decisions)


def test_process_keyframe_on_a_stereo_map_matches_jax(ring_runs):
    snap = ring_runs[0][3]
    kf = snap["kf"]
    tm, jm = _maps(snap["map"])
    tcfg, jcfg = tconfig.SlamConfig(**CFG), jconfig.SlamConfig(**CFG)
    tmap = tmapper.LocalMapper(TCAM, tcfg, tm, device="cpu")
    jmap = jmapper.LocalMapper(JCAM, jcfg, jm)
    tmap.recent_mps, jmap.recent_mps = list(snap["recent"]), list(snap["recent"])
    assert len(tm.kf_ids()) > 2  # so the local BA runs
    tmap.process_keyframe(kf)
    jmap.process_keyframe(kf)
    np.testing.assert_array_equal(tm.kf_valid, jm.kf_valid)
    n_t, n_j = len(tm.mp_ids()), len(jm.mp_ids())
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert n_t > len(np.nonzero(snap["map"]["mp_valid"])[0])  # new points were made
    for k in tm.kf_ids():
        R_t, R_j = tm.kf_R[k].astype(np.float64), jm.kf_R[k].astype(np.float64)
        assert np.linalg.norm(R_t.T @ tm.kf_t[k] - R_j.T @ jm.kf_t[k]) < 1e-3, k
        # the angle of R_t R_j^T from its antisymmetric part: exact for
        # small angles, where arccos of the trace loses float precision
        A = R_t @ R_j.T
        w = np.array([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0], A[1, 0] - A[0, 1]]) / 2
        assert np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))) < 0.05, k


def test_stereo_and_rgbd_entry_points_run():
    """`track_stereo` on a rendered rectified pair initializes from depth on
    its first frame; `track_rgbd` does the same from a depth map."""
    scene = tsynthetic.make_textured_scene(7)
    R, t = tsynthetic.circular_trajectory(300)[0]
    b = TCAM.bf / TCAM.fx
    u8 = lambda a: np.clip(np.round(a), 0, 255).astype(np.uint8)
    img_l = u8(tsynthetic.render_image(scene, TCAM, R, t))
    img_r = u8(tsynthetic.render_image(scene, TCAM, R, t - np.array([b, 0.0, 0.0], np.float32)))
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**CFG), device="cpu")
    assert slam.track_stereo(img_l, img_r, 0.0) is not None
    assert slam.state == "OK" and slam.n_keyframes() == 1 and slam.n_map_points() > 400
    slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**dict(CFG, sensor=tconfig.RGBD)), device="cpu")
    assert slam.track_rgbd(img_l, tsynthetic.depth_map(scene, TCAM, R, t), 0.0) is not None
    assert slam.state == "OK" and slam.n_map_points() > 500
