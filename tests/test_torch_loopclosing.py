"""Loop closing through the port, against the JAX package: the twin of
`tests/test_loopclosing.py` (160 frames of 512 rendered features on an
outward-looking circle that revisits its start, `SLAM.track_features` with
loop closing on), run once per package in a module fixture, and a replay
through the port of the JAX run's loop correction.

The runs are compared by outcome (their float32 LMs sum in another order,
and the maps part within the run): a loop or merge fires in both, both pass
the JAX test's bars (> 70 poses, Sim(3)-aligned ATE < 8 cm, finite points,
tracking on at the end), and the two ATEs lie within 1 cm of each other.
The replay takes the JAX run's map just before its `_correct_loop` (with
the keyframe, the candidate and S12) and applies the same correction in
the port: the window correction, the fuse, the essential graph and the
global BA. Keyframe centres land within 0.1 mm and rotations within 1e-5
of the JAX package's after the correction (the global BA's ten float32 LM
iterations in another order; the correction itself moves them by
millimetres).
The JAX tracker runs with the port's repair of the velocity after a
reference-keyframe fallback (ROADMAP C9,
`test_torch_slam.jax_velocity_from_previous_frame`); in both packages a
frame that follows a fallback must then track by the motion model.
The kidnap-and-merge twin is `tests/test_torch_merge.py`."""

import numpy as np
import pytest
import torch

from test_loopclosing import CAM as JCAM
from test_torch_slam import jax_velocity_from_previous_frame
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import loopcloser as tloop, mapper as tmapper
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

TCAM = tcameras.euroc_cam0()
# tests/test_loopclosing.py
CFG = dict(n_features=512, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=5, min_init_matches=60)
ATE_GAP = 0.01


def features(pkg: str, feats):
    if pkg == "jax":
        return feats
    return convert.features_from_numpy({k: np.asarray(v) for k, v in feats._asdict().items()},
                                       device="cpu")


def make_slam(pkg: str, **cfg):
    if pkg == "jax":
        from orb_slam3_comments_ghr_tpu.utils import config as jconfig
        return jsystem.SLAM(JCAM, jconfig.SlamConfig(**cfg))
    return tsystem.SLAM(TCAM, tconfig.SlamConfig(**cfg), device="cpu")


def closed_loop_run(pkg: str, hooks=None, n_frames=160, seed=13, noise_px=0.7):
    """`tests/test_loopclosing.py`'s run in one package."""
    world = jsynthetic.make_ring_world(seed)
    poses = jsynthetic.circular_trajectory(n_frames, arc=1.06, outward=True)
    slam = make_slam(pkg, **CFG)
    if hooks is not None:
        hooks(slam)
    est = []
    for i, (R, t) in enumerate(poses):
        feats, _ = jsynthetic.render_features(world, JCAM, R, t, n_feat=512, seed=seed * 100 + i,
                                              noise_px=noise_px)
        pose = slam.track_features(features(pkg, feats), i * 0.05)
        if pose is not None:
            est.append((i * 0.05, pose))
    return slam, est, jsynthetic.gt_trajectory(poses)


def _record_correction(box: dict):
    """Hook on a JAX SLAM: keep the map before and after its first
    `_correct_loop`, with the call's arguments."""
    def hooks(slam):
        lc = slam.loopcloser
        correct = lc._correct_loop

        def recorded(kf, cand, s12, R12, t12):
            first = "before" not in box
            if first:
                box.update(before=convert.map_state_to_numpy(slam.map),
                           args=(int(kf), int(cand), float(s12), np.array(R12, np.float64),
                                 np.array(t12, np.float64)))
            correct(kf, cand, s12, R12, t12)
            if first:
                box["after"] = convert.map_state_to_numpy(slam.map)

        lc._correct_loop = recorded
    return hooks


def _record_fallbacks(box: dict, key: str):
    """Hook on a SLAM: box[key] gets, per `_track_frame` call, whether the
    reference-keyframe fallback ran in it."""
    def hooks(slam):
        tr = slam.tracker
        track_frame, track_ref = tr._track_frame, tr._track_reference_kf
        box[key] = []

        def frame(feats, timestamp):
            box[key].append(False)
            return track_frame(feats, timestamp)

        def fallback(feats):
            box[key][-1] = True
            return track_ref(feats)

        tr._track_frame, tr._track_reference_kf = frame, fallback
    return hooks


@pytest.fixture(scope="module")
def runs():
    box = {}

    def jax_hooks(slam):
        _record_correction(box)(slam)
        _record_fallbacks(box, "jax_fallbacks")(slam)

    with jax_velocity_from_previous_frame():
        jax_run = closed_loop_run("jax", hooks=jax_hooks)
    out = {"jax": jax_run, "torch": closed_loop_run("torch", hooks=_record_fallbacks(box, "torch_fallbacks"))}
    return out, box


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_loop_detected(runs, pkg):
    slam, _, _ = runs[0][pkg]
    assert slam.loopcloser.n_loops + slam.loopcloser.n_merges >= 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_trajectory_stays_accurate(runs, pkg):
    slam, est, gt = runs[0][pkg]
    assert len(est) > 70
    assert evaluation.ate_rmse(est, gt, with_scale=True) < 0.08


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_map_consistent_after_correction(runs, pkg):
    slam, _, _ = runs[0][pkg]
    assert np.all(np.isfinite(slam.map.mp_pos[slam.map.mp_ids()]))
    assert slam.state in ("OK", "RECENTLY_LOST")


def test_runs_agree(runs):
    (js, jest, gt), (ts, test, _) = runs[0]["jax"], runs[0]["torch"]
    ate_j = evaluation.ate_rmse(jest, gt, with_scale=True)
    ate_t = evaluation.ate_rmse(test, gt, with_scale=True)
    assert abs(ate_j - ate_t) < ATE_GAP, (ate_j, ate_t)
    assert abs(len(jest) - len(test)) <= 5


def test_correct_loop_replay(runs):
    """The JAX run's loop correction, replayed through the port from the
    same map."""
    box = runs[1]
    assert "before" in box, "the JAX run closed no loop"
    tm = convert.map_state_from_numpy(box["before"])
    cfg = tconfig.SlamConfig(**CFG)
    lc = tloop.LoopCloser(TCAM, cfg, tm, kfdb=None,
                          mapper=tmapper.LocalMapper(TCAM, cfg, tm, device="cpu"), device="cpu")
    lc._correct_loop(*box["args"])
    after = box["after"]
    ids = np.nonzero(after["kf_valid"])[0]
    assert (tm.kf_valid == after["kf_valid"]).all()
    centre = lambda R, t: -np.einsum("kji,kj->ki", R.astype(np.float64), t.astype(np.float64))
    dc = np.linalg.norm(centre(tm.kf_R[ids], tm.kf_t[ids])
                        - centre(after["kf_R"][ids], after["kf_t"][ids]), axis=1)
    moved = np.linalg.norm(centre(tm.kf_R[ids], tm.kf_t[ids])
                           - centre(box["before"]["kf_R"][ids], box["before"]["kf_t"][ids]), axis=1)
    assert moved.max() > 1e-3  # the correction moved the map
    assert dc.max() < 1e-4, dc.max()
    np.testing.assert_allclose(tm.kf_R[ids], after["kf_R"][ids], rtol=0, atol=1e-5)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_motion_model_tracks_after_a_fallback(runs, pkg):
    """ROADMAP C9, repaired in the port (and patched into the JAX tracker
    here): once a frame has fallen back to the reference keyframe, the next
    frame tracks by the motion model, so fallbacks stay rare on the
    outward ring."""
    fell = runs[1][f"{pkg}_fallbacks"]
    after = [fell[i + 1] for i in range(len(fell) - 1) if fell[i]]
    assert after and not any(after), (sum(fell), after)
