"""Visual-inertial SLAM through the port, on the CPU, against the JAX
package:
- the twin of `tests/test_vi_stereo.py`: 70 frames of rendered stereo
  features with the IMU rows of `vi_sequence`, `SLAM.track_features`,
  `IMU_STEREO`, in both packages;
- from the JAX run, the inputs of one call each of the tracker's
  `_vi_refine`, the mapper's `maybe_initialize_imu` (the call that
  initializes the IMU: gravity, velocities, biases, the world transform and
  the 12-iteration VI-BA), replayed through the port;
- an inertial `cull_keyframes` on the JAX run's final map, in both
  packages, that merges a culled keyframe's preintegration;
- the tracker's `apply_world_transform`, and the IMU sensors' entry points.
The mono-inertial twin is in `tests/test_torch_vi_pipeline.py`, the
RGB-D-inertial image run in `tests/test_torch_vi_rgbd.py`.

The JAX tracker runs with the stereo observation count the port uses
(`_jax_counts_stereo_twice`, ROADMAP C); in inertial modes it matters only
between the 0.5 s keyframes after the IMU init. The JAX mapper erases the
VI-BA's outlier observations as the port does
(`test_torch_vi_ba_outliers.jax_vi_ba_erases_outliers`, ROADMAP C10).

Bounds: runs are compared by outcome (float32 LMs summing in another order
than XLA): the IMU initialized at the same keyframe time, the same tracked
count, keyframes within 1, metric ATE (no scale fit) under the twin's 8 cm
in both and within 5 mm of each other. The replayed calls: `_vi_refine`
runs through the port twice, on the JAX run's padded local map and on its
matched rows alone, and the two give the same pose within 1e-5 and the
same bias within 1e-6: the rows of weight 0 add nothing (ROADMAP C1,
repaired in the port only; the JAX call does not move off its input,
within the 1e-6 of its body-frame round trip, see
`tests/test_torch_inertial.py`); `maybe_initialize_imu` the same scale to
1e-4 relative, keyframe centres within 2 mm, velocities within 1 cm/s,
biases within 1e-3 and the same staging flags; the cull the same kept
keyframes, and each merged preintegration with the same live samples, dT
within 1e-6 and dR, dV, dP within 1e-5 relative (2e-6 absolute): a
merged window runs over several seconds, where dV reaches ~30 m/s."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stereo_slam import _jax_counts_stereo_twice
from test_torch_vi_ba_outliers import jax_vi_ba_erases_outliers
from orb_slam3_comments_ghr_tpu import system as jsystem
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.optim import imu as jimu
from orb_slam3_comments_ghr_tpu.pipeline import imu_frontend as jfront, mapper as jmapper
from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
from orb_slam3_comments_ghr_tpu.utils import config as jconfig, synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert, system as tsystem
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie
from orb_slam3_comments_ghr_torch.pipeline import imu_frontend as tfront
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper, programs as tprograms
from orb_slam3_comments_ghr_torch.pipeline import tracker as ttracker
from orb_slam3_comments_ghr_torch.utils import config as tconfig, evaluation

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
NOISE = dict(noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
JCAL = jimu.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), **NOISE)
TCAL = convert.imu_calib_from_jax(JCAL)
# tests/test_vi_stereo.py
CFG = dict(sensor=tconfig.IMU_STEREO, n_features=768, local_points_cap=2048, local_ba_points=2048,
           max_frames_between_kf=5, enable_loop_closing=False)
N_FRAMES = 70
ATE_GAP = 0.005
VI_REFINE_CALL = 10  # the _vi_refine call whose inputs are replayed
CULL_REDUNDANCY = 0.5  # the replayed cull's redundancy ratio


def gt_of(poses, times):
    return [(times[i], np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))
            for i, (R, t) in enumerate(poses)]


def run(pkg: str, cfg: dict, world_seed: int, n_frames: int, feat_seed: int, stereo: bool,
        hooks=None):
    """(slam, estimates, ground truth) of one package over `vi_sequence`
    with rendered features (`render_features`, the JAX package's, fed to the
    port through `convert`) and the IMU rows in (t_{i-1}, t_i]."""
    if pkg == "torch":
        slam = tsystem.SLAM(TCAM, tconfig.SlamConfig(**cfg), imu_calib=TCAL, device="cpu")
    else:
        slam = jsystem.SLAM(JCAM, jconfig.SlamConfig(**cfg), imu_calib=JCAL)
    if hooks is not None:
        hooks(slam)
    world = jsynthetic.make_world(world_seed, n_points=3000)
    poses, imu_rows, times = jsynthetic.vi_sequence(n_frames)
    est = []
    for i, (R, t) in enumerate(poses):
        chunk = imu_rows[(imu_rows[:, 0] > (times[i - 1] if i else -1)) & (imu_rows[:, 0] <= times[i])]
        if len(chunk):
            slam.feed_imu(chunk)
        feats, _ = jsynthetic.render_features(world, JCAM, R, t, n_feat=cfg["n_features"],
                                              seed=feat_seed + i, stereo=stereo)
        if pkg == "torch":
            feats = convert.features_from_numpy({k: np.asarray(v) for k, v in feats._asdict().items()},
                                                device="cpu")
        pose = slam.track_features(feats, times[i])
        if pose is not None:
            est.append((times[i], pose))
    return slam, est, gt_of(poses, times)


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _recorders(box: dict):
    """Hooks on a JAX SLAM that keep the inputs and outputs of the calls the
    replay tests need."""
    def hooks(slam):
        tr, mp = slam.tracker, slam.mapper
        vi_refine, init_imu, cull = tr._vi_refine, mp.maybe_initialize_imu, mp.cull_keyframes
        count = [0]

        def rec_vi_refine(feats, res, ids, timestamp):
            count[0] += 1
            if count[0] != VI_REFINE_CALL:
                return vi_refine(feats, res, ids, timestamp)
            pre = tr.imu.preintegrate_since_kf(tr.last_kf_time, timestamp)
            box["vi_refine_in"] = dict(
                map=convert.map_state_to_numpy(tr.map), feats=_np(feats),
                res={k: np.asarray(v) for k, v in res._asdict().items()}, ids=np.asarray(ids),
                timestamp=timestamp, last_R=tr.last_R.copy(), last_t=tr.last_t.copy(),
                body_vel=np.asarray(tr.body_vel).copy(), last_kf=tr.last_kf,
                last_kf_time=tr.last_kf_time, bias=np.asarray(tr.imu.bias).copy(), pre=_np(pre))
            vi_refine(feats, res, ids, timestamp)
            box["vi_refine_out"] = dict(last_R=np.asarray(tr.last_R).copy(),
                                        last_t=np.asarray(tr.last_t).copy(),
                                        bias=np.asarray(tr.imu.bias).copy())

        def rec_init(kf):
            m = slam.map
            if m.map_imu_init.get(m.active_map, False) or "init_in" in box:
                return init_imu(kf)
            snap = dict(map=convert.map_state_to_numpy(m), kf=kf, bias=np.asarray(mp.imu.bias).copy(),
                        preint={k: _np(v) for k, v in mp.kf_preint.items()})
            init_imu(kf)
            if m.map_imu_init.get(m.active_map, False):
                box["init_in"] = snap
                box["init_out"] = dict(map=convert.map_state_to_numpy(m),
                                       bias=np.asarray(mp.imu.bias).copy(),
                                       transform=copy.deepcopy(mp.last_transform))

        tr._vi_refine, mp.maybe_initialize_imu = rec_vi_refine, rec_init
    return hooks


@pytest.fixture(scope="module")
def stereo_runs():
    box = {}
    with _jax_counts_stereo_twice(), jax_vi_ba_erases_outliers():
        jax_run = run("jax", CFG, 41, N_FRAMES, 5100, True, hooks=_recorders(box))
    return run("torch", CFG, 41, N_FRAMES, 5100, True), jax_run, box


def test_stereo_inertial_twin_of_jax(stereo_runs):
    (ts, test, gt), (js, jest, _), _ = stereo_runs
    for slam in (ts, js):
        assert slam.map.map_imu_init.get(slam.map.active_map, False)
    assert ts.mapper.t_imu_init == js.mapper.t_imu_init
    assert len(test) == len(jest) and len(test) > 55
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    ate_t = evaluation.ate_rmse(test, gt, with_scale=False)  # stereo is metric: no scale fit
    ate_j = evaluation.ate_rmse(jest, gt, with_scale=False)
    assert ate_t < 0.08 and ate_j < 0.08, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < ATE_GAP, (ate_t, ate_j)


def _port_mapper(snap_map, preint, bias, cfg=None):
    mp = tmapper.LocalMapper(TCAM, tconfig.SlamConfig(**(cfg or CFG)),
                             convert.map_state_from_numpy(snap_map), device="cpu")
    mp.imu = tfront.ImuFrontend(TCAL, device="cpu")
    mp.imu.bias = bias.copy()
    mp.kf_preint = {k: convert.preintegrated_from_numpy(v, device="cpu") for k, v in preint.items()}
    return mp


def _replay_vi_refine(inp, rows=None):
    """The port's tracker after `_vi_refine` on the recorded inputs; with
    `rows`, on those rows of the local map and of the tracking result
    only."""
    m = convert.map_state_from_numpy(inp["map"])
    imu = tfront.ImuFrontend(TCAL, device="cpu")
    imu.bias = inp["bias"].copy()
    imu.last_frame_time = inp["timestamp"]
    imu._pre_kf = convert.preintegrated_from_numpy(inp["pre"], device="cpu")
    imu._pre_kf_bias = inp["bias"].copy()
    tr = ttracker.Tracker(TCAM, tconfig.SlamConfig(**CFG), m, imu=imu, device="cpu")
    tr.last_R, tr.last_t = inp["last_R"], inp["last_t"]
    tr.body_vel, tr.last_kf, tr.last_kf_time = inp["body_vel"], inp["last_kf"], inp["last_kf_time"]
    res = tprograms.TrackResult(**{k: (int(v) if k == "n_inliers" else v)
                                   for k, v in inp["res"].items()})
    lp = convert.local_points_from_map(m, inp["ids"], CFG["local_points_cap"], device="cpu")
    if rows is not None:
        res = res._replace(match_feat=res.match_feat[rows], inlier=res.inlier[rows],
                           visible=res.visible[rows])
        lp = tprograms.LocalPoints(*(a[torch.from_numpy(rows)] for a in lp))
    tr._vi_refine(convert.features_from_numpy(inp["feats"], device="cpu"), res, lp,
                  inp["timestamp"])
    return tr


def test_vi_refine_replayed(stereo_runs):
    box = stereo_runs[2]
    inp, out = box["vi_refine_in"], box["vi_refine_out"]
    # the JAX call keeps its input pose (ROADMAP C1)
    np.testing.assert_allclose(out["last_t"], inp["last_t"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["bias"], inp["bias"])
    matched = inp["res"]["inlier"] & (inp["res"]["match_feat"] >= 0)
    assert 0 < matched.sum() < len(matched)
    full, kept = _replay_vi_refine(inp), _replay_vi_refine(inp, np.nonzero(matched)[0])
    assert np.abs(full.last_t - inp["last_t"]).max() > 1e-4  # the refinement moved the pose
    np.testing.assert_allclose(full.last_R, kept.last_R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(full.last_t, kept.last_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(full.imu.bias, kept.imu.bias, rtol=0, atol=1e-6)


def test_maybe_initialize_imu_replayed(stereo_runs):
    box = stereo_runs[2]
    inp, out = box["init_in"], box["init_out"]
    mp = _port_mapper(inp["map"], inp["preint"], inp["bias"])
    mp.maybe_initialize_imu(inp["kf"])
    m, jm = mp.map, out["map"]
    assert m.map_imu_init[m.active_map] and not m.map_viba1[m.active_map]
    assert mp.map_transformed and mp.t_imu_init == float(jm["kf_time"][inp["kf"]])
    s_t, s_j = mp.last_transform[0], out["transform"][0]
    assert abs(s_t - s_j) <= 1e-4 * abs(s_j)
    np.testing.assert_allclose(mp.last_transform[1], out["transform"][1], rtol=0, atol=1e-4)
    kfs = m.kf_ids()
    assert np.array_equal(kfs, np.nonzero(jm["kf_valid"])[0])
    centre = lambda R, t: -(R.transpose(0, 2, 1) @ t[..., None])[..., 0]
    np.testing.assert_allclose(centre(m.kf_R[kfs], m.kf_t[kfs]),
                               centre(jm["kf_R"][kfs], jm["kf_t"][kfs]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(m.kf_vel[kfs], jm["kf_vel"][kfs], rtol=0, atol=1e-2)
    np.testing.assert_allclose(m.kf_bias[kfs], jm["kf_bias"][kfs], rtol=0, atol=1e-3)
    np.testing.assert_allclose(mp.imu.bias, out["bias"], rtol=0, atol=1e-3)


def _jax_mapper(snap_map, preint, cfg):
    m = jstate.MapState(jstate.MapConfig(**snap_map["cfg"]))
    for k, v in snap_map.items():
        if k != "cfg":
            setattr(m, k, v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
    mp = jmapper.LocalMapper(JCAM, jconfig.SlamConfig(**cfg), m)
    mp.imu = jfront.ImuFrontend(JCAL)
    mp.kf_preint = {k: jimu.Preintegrated(**{f: jnp.asarray(a) for f, a in v.items()})
                    for k, v in preint.items()}
    return mp


def test_inertial_cull_merges_preintegration(stereo_runs):
    """cull_keyframes on the final map of the JAX run, in both packages,
    with the redundancy ratio lowered to CULL_REDUNDANCY (at 0.9 this map
    has nothing to cull) and from an early keyframe, so that the last 21
    keyframes of the temporal chain, which an inertial map keeps, do not
    cover every candidate: the same keyframes culled, and each culled
    keyframe's preintegration merged into its successor's."""
    js = stereo_runs[1][0]
    snap_map = convert.map_state_to_numpy(js.map)
    preint = {k: _np(v) for k, v in js.mapper.kf_preint.items()}
    cfg = dict(CFG, kf_cull_redundancy=CULL_REDUNDANCY)
    for kf in js.map.kf_ids()[1:]:
        jm = _jax_mapper(snap_map, preint, cfg)
        jm.cull_keyframes(int(kf))
        if (jm.map.kf_valid != snap_map["kf_valid"]).any():
            break
    culled = np.nonzero(snap_map["kf_valid"] & ~jm.map.kf_valid)[0]
    assert len(culled) >= 1
    tm = _port_mapper(snap_map, preint, np.zeros(6, np.float32), cfg=cfg)
    tm.cull_keyframes(int(kf))
    np.testing.assert_array_equal(tm.map.kf_valid, jm.map.kf_valid)
    assert set(tm.kf_preint) == set(jm.kf_preint)
    # the survivors whose window grew: each holds the live samples of its
    # culled predecessors and its own
    live = lambda dts: int((np.asarray(dts) > 0).sum())
    merged = [k for k in tm.kf_preint if live(tm.kf_preint[k].dts) != live(preint[k]["dts"])]
    for k in merged:
        got, want = tm.kf_preint[k], jm.kf_preint[k]
        # the port keeps the live samples only, the JAX package pads them
        assert got.dts.shape[0] == live(got.dts) == live(want.dts)
        assert float(got.dT) == pytest.approx(float(want.dT), abs=1e-6)
        for f in ("dR", "dV", "dP"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=2e-6, err_msg=f)
    assert len(merged) >= 1


def test_apply_world_transform_against_jax():
    """The world moved by world' = s R world + t: both trackers carry the
    pose and the body velocity along alike and drop the stale motion
    state."""
    rng = np.random.default_rng(3)
    rot = lambda: np.asarray(tlie.so3_exp(torch.tensor(rng.normal(0, 1, 3), dtype=torch.float32)))
    R_cw, R = rot(), rot()
    tt = ttracker.Tracker(TCAM, tconfig.SlamConfig(**CFG), tstate.MapState(tstate.MapConfig()),
                          device="cpu")
    jt = jtracker.Tracker(JCAM, jconfig.SlamConfig(**CFG), jstate.MapState(jstate.MapConfig()))
    for tr in (tt, jt):
        tr.last_R, tr.last_t = R_cw.copy(), np.array([0.3, -0.2, 1.0], np.float32)
        tr.body_vel = np.array([0.1, 0.2, -0.3], np.float32)
        tr.velocity = np.eye(4)
    jt.vi_prior = "stale"  # the port chains no VI prior (ROADMAP C1)
    for tr in (tt, jt):
        tr.apply_world_transform(1.7, R, np.array([0.5, 0.0, -1.0], np.float32))
    for k in ("last_R", "last_t", "body_vel"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k), err_msg=k)
    assert tt.velocity is None and tt._last_prediction is None and jt.vi_prior is None


@pytest.mark.parametrize("sensor", [tconfig.IMU_MONOCULAR, tconfig.IMU_STEREO, tconfig.IMU_RGBD])
def test_inertial_sensors_construct_and_take_samples(sensor):
    """Every IMU sensor builds, with a calibration or the default one, and
    its entry points take IMU rows; feed_imu needs an IMU sensor."""
    cfg = tconfig.SlamConfig(**dict(CFG, sensor=sensor))
    slam = tsystem.SLAM(TCAM, cfg, device="cpu")
    assert slam.imu is not None and slam.mapper.imu is slam.imu
    assert slam.mapper.kf_preint is slam.tracker.kf_preint
    img = np.zeros((480, 752), np.uint8)
    rows = np.array([[0.0, 0.0, 0.0, 9.81, 0.0, 0.0, 0.0]])
    if sensor == tconfig.IMU_MONOCULAR:
        assert slam.track_monocular(img, 0.0, imu_samples=rows) is None
    elif sensor == tconfig.IMU_STEREO:
        assert slam.track_stereo(img, img, 0.0, imu_samples=rows) is None
    else:
        assert slam.track_rgbd(img, np.zeros((480, 752), np.float32), 0.0, imu_samples=rows) is None
    assert slam.state == "NOT_INITIALIZED" and slam.imu.last_frame_time == 0.0
    with pytest.raises(RuntimeError, match="IMU"):
        tsystem.SLAM(TCAM, tconfig.SlamConfig(**dict(CFG, sensor=tconfig.STEREO)),
                     imu_calib=TCAL, device="cpu").feed_imu(rows)
