"""The inertial weld of the port (MergeInertialBA, Optimizer.cc:6034) on the
CPU: the twins of `tests/test_inertial_merge.py`'s
`test_seam_link_carries_no_inertial_factor` and `test_viba2_gate`, and
`mapper.merge_inertial_ba` replayed in both packages from one snapshot.
The 300-frame kidnap of that file runs on the card only (`chip_smoke.py`
phase 11 (b)), to its four bars.

The map is the JAX test's two constant-velocity fragments of three
keyframes, 1 m apart, each observing its own exactly reprojected points,
with consistent preintegrations inside each fragment and none across the
seam; here each keyframe also links to its predecessor, so that the
temporal chains of `merge_inertial_ba` find both fragments. The replay
moves the second fragment's last two keyframes 2 cm off and runs
`merge_inertial_ba(last keyframe, third keyframe)` (8 iterations over both
chains, the seam masked) on copies of that map in a new JAX mapper and in
the port's. Bounds (8 float32 LM iterations that sum in another order, on
a problem whose points move by up to 0.2 m and biases by 7e-4): keyframe
rotations within 1e-5, translations, velocities and biases within 1e-4,
points within 1e-2 (`tests/test_torch_global_ba.py`'s)."""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.optim import imu as jimu
from orb_slam3_comments_ghr_tpu.pipeline import mapper as jmapper
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.map.state import MapConfig, MapState
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.optim import imu as timu
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper
from orb_slam3_comments_ghr_torch.pipeline.loopcloser import LoopCloser
from orb_slam3_comments_ghr_torch.utils import config as tconfig

torch.set_num_threads(1)

TCAM = tcameras.euroc_cam0()
NOISE = dict(noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)
CFG = dict(n_features=256, local_ba_points=512)


def _feats(n=256):
    return {"xy": np.zeros((n, 2), np.float32), "level": np.zeros(n, np.int32),
            "angle": np.zeros(n, np.float32), "desc": np.zeros((n, 8), np.uint32),
            "valid": np.ones(n, bool), "u_right": np.full(n, -1.0, np.float32),
            "depth": np.full(n, -1.0, np.float32)}


def _project(p):
    return tcameras.project(TCAM, torch.tensor(p[None], dtype=torch.float32))[0].numpy()


def two_fragments():
    """(map, keyframe ids, preintegration arrays per keyframe) of the JAX
    test's seam problem, built on the port's map (host numpy)."""
    m = MapState(MapConfig(max_kf=16, max_mp=1024, n_feat=256, obs_cap=8))
    # two constant-velocity fragments along +x, a 1.0 m gap between KF2 (the
    # end of chain A) and KF3 (the start of chain B); camera == body
    centers = [0.0, 0.1, 0.2, 1.2, 1.3, 1.4]
    rng = np.random.default_rng(9)
    kf_ids = []
    for i, cx in enumerate(centers):
        prev = kf_ids[-1] if kf_ids else -1
        kf = m.add_keyframe(np.eye(3, dtype=np.float32), np.array([-cx, 0.0, 0.0], np.float32),
                            _feats(), timestamp=0.5 * i, parent=prev, prev=prev)
        m.kf_vel[kf] = np.array([0.2, 0.0, 0.0], np.float32)
        kf_ids.append(kf)
    # each fragment observes its own exactly reprojected points: only a
    # (bogus) seam factor could move the fragments relative to each other
    slot_ctr = {k: 0 for k in kf_ids}
    for frag, base in ((kf_ids[:3], 0.1), (kf_ids[3:], 1.3)):
        pts = rng.uniform([base - 2, -1.5, 6], [base + 2, 1.5, 10], (60, 3)).astype(np.float32)
        desc = rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32)
        for j in range(60):
            kf0 = frag[0]
            slot0 = slot_ctr[kf0]
            m.kf_feat_xy[kf0, slot0] = _project(m.kf_R[kf0] @ pts[j] + m.kf_t[kf0])
            mp = m.add_map_points(pts[j][None], desc[j][None], kf0, np.array([slot0]))[0]
            slot_ctr[kf0] = slot0 + 1
            for kf in frag[1:]:
                uv = _project(m.kf_R[kf] @ pts[j] + m.kf_t[kf])
                if not (0 <= uv[0] < TCAM.width and 0 <= uv[1] < TCAM.height):
                    continue
                slot = slot_ctr[kf]
                m.kf_feat_xy[kf, slot] = uv
                m.add_observation(int(mp), kf, slot)
                slot_ctr[kf] = slot + 1
    # consistent preintegrations inside the fragments (constant velocity:
    # the specific force is -g in the body frame); the seam link gets none
    calib = timu.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32), **NOISE)
    acc = torch.tensor([[0.0, 0.0, timu.GRAVITY]]).repeat(50, 1)
    pre = timu.preintegrate(acc, torch.zeros(50, 3), torch.full((50,), 0.01), torch.zeros(6), calib)
    preint = {k: {f: a.numpy().copy() for f, a in pre._asdict().items()}
              for k in (kf_ids[1], kf_ids[2], kf_ids[4], kf_ids[5])}
    return m, kf_ids, preint


def port_mapper(m, preint):
    mapper = tmapper.LocalMapper(TCAM, tconfig.SlamConfig(**CFG), m, device="cpu")
    calib = timu.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32), **NOISE)
    mapper.imu = types.SimpleNamespace(calib=calib, bias=np.zeros(6, np.float32))
    mapper.kf_preint = {k: convert.preintegrated_from_numpy(v, device="cpu")
                        for k, v in preint.items()}
    return mapper


def jax_mapper(arrays, preint):
    jm = jstate.MapState(jstate.MapConfig(**arrays["cfg"]))
    for k, v in arrays.items():
        if k != "cfg":
            setattr(jm, k, v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
    mapper = jmapper.LocalMapper(jcameras.euroc_cam0(), jconfig.SlamConfig(**CFG), jm)
    calib = jimu.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), **NOISE)
    mapper.imu = types.SimpleNamespace(calib=calib, bias=np.zeros(6, np.float32))
    mapper.kf_preint = {k: jimu.Preintegrated(**{f: jnp.asarray(a) for f, a in v.items()})
                        for k, v in preint.items()}
    return mapper


def _center(m, k):
    return -m.kf_R[k].T @ m.kf_t[k]


def test_seam_link_carries_no_inertial_factor():
    """`_run_vi_ba` masks the inertial factor on `seam` links and on links
    without a preintegration: an unmasked empty preintegration (zero
    covariance, ~1e9 information) would weld the seam keyframes into one
    pose."""
    m, kf_ids, preint = two_fragments()
    mapper = port_mapper(m, preint)
    pts = m.local_point_ids(kf_ids, mapper.cfg.local_ba_points)
    mapper._run_vi_ba(kf_ids, pts, iters=8, seam={2})
    gap = np.linalg.norm(_center(m, kf_ids[3]) - _center(m, kf_ids[2]))
    assert 0.9 < gap < 1.1, f"seam collapsed/stretched: gap={gap:.3f} (want ~1.0)"
    intra = np.linalg.norm(_center(m, kf_ids[1]) - _center(m, kf_ids[0]))
    assert 0.05 < intra < 0.15, intra


def test_viba2_gate():
    """With loop_requires_viba2 (the reference default), place recognition
    is off in an inertial map until VIBA2 (LoopClosing.cc:413)."""
    cfg = tconfig.SlamConfig(sensor=tconfig.IMU_MONOCULAR, n_features=64, max_kf=32, max_mp=256,
                             loop_min_kfs=1)
    m = MapState(MapConfig(max_kf=32, max_mp=256, n_feat=64))
    lc = LoopCloser(TCAM, cfg, m, kfdb=None, mapper=None, device="cpu")
    feats = _feats(64)
    feats["valid"][:] = False
    kf = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), feats, 0.0)
    m.map_imu_init[m.active_map] = True
    m.map_viba2[m.active_map] = False
    assert lc.process_keyframe(kf) is False


def test_merge_inertial_ba_replayed_against_jax():
    m, kf_ids, preint = two_fragments()
    for k in kf_ids[4:]:
        m.kf_t[k] += np.array([0.02, -0.01, 0.015], np.float32)
    arrays = convert.map_state_to_numpy(m)
    from test_torch_vi_ba_outliers import jax_vi_ba_erases_outliers

    tmp, jmp = port_mapper(m, preint), jax_mapper(arrays, preint)
    assert tmp._temporal_chain(kf_ids[5], cap=10) == kf_ids
    tmp.merge_inertial_ba(kf_ids[5], kf_ids[2])
    with jax_vi_ba_erases_outliers():  # the port's VI-BA erase (ROADMAP C10)
        jmp.merge_inertial_ba(kf_ids[5], kf_ids[2])
    tm, jm = tmp.map, jmp.map
    assert tm.version == jm.version == arrays["version"] + 1
    assert np.abs(tm.kf_t[kf_ids[4:]] - arrays["kf_t"][kf_ids[4:]]).max() > 1e-3
    np.testing.assert_array_equal(tm.kf_t[kf_ids[0]], arrays["kf_t"][kf_ids[0]])  # the gauge
    np.testing.assert_allclose(tm.kf_R, jm.kf_R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.kf_t, jm.kf_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_vel, jm.kf_vel, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_bias, jm.kf_bias, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.mp_pos, jm.mp_pos, rtol=0, atol=1e-2)
    gap = np.linalg.norm(_center(tm, kf_ids[3]) - _center(tm, kf_ids[2]))
    assert 0.9 < gap < 1.1, gap
