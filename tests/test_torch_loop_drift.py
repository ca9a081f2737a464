"""The essential graph's drift distribution through the port, against the
JAX package: the twin of `tests/test_loop_drift_distribution.py` (its 2
cases, the Sim(3) graph and the 4-DoF graph of an inertial map past
VIBA2). Each case runs `LoopCloser._optimize_essential_graph` of both
packages on copies of the same drifted ring and holds the port to the JAX
test's bars.

Bounds: keyframe rotations within 1e-4 and translations within 1e-3 of
the JAX package's, map points within 1e-3, velocities within 1e-4
(fifteen float32 Gauss-Newton steps with another summation order)."""

import numpy as np
import torch

from test_loop_drift_distribution import _build_drifted_ring
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import loopcloser as jloop, mapper as jmapper
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.pipeline import loopcloser as tloop, mapper as tmapper

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()


def cam_center(R, t):
    return -R.T @ t


def run_both(inertial: bool):
    """Both packages' graphs on copies of the drifted ring, after the
    "window correction" that puts the last keyframe at its true pose.
    Returns (port map, ids, ground truth, stored poses, JAX map)."""
    m, ids, (gt_R, gt_t), (st_R, st_t) = _build_drifted_ring()
    n = len(ids)
    cfg = jconfig.SlamConfig(sensor=jconfig.IMU_STEREO if inertial else jconfig.MONOCULAR,
                             n_features=8)
    if inertial:
        m.map_imu_init[m.active_map] = m.map_viba1[m.active_map] = True
        m.map_viba2[m.active_map] = True  # -> the 4-DoF graph
        for k in ids:
            m.kf_vel[k] = np.array([0.1, 0.0, 0.0], np.float32)
    pre_R, pre_t = m.kf_R.copy(), m.kf_t.copy()
    m.kf_R[ids[-1]] = gt_R[n - 1]
    m.kf_t[ids[-1]] = gt_t[n - 1]
    tm = convert.map_state_from_numpy(convert.map_state_to_numpy(m))
    tcfg = convert.config_from_jax(cfg)
    jlc = jloop.LoopCloser(JCAM, cfg, m, kfdb=None, mapper=jmapper.LocalMapper(JCAM, cfg, m))
    tlc = tloop.LoopCloser(TCAM, tcfg, tm, kfdb=None,
                           mapper=tmapper.LocalMapper(TCAM, tcfg, tm, device="cpu"), device="cpu")
    jlc._optimize_essential_graph(ids[-1], ids[0], pre_R, pre_t, pre_keys=None)
    tlc._optimize_essential_graph(ids[-1], ids[0], pre_R, pre_t, pre_keys=None)
    np.testing.assert_allclose(tm.kf_R, m.kf_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t, m.kf_t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.mp_pos, m.mp_pos, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_vel, m.kf_vel, rtol=0, atol=1e-4)
    return tm, ids, (gt_R, gt_t), (st_R, st_t), m


class TestDriftDistribution:
    def test_far_keyframes_absorb_drift(self):
        m0, ids0, _, _ = _build_drifted_ring()
        p_mid = int(m0.mp_ids()[len(m0.mp_ids()) // 2])
        ref_mid = int(m0.mp_first_kf[p_mid])
        p_cam_before = m0.kf_R[ref_mid] @ m0.mp_pos[p_mid] + m0.kf_t[ref_mid]
        m, ids, (gt_R, gt_t), (st_R, st_t), _ = run_both(inertial=False)
        n = len(ids)
        mid = ids[n // 2]
        drift_end = np.linalg.norm(cam_center(st_R[-1], st_t[-1]) - cam_center(gt_R[-1], gt_t[-1]))
        mid_err_before = np.linalg.norm(cam_center(st_R[n // 2], st_t[n // 2])
                                        - cam_center(gt_R[n // 2], gt_t[n // 2]))
        assert drift_end > 0.15
        moved_mid = np.linalg.norm(cam_center(m.kf_R[mid], m.kf_t[mid])
                                   - cam_center(st_R[n // 2], st_t[n // 2]))
        assert moved_mid > 0.2 * drift_end, (moved_mid, drift_end)
        mid_err_after = np.linalg.norm(cam_center(m.kf_R[mid], m.kf_t[mid])
                                       - cam_center(gt_R[n // 2], gt_t[n // 2]))
        assert mid_err_after < 0.5 * mid_err_before, (mid_err_before, mid_err_after)
        errs_before = [np.linalg.norm(cam_center(st_R[k], st_t[k]) - cam_center(gt_R[k], gt_t[k]))
                       for k in range(n)]
        errs_after = [np.linalg.norm(cam_center(m.kf_R[ids[k]], m.kf_t[ids[k]])
                                     - cam_center(gt_R[k], gt_t[k])) for k in range(n)]
        assert np.mean(errs_after) < 0.4 * np.mean(errs_before)
        # map points rode along with their reference keyframe
        p_cam_after = m.kf_R[ref_mid] @ m.mp_pos[p_mid] + m.kf_t[ref_mid]
        np.testing.assert_allclose(p_cam_after, p_cam_before, atol=5e-2)


class TestDriftDistributionInertial4DoF:
    def test_dof4_graph_corrects_yaw_drift(self):
        m, ids, (gt_R, gt_t), (st_R, st_t), _ = run_both(inertial=True)
        n = len(ids)
        errs_before = [np.linalg.norm(cam_center(st_R[k], st_t[k]) - cam_center(gt_R[k], gt_t[k]))
                       for k in range(n)]
        errs_after = [np.linalg.norm(cam_center(m.kf_R[ids[k]], m.kf_t[ids[k]])
                                     - cam_center(gt_R[k], gt_t[k])) for k in range(n)]
        assert np.mean(errs_after) < 0.4 * np.mean(errs_before)
        for k in range(0, n, 5):  # gravity kept: the planar ring's Rcw[2, 2] stays ~1
            assert m.kf_R[ids[k]][2, 2] > 0.999, (k, m.kf_R[ids[k]])
