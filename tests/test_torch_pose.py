"""The port's Lie, camera, robust-kernel and pose-LM functions against the
JAX package on the same seeded inputs. Geometry agrees to abs 1e-5 (float32
evaluated in another order); the pose LM to 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_comments_ghr_tpu.ops import cameras as jcam, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import pose_opt as jpose, robust as jrobust
from orb_slam3_comments_ghr_torch.ops import cameras as tcam, lie as tlie
from orb_slam3_comments_ghr_torch.optim import pose_opt as tpose, robust as trobust
from orb_slam3_comments_ghr_torch.convert import camera_from_jax

torch.set_num_threads(1)

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _tangents(seed, n=64):
    """Rotation vectors across the Taylor switch (t^2 < 1e-8) and up to ~pi."""
    rng = np.random.default_rng(seed)
    mags = np.concatenate([np.full(8, 1e-6), np.full(8, 5e-5), rng.random(n - 16) * 3.0])
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    phi = (axis * mags[:, None]).astype(np.float32)
    rho = rng.normal(size=(n, 3)).astype(np.float32)
    return phi, rho


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "so3_left_jacobian"])
def test_so3(fn):
    phi, _ = _tangents(0)
    _close(getattr(tlie, fn)(torch.from_numpy(phi)), getattr(jlie, fn)(jnp.asarray(phi)))


def test_se3_exp_mul_apply():
    phi, rho = _tangents(1)
    xi = np.concatenate([rho, phi], -1)
    Rt, tt = tlie.se3_exp(torch.from_numpy(xi))
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    _close(Rt, Rj)
    _close(tt, tj)
    Rm_t, tm_t = tlie.se3_mul(Rt, tt, Rt.flip(0), tt.flip(0))
    Rm_j, tm_j = jlie.se3_mul(Rj, tj, Rj[::-1], tj[::-1])
    _close(Rm_t, Rm_j)
    _close(tm_t, tm_j, atol=1e-4)  # |t| up to ~6 m
    p = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32) * 5
    _close(tlie.se3_apply(Rt[0], tt[0], torch.from_numpy(p)),
           jlie.se3_apply(Rj[0], tj[0], jnp.asarray(p)), atol=1e-4)


def _cam_points(seed, n=200):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([3, 2, 1])
    pc[:, 2] = np.abs(pc[:, 2]) + 0.5
    pc[:4, 2] = [0.0, 1e-10, -2.0, 1e-3]  # degenerate depths
    return pc


def test_camera_functions():
    tc, jc = tcam.euroc_cam0(), jcam.euroc_cam0()
    assert camera_from_jax(jc) == tc
    assert tcam.pinhole_equivalent(tc) == camera_from_jax(jcam.pinhole_equivalent(jc))
    pc = _cam_points(3)
    uv_t = tcam.project(tc, torch.from_numpy(pc))
    uv_j = jcam.project(jc, jnp.asarray(pc))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_allclose(tcam.project_jac(tc, torch.from_numpy(pc)).numpy(),
                               np.asarray(jcam.project_jac(jc, jnp.asarray(pc))), rtol=1e-6)
    for margin in (0.0, 10.0):
        np.testing.assert_array_equal(tcam.in_image(tc, uv_t, margin).numpy(),
                                      np.asarray(jcam.in_image(jc, uv_j, margin)))
    z = pc[:, 2]
    _close(tcam.stereo_right_u(tc, uv_t[:, 0], torch.from_numpy(z))[4:],
           jcam.stereo_right_u(jc, uv_j[:, 0], jnp.asarray(z))[4:], atol=1e-3)


def test_camera_rejects_fisheye():
    """The KB8 model was refused until the fisheye slice (ROADMAP A7); now
    `project` and `unproject` take it and agree with the JAX package (1e-3
    px, 1e-5 on the bearing)."""
    jkb8 = jcam.Camera(kind=jcam.KANNALA_BRANDT8, fx=400.0, fy=400.0, cx=300.0, cy=200.0,
                       k1=0.01, k2=-0.002)
    kb8 = camera_from_jax(jkb8)
    pc = _cam_points(5)
    _close(tcam.project(kb8, torch.from_numpy(pc)), jcam.project(jkb8, jnp.asarray(pc)), atol=1e-3)
    uv = np.random.default_rng(6).random((64, 2)).astype(np.float32) * [600, 400]
    _close(tcam.unproject(kb8, torch.from_numpy(uv)), jcam.unproject(jkb8, jnp.asarray(uv)),
           atol=1e-5)


def test_robust_kernels():
    rng = np.random.default_rng(4)
    chi2 = (rng.random(500) * 20).astype(np.float32)
    level = rng.integers(0, 8, 500).astype(np.int32)
    _close(trobust.inv_level_sigma2(torch.from_numpy(level)),
           jrobust.inv_level_sigma2(jnp.asarray(level)), atol=1e-6)
    for d2 in (jrobust.CHI2_MONO, jrobust.CHI2_STEREO):
        _close(trobust.huber_weight(torch.from_numpy(chi2), d2),
               jrobust.huber_weight(jnp.asarray(chi2), d2), atol=1e-6)
        _close(trobust.huber_cost(torch.from_numpy(chi2), d2),
               jrobust.huber_cost(jnp.asarray(chi2), d2))


def _pose_problem(seed, n=400):
    """Points seen from a known pose: 0.5 px noise scaled by octave, 20 %
    gross outliers, a third of the rows stereo, 10 % padding rows."""
    rng = np.random.default_rng(seed)
    cam = tcam.euroc_cam0()
    R_gt, t_gt = (x.numpy() for x in tlie.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.01])))
    uv = rng.random((n, 2)) * [cam.width, cam.height]
    depth = rng.random(n) * 8 + 2
    pc = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy, np.ones(n)], -1) * depth[:, None]
    p_world = (pc - t_gt) @ R_gt
    level = rng.integers(0, 4, n)
    obs_uv = uv + rng.normal(size=(n, 2)) * 0.5 * 1.2**level[:, None]
    out = rng.random(n) < 0.2
    obs_uv[out] += rng.normal(size=(out.sum(), 2)) * 40
    stereo = rng.random(n) < 0.33
    u_right = np.where(stereo, obs_uv[:, 0] - cam.bf / depth, -1.0)
    valid = rng.random(n) > 0.1
    arrays = dict(p_world=p_world, uv=obs_uv, u_right=u_right, level=level, valid=valid)
    dtypes = dict(level=np.int32, valid=bool)
    arrays = {k: v.astype(dtypes.get(k, np.float32)) for k, v in arrays.items()}
    xi0 = np.array([0.05, 0.03, -0.04, 0.01, 0.015, -0.02], np.float32)
    R0, t0 = (x.numpy() for x in tlie.se3_mul(*tlie.se3_exp(torch.from_numpy(xi0)),
                                              torch.from_numpy(R_gt), torch.from_numpy(t_gt)))
    return cam, arrays, R0, t0


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_matches_jax(seed):
    cam, arrays, R0, t0 = _pose_problem(seed)
    Rt, tt, inl_t, n_t = tpose.optimize_pose(
        cam, torch.from_numpy(R0), torch.from_numpy(t0),
        tpose.PoseObs(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    jc = jcam.euroc_cam0()
    Rj, tj, inl_j, n_j = jpose.optimize_pose(
        jc, jnp.asarray(R0), jnp.asarray(t0),
        jpose.PoseObs(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    _close(Rt, Rj, atol=1e-4)
    _close(tt, tj, atol=1e-4)
    # the inlier masks agree except where chi2 sits within 1e-3 of its gate
    r, _, row_mask, is_stereo = jpose._residuals_jacobians(
        jc, Rj, tj, jpose.PoseObs(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    chi2 = np.asarray(jpose._chi2(r, row_mask, jrobust.inv_level_sigma2(jnp.asarray(arrays["level"]))))
    th = np.where(np.asarray(is_stereo), jrobust.CHI2_STEREO, jrobust.CHI2_MONO)
    clear = np.abs(chi2 - th) > 1e-3
    np.testing.assert_array_equal(inl_t.numpy()[clear], np.asarray(inl_j)[clear])
    assert abs(int(n_t) - int(n_j)) <= int((~clear).sum())
    assert int(n_t) > 0.6 * arrays["valid"].sum()
