"""Inertial initialization, scale refinement and visual-inertial pose
optimization of the port against the JAX package on the CPU, and the twins
of `tests/test_inertial.py`.

Both packages get the same simulated window: the states and
preintegrations of `test_inertial.simulate_vi_sequence` (the port's copies
of the preintegrations come through `convert`). Bounds, float32 LMs that
sum in another order than XLA: gravity rotation within 1e-4, scale within
1e-4 relative, bias within 1e-4, velocities within 1e-3 m/s (a 30-step LM
on up to 30 unknowns), final costs within 1e-5 absolute and relative
(the costs run from float32 noise, ~5e-5, to ~360);
`pose_inertial_optimize` state within 1e-4 (1e-3 for the velocity), the
same inlier set, the next prior's information within 1e-3 of its largest
entry.

`pose_inertial_optimize` has a fault in the JAX package that the port
keeps (ROADMAP C): a visual row of weight 0 (an invalid or outlier match,
as every padded row of the tracker's local map) has sqrt(w) at 0, whose
forward derivative is NaN. With one such row every step is NaN and
rejected: the state stays the prediction, and the next prior is NaN.
`test_invalid_row_freezes_the_state` shows it in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_inertial import simulate_vi_sequence
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import imu as jimu, inertial as jinertial, pose_opt as jpose
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie
from orb_slam3_comments_ghr_torch.optim import inertial as tinertial
from orb_slam3_comments_ghr_torch.optim import pose_opt as tpose

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _windows(seed, s_true, tilt, bias_true):
    """(JAX window, port window, truth) of a K=8 simulated window: the
    visual frame rotated by exp(tilt) and shrunk by s_true."""
    states, pre, _ = simulate_vi_sequence(bias=bias_true, seed=seed)
    K = len(states)
    G = np.asarray(jlie.so3_exp(jnp.asarray(tilt, jnp.float32)))
    Rwb = np.stack([G @ s[0] for s in states]).astype(np.float32)
    pwb = np.stack([G @ s[1] / s_true for s in states]).astype(np.float32)
    v0 = np.zeros((K, 3), np.float32)
    jwin = jinertial.InertialWindow(Rwb=jnp.asarray(Rwb), pwb=jnp.asarray(pwb), vel0=jnp.asarray(v0),
                                    pre=pre, valid=jnp.ones(K - 1, bool))
    twin = tinertial.InertialWindow(Rwb=torch.from_numpy(Rwb), pwb=torch.from_numpy(pwb),
                                    vel0=torch.from_numpy(v0),
                                    pre=convert.preintegrated_from_numpy(_np(pre), device="cpu"),
                                    valid=torch.ones(K - 1, dtype=torch.bool))
    v_true = np.stack([G @ s[2] / s_true for s in states])
    return jwin, twin, G, v_true


@pytest.mark.parametrize("mono,prior_a", [(True, 1e5), (False, 1e5), (False, 0.0)])
def test_inertial_init_against_jax(mono, prior_a):
    bias_true = np.array([0.004, -0.006, 0.003, 0.05, -0.08, 0.04]) if mono else np.zeros(6)
    jwin, twin, _, _ = _windows(3 if mono else 4, 3.0 if mono else 1.0, [0.08, -0.12, 0.0],
                                bias_true)
    out_j = jinertial.inertial_init(jwin, prior_g=1e2 if prior_a else 0.0, prior_a=prior_a,
                                    optimize_scale=mono)
    out_t = tinertial.inertial_init(twin, prior_g=1e2 if prior_a else 0.0, prior_a=prior_a,
                                    optimize_scale=mono)
    for name, a, b, tol in zip(("Rwg", "scale", "bias", "vel"), out_t[:4], out_j[:4],
                               (1e-4, 1e-4 * float(out_j[1]), 1e-4, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(float(out_t[4]), float(out_j[4]), rtol=1e-5, atol=1e-5)


def test_scale_gravity_refine_against_jax():
    jwin, twin, G, v_true = _windows(3, 1.3, [0.05, 0.02, 0.0], np.zeros(6))
    vel = (v_true * 1.3).astype(np.float32)  # metric velocities in the shrunk frame
    jwin, twin = jwin._replace(vel0=jnp.asarray(vel)), twin._replace(vel0=torch.from_numpy(vel))
    Rj, sj = jinertial.scale_gravity_refine(jwin, jnp.zeros(6))
    Rt, st = tinertial.scale_gravity_refine(twin, torch.zeros(6))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-4)


def _vi_frame(n_valid=256, seed=5):
    """(JAX inputs, port inputs, truth) of one VI tracking frame: 256
    matches seen from the true current pose, the IMU-predicted start, the
    first n_valid matches valid."""
    states, pre_stack, _ = simulate_vi_sequence(K=2, seed=seed)
    (R1, p1, v1), (R2, p2, v2) = states
    pre = jax.tree.map(lambda a: a[0], pre_stack)
    key = jax.random.PRNGKey(0)
    uv = jax.random.uniform(key, (256, 2)) * jnp.array([700.0, 440.0]) + 20
    z = jax.random.uniform(jax.random.fold_in(key, 1), (256, 1)) * 8 + 4
    pw = (jnp.asarray(R2) @ (jcameras.unproject(JCAM, uv) * z).T).T + jnp.asarray(p2)
    uv_obs = uv + jax.random.normal(jax.random.fold_in(key, 2), (256, 2)) * 0.4
    obs = jpose.PoseObs(p_world=pw.astype(jnp.float32), uv=uv_obs, u_right=jnp.full((256,), -1.0),
                        level=jnp.zeros((256,), jnp.int32), valid=jnp.arange(256) < n_valid)
    prev = jinertial.VIState(Rwb=jnp.asarray(R1, jnp.float32), pwb=jnp.asarray(p1, jnp.float32),
                             vel=jnp.asarray(v1, jnp.float32), bias=jnp.zeros(6))
    Rp, pp, vp = jimu.predict_state(prev.Rwb, prev.pwb, prev.vel, prev.bias, pre)
    state0 = jinertial.VIState(Rwb=Rp, pwb=pp, vel=vp, bias=prev.bias)
    jin = (state0, prev, pre, obs, (jnp.eye(3), jnp.zeros(3)))
    tin = (convert.vi_state_from_numpy(_np(state0), device="cpu"),
           convert.vi_state_from_numpy(_np(prev), device="cpu"),
           convert.preintegrated_from_numpy(_np(pre), device="cpu"),
           tpose.PoseObs(**{k: torch.from_numpy(np.array(v)) for k, v in _np(obs).items()}),
           (torch.eye(3), torch.zeros(3)))
    return jin, tin, (R2, p2)


def test_pose_inertial_optimize_against_jax():
    jin, tin, _ = _vi_frame()
    sj, ij, nj, pj = jinertial.pose_inertial_optimize(JCAM, *jin, jinertial.empty_prior())
    st, it, nt, pt = tinertial.pose_inertial_optimize(TCAM, *tin, tinertial.empty_prior(device="cpu"))
    assert int(nt) == int(nj) and np.array_equal(it.numpy(), np.asarray(ij))
    for k, tol in (("Rwb", 1e-4), ("pwb", 1e-4), ("vel", 1e-3), ("bias", 1e-4)):
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)), rtol=0,
                                   atol=tol, err_msg=k)
    H = np.asarray(pj.H)
    np.testing.assert_allclose(pt.H.numpy(), H, rtol=0, atol=1e-3 * np.abs(H).max())
    # the prior chain: a second frame from this prior
    prior_t = convert.vi_prior_from_numpy(_np(pj), device="cpu")
    sj2, _, nj2, _ = jinertial.pose_inertial_optimize(JCAM, *jin, pj)
    st2, _, nt2, _ = tinertial.pose_inertial_optimize(TCAM, *tin, prior_t)
    assert int(nt2) == int(nj2)
    np.testing.assert_allclose(st2.pwb.numpy(), np.asarray(sj2.pwb), rtol=0, atol=1e-4)


def test_invalid_row_freezes_the_state():
    """The fault kept from the JAX package (module docstring): with one
    invalid match neither package moves off the prediction, and both
    return a NaN prior; the port's next call takes that prior without
    raising, and again does not move."""
    jin, tin, _ = _vi_frame(n_valid=255)
    sj, _, nj, pj = jinertial.pose_inertial_optimize(JCAM, *jin, jinertial.empty_prior())
    st, _, nt, pt = tinertial.pose_inertial_optimize(TCAM, *tin, tinertial.empty_prior(device="cpu"))
    for s, s0 in ((sj.pwb, jin[0].pwb), (st.pwb, tin[0].pwb)):
        assert np.array_equal(np.asarray(s), np.asarray(s0))
    assert int(nt) == int(nj)
    assert np.isnan(np.asarray(pj.H)).any() and bool(torch.isnan(pt.H).any())
    st2, _, nt2, _ = tinertial.pose_inertial_optimize(TCAM, *tin, pt)
    assert torch.equal(st2.pwb, tin[0].pwb) and int(nt2) == int(nt)


# ---------------------------------------------------------------- twins
def test_recovers_scale_gravity_bias():
    s_true = 3.0
    bias_true = np.array([0.004, -0.006, 0.003, 0.05, -0.08, 0.04])
    _, win, G, v_true = _windows(3, s_true, [0.08, -0.12, 0.0], bias_true)
    Rwg, s, bias, vel, _ = tinertial.inertial_init(win, prior_g=1e2, prior_a=1e5,
                                                   optimize_scale=True)
    assert abs(float(s) - s_true) / s_true < 0.05, float(s)
    g_est = Rwg.numpy() @ np.array([0, 0, -1.0])
    assert np.dot(g_est, G @ np.array([0, 0, -1.0])) > 0.999
    np.testing.assert_allclose(bias[:3].numpy(), bias_true[:3], atol=0.01)
    assert np.linalg.norm(vel.numpy() - v_true, axis=1).max() < 0.1


def test_stereo_mode_scale_fixed():
    _, win, G, _ = _windows(4, 1.0, [0.05, 0.02, 0.0], np.zeros(6))
    Rwg, s, _, _, _ = tinertial.inertial_init(win, prior_g=1e2, prior_a=1e5, optimize_scale=False)
    assert float(s) == 1.0
    assert np.dot(Rwg.numpy() @ np.array([0, 0, -1.0]), G @ np.array([0, 0, -1.0])) > 0.999


def test_tracks_with_imu_and_vision():
    _, tin, (R2, p2) = _vi_frame()
    st, _, n, nxt = tinertial.pose_inertial_optimize(TCAM, *tin, tinertial.empty_prior(device="cpu"))
    assert int(n) > 240
    assert float(torch.linalg.norm(st.pwb - torch.tensor(p2, dtype=torch.float32))) < 0.02
    dR = st.Rwb @ torch.tensor(R2, dtype=torch.float32).T
    assert float(torch.linalg.norm(tlie.so3_log(dR))) < 0.01
    assert bool(nxt.valid)
    assert np.linalg.eigvalsh(nxt.H.numpy().astype(np.float64)).min() > -1e-3
