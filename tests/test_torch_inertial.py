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
repairs (ROADMAP C1, a deliberate divergence): a visual row of weight 0 (an
invalid or outlier match, as every padded row of the tracker's local map)
has sqrt(w) at 0, whose forward derivative is NaN. With one such row every
JAX step is NaN and rejected: the state stays the prediction, and the next
prior is NaN. In the port such a row adds exactly 0 to the residual and the
Jacobian, so a run with zero-weight rows equals the run with those rows
removed: the same state (1e-6 absolute), inliers and count, and the next
prior's information within 1e-6 of its largest entry (the products sum
another number of terms). `test_invalid_row_freezes_the_state` shows the
JAX fault and the port's repair."""

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


def _off_prediction(tin):
    """The port's inputs with the start moved 3.7 cm off the (exact)
    prediction, so that a working refinement has somewhere to go."""
    state0 = tin[0]
    moved = state0._replace(pwb=state0.pwb + torch.tensor([0.03, -0.02, 0.01]))
    return (moved,) + tuple(tin[1:])


def test_invalid_row_freezes_the_state():
    """The JAX package does not move off the prediction with one invalid
    match and returns a NaN prior (ROADMAP C1). The port moves toward the
    true pose, returns a finite prior, and its next call from that prior
    moves as well."""
    jin, tin, (_, p2) = _vi_frame(n_valid=255)
    sj, _, nj, pj = jinertial.pose_inertial_optimize(JCAM, *jin, jinertial.empty_prior())
    assert np.array_equal(np.asarray(sj.pwb), np.asarray(jin[0].pwb))
    assert np.isnan(np.asarray(pj.H)).any()
    tin = _off_prediction(tin)
    st, _, nt, pt = tinertial.pose_inertial_optimize(TCAM, *tin, tinertial.empty_prior(device="cpu"))
    assert int(nt) == int(nj) == 255
    assert bool(torch.isfinite(pt.H).all()) and bool(pt.valid)
    p2 = torch.tensor(p2, dtype=torch.float32)
    err0 = float(torch.linalg.norm(tin[0].pwb - p2))
    assert not torch.equal(st.pwb, tin[0].pwb)
    assert float(torch.linalg.norm(st.pwb - p2)) < err0
    st2, _, nt2, pt2 = tinertial.pose_inertial_optimize(TCAM, *tin, pt)
    assert not torch.equal(st2.pwb, tin[0].pwb) and int(nt2) == 255
    assert float(torch.linalg.norm(st2.pwb - p2)) < err0
    assert bool(torch.isfinite(pt2.H).all())


@pytest.mark.parametrize("n_valid,with_prior", [(255, True), (200, True), (200, False)])
def test_zero_weight_rows_equal_removed_rows(n_valid, with_prior):
    """Rows of weight 0 (here the invalid tail) change nothing: the port's
    result equals its run on the valid rows alone, with an (empty) prior
    and without one (the tracker's call)."""
    _, tin, (_, p2) = _vi_frame(n_valid=n_valid)
    tin = _off_prediction(tin)
    state0, prev, pre, obs, Tcb = tin
    kept = tpose.PoseObs(*(a[:n_valid] for a in obs))
    prior = tinertial.empty_prior(device="cpu") if with_prior else None
    st, inl, n, pt = tinertial.pose_inertial_optimize(TCAM, *tin, prior)
    sk, inlk, nk, pk = tinertial.pose_inertial_optimize(TCAM, state0, prev, pre, kept, Tcb, prior)
    assert int(n) == int(nk) == n_valid
    assert torch.equal(inl[:n_valid], inlk) and not bool(inl[n_valid:].any())
    for k in ("Rwb", "pwb", "vel", "bias"):
        np.testing.assert_allclose(getattr(st, k).numpy(), getattr(sk, k).numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    if with_prior:
        np.testing.assert_allclose(pt.H.numpy(), pk.H.numpy(), rtol=0,
                                   atol=1e-6 * float(pk.H.abs().max()))
    else:
        assert pt is None and pk is None
    err0 = float(torch.linalg.norm(state0.pwb - torch.tensor(p2, dtype=torch.float32)))
    assert float(torch.linalg.norm(st.pwb - torch.tensor(p2, dtype=torch.float32))) < err0


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
