"""IMU preintegration and the IMU front end of the port against the JAX
package on the CPU, and the twins of `tests/test_imu.py`.

Both packages get the same seeded numpy samples. The JAX scan runs over a
power-of-two padded chunk, the port's loop over the live rows only (the
padding rows are no-ops in both). Bounds: dT bit-equal (the same float32
sums in the same order); dR, dV, dP and the bias Jacobians within 2e-6
absolute (|values| <= ~2); the covariance within 1e-5 of its largest entry
(XLA contracts its 9x9 products in another order); the information matrix
within 1e-4 relative to its largest entry (the inverse of a covariance
whose entries span 1e-10 to 1e-4); predictions and residuals within 1e-5.
`normalize_rotation` (Newton's polar iteration in the port, a float32 SVD
in JAX) within 2e-7 of a float64 SVD's answer and 1e-6 of JAX's (whose
float32 SVD is itself up to 8.3e-7 off here). The front end feeds both
packages the same rows and calls, and holds each result to the same
bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.ops import lie as jlie
from orb_slam3_comments_ghr_tpu.optim import imu as jimu
from orb_slam3_comments_ghr_tpu.pipeline import imu_frontend as jfront
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import lie as tlie
from orb_slam3_comments_ghr_torch.optim import imu as timu
from orb_slam3_comments_ghr_torch.pipeline import imu_frontend as tfront

torch.set_num_threads(1)

JCAL = jimu.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), noise_g=1e-2, noise_a=1e-1,
                     walk_g=1e-4, walk_a=1e-3)
TCAL = convert.imu_calib_from_jax(JCAL)
FIELDS = ("dR", "dV", "dP", "J_rg", "J_vg", "J_va", "J_pg", "J_pa")


def _samples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 1.0, (n, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, n).astype(np.float32)
    bias = rng.normal(0, 0.01, 6).astype(np.float32)
    return acc, gyr, dts, bias


def _pad(a, cap):
    out = np.zeros((cap,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _to_port(pre) -> timu.Preintegrated:
    return convert.preintegrated_from_numpy({k: np.asarray(v) for k, v in pre._asdict().items()},
                                            device="cpu")


def _assert_pre_close(tp, jp):
    assert float(tp.dT) == float(jp.dT)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), rtol=0,
                                   atol=2e-6, err_msg=k)
    C = np.asarray(jp.C)
    np.testing.assert_allclose(tp.C.numpy(), C, rtol=0, atol=1e-5 * np.abs(C).max())
    np.testing.assert_array_equal(tp.bias.numpy(), np.asarray(jp.bias))


@pytest.mark.parametrize("seed,n,cap", [(0, 10, 32), (1, 33, 64), (2, 100, 256)])
def test_preintegrate_unpadded_equals_padded(seed, n, cap):
    acc, gyr, dts, bias = _samples(seed, n)
    jp = jimu.preintegrate(*(jnp.asarray(_pad(a, cap)) for a in (acc, gyr, dts)),
                           jnp.asarray(bias), JCAL)
    tp = timu.preintegrate(*_t(acc, gyr, dts, bias), TCAL)
    _assert_pre_close(tp, jp)
    # the port takes padded chunks too, with the same result
    tpp = timu.preintegrate(*_t(_pad(acc, cap) + np.float32(99) * (np.arange(cap) >= n)[:, None],
                                _pad(gyr, cap), _pad(dts, cap), bias), TCAL)
    for k in ("dT",) + FIELDS + ("C",):
        torch.testing.assert_close(getattr(tpp, k), getattr(tp, k), rtol=0, atol=0)


def test_preintegrate_continue():
    acc, gyr, dts, bias = _samples(3, 40)
    j0 = jimu.preintegrate(*(jnp.asarray(_pad(a[:15], 32)) for a in (acc, gyr, dts)),
                           jnp.asarray(bias), JCAL)
    j1 = jimu.preintegrate_continue(j0, *(jnp.asarray(_pad(a[15:], 32)) for a in (acc, gyr, dts)),
                                    JCAL)
    t0 = timu.preintegrate(*_t(acc[:15], gyr[:15], dts[:15], bias), TCAL)
    t1 = timu.preintegrate_continue(t0, *_t(acc[15:], gyr[15:], dts[15:]), TCAL)
    _assert_pre_close(t1, j1)
    # continuing from the JAX result gives the same as continuing from the port's
    t1j = timu.preintegrate_continue(_to_port(j0), *_t(acc[15:], gyr[15:], dts[15:]), TCAL)
    _assert_pre_close(t1j, j1)


def test_delta_predict_residual_information():
    acc, gyr, dts, bias = _samples(4, 60)
    jp = jimu.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dts, bias)), JCAL)
    tp = _to_port(jp)
    rng = np.random.default_rng(5)
    new_bias = (bias + rng.normal(0, 0.005, 6)).astype(np.float32)
    for a, b in zip(timu.delta_with_bias(tp, torch.from_numpy(new_bias)),
                    jimu.delta_with_bias(jp, jnp.asarray(new_bias))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    R1 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1, 3), jnp.float32)))
    R2 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1, 3), jnp.float32)))
    p1, v1, p2, v2 = (rng.normal(0, 1, 3).astype(np.float32) for _ in range(4))
    Rwg = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.05, 0.0], jnp.float32)))
    for kw_j, kw_t in (({}, {}), (dict(Rwg=jnp.asarray(Rwg), scale=jnp.float32(1.7)),
                                  dict(Rwg=torch.tensor(Rwg), scale=torch.tensor(1.7)))):
        rj = jimu.inertial_residual(*(jnp.asarray(a) for a in (R1, p1, v1, R2, p2, v2, new_bias)),
                                    jp, **kw_j)
        rt = timu.inertial_residual(*_t(R1, p1, v1, R2, p2, v2, new_bias), tp, **kw_t)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    for a, b in zip(timu.predict_state(*_t(R1, p1, v1, new_bias), tp),
                    jimu.predict_state(*(jnp.asarray(a) for a in (R1, p1, v1, new_bias)), jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    info_j = np.asarray(jimu.information(jp))
    np.testing.assert_allclose(timu.information(tp).numpy(), info_j, rtol=0,
                               atol=1e-4 * np.abs(info_j).max())


def test_lie_additions():
    rng = np.random.default_rng(6)
    phi = rng.normal(0, 0.7, (64, 3)).astype(np.float32)
    phi[:4] *= 1e-6  # the small-angle branches
    for tf, jf in ((tlie.so3_right_jacobian, jlie.so3_right_jacobian),
                   (tlie.so3_right_jacobian_inv, jlie.so3_right_jacobian_inv)):
        np.testing.assert_allclose(tf(torch.from_numpy(phi)).numpy(),
                                   np.asarray(jf(jnp.asarray(phi))), rtol=0, atol=2e-6)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi))) + rng.normal(0, 1e-4, (64, 3, 3)).astype(np.float32)
    got = tlie.normalize_rotation(torch.from_numpy(R)).numpy()
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    np.testing.assert_allclose(got, U @ Vt, rtol=0, atol=2e-7)
    np.testing.assert_allclose(got, np.asarray(jlie.normalize_rotation(jnp.asarray(R))), rtol=0,
                               atol=1e-6)


def test_frontend_call_sequence():
    """The same rows and calls through both packages' ImuFrontend: frame
    preintegrations, the incremental and the raw since-KF ones, keyframe
    resets, and a bias change that drops the accumulator."""
    rng = np.random.default_rng(7)
    t = np.arange(1, 400) * 0.005
    rows = np.concatenate([t[:, None], rng.normal(0, 1, (len(t), 3)) + [0, 0, 9.81],
                           rng.normal(0, 0.3, (len(t), 3))], axis=1)
    jf, tf = jfront.ImuFrontend(JCAL), tfront.ImuFrontend(TCAL, device="cpu")
    frame_t = [0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5]
    t_kf = 0.0
    for i, ft in enumerate(frame_t):
        chunk = rows[(rows[:, 0] > (frame_t[i - 1] if i else -1)) & (rows[:, 0] <= ft)]
        jf.feed(chunk)
        tf.feed(chunk)
        pj, pt = jf.preintegrate_frame(ft), tf.preintegrate_frame(ft)
        assert (pj is None) == (pt is None) == (i == 0)
        if pj is None:
            jf.on_new_keyframe(ft)
            tf.on_new_keyframe(ft)
            continue
        _assert_pre_close(pt, pj)
        _assert_pre_close(tf.preintegrate_since_kf(t_kf, ft), jf.preintegrate_since_kf(t_kf, ft))
        if i == 4:  # a keyframe: the raw reintegration, then the reset
            _assert_pre_close(tf.preintegrate_since_kf(t_kf, ft, with_raw=True),
                              jf.preintegrate_since_kf(t_kf, ft, with_raw=True))
            jf.on_new_keyframe(ft)
            tf.on_new_keyframe(ft)
            t_kf = ft
        if i == 6:  # a new bias (after VI refinement)
            jf.bias = tf.bias = np.asarray([0.01, -0.02, 0.005, 0.1, 0.05, -0.1], np.float32)
    assert len(jf.queue) == len(tf.queue) and len(jf._since_kf) == len(tf._since_kf)


# ---------------------------------------------------------------- twins
def _simulate(T=100, hz=200.0, w_body=(0.1, -0.2, 0.3), a_world=(0.4, 0.1, -0.2), v0=(0.3, -0.1, 0.2)):
    """Perfect samples for a constant body rate and a constant world
    acceleration (test_imu.simulate)."""
    dt = 1.0 / hz
    w, a_w, v0 = (torch.tensor(x, dtype=torch.float32) for x in (w_body, a_world, v0))
    g = timu.gravity_vec(w)
    R0 = torch.eye(3)
    accs, gyrs = [], []
    for i in range(T):
        Ri = R0 @ tlie.so3_exp(w * (i * dt))
        accs.append(Ri.T @ (a_w - g))
        gyrs.append(w)
    total_t = T * dt
    R_end = R0 @ tlie.so3_exp(w * total_t)
    p_end = v0 * total_t + 0.5 * a_w * total_t ** 2
    v_end = v0 + a_w * total_t
    return (torch.stack(accs), torch.stack(gyrs), torch.full((T,), dt), R0, v0, R_end, p_end,
            v_end, total_t)


TCAL_DEFAULT = timu.default_calib()


def test_predict_matches_analytic():
    acc, gyr, dts, R0, v0, R_end, p_end, v_end, t = _simulate()
    pre = timu.preintegrate(acc, gyr, dts, torch.zeros(6), TCAL_DEFAULT)
    assert abs(float(pre.dT) - t) < 1e-6
    Rp, pp, vp = timu.predict_state(R0, torch.zeros(3), v0, torch.zeros(6), pre)
    torch.testing.assert_close(Rp, R_end, rtol=0, atol=2e-3)
    torch.testing.assert_close(pp, p_end, rtol=0, atol=2e-3)
    torch.testing.assert_close(vp, v_end, rtol=0, atol=5e-3)


def test_padding_ignored():
    acc, gyr, dts, *_ = _simulate(T=50)
    p1 = timu.preintegrate(acc, gyr, dts, torch.zeros(6), TCAL_DEFAULT)
    p2 = timu.preintegrate(torch.cat([acc, torch.ones((30, 3)) * 99]),
                           torch.cat([gyr, torch.ones((30, 3)) * 99]),
                           torch.cat([dts, torch.zeros(30)]), torch.zeros(6), TCAL_DEFAULT)
    torch.testing.assert_close(p1.dR, p2.dR, rtol=0, atol=1e-6)
    torch.testing.assert_close(p1.dP, p2.dP, rtol=0, atol=1e-6)
    assert abs(float(p1.dT) - float(p2.dT)) < 1e-7


def test_residual_zero_at_ground_truth():
    acc, gyr, dts, R0, v0, R_end, p_end, v_end, t = _simulate()
    pre = timu.preintegrate(acc, gyr, dts, torch.zeros(6), TCAL_DEFAULT)
    r = timu.inertial_residual(R0, torch.zeros(3), v0, R_end, p_end, v_end, torch.zeros(6), pre)
    assert float(torch.linalg.norm(r)) < 0.01


def test_bias_jacobian_first_order():
    """delta_with_bias's linearization against an exact reintegration."""
    acc, gyr, dts, *_ = _simulate()
    b0 = torch.zeros(6)
    db = torch.tensor([0.004, -0.003, 0.002, 0.03, -0.02, 0.04])
    pre0 = timu.preintegrate(acc, gyr, dts, b0, TCAL_DEFAULT)
    pre1 = timu.preintegrate(acc, gyr, dts, b0 + db, TCAL_DEFAULT)
    dR, dV, dP = timu.delta_with_bias(pre0, b0 + db)
    torch.testing.assert_close(dR, pre1.dR, rtol=0, atol=2e-3)
    torch.testing.assert_close(dV, pre1.dV, rtol=0, atol=2e-3)
    torch.testing.assert_close(dP, pre1.dP, rtol=0, atol=2e-3)


def test_covariance_grows():
    acc, gyr, dts, *_ = _simulate(T=40)
    pre_s = timu.preintegrate(acc[:20], gyr[:20], dts[:20], torch.zeros(6), TCAL_DEFAULT)
    pre_l = timu.preintegrate(acc, gyr, dts, torch.zeros(6), TCAL_DEFAULT)
    assert float(torch.trace(pre_l.C[:9, :9])) > float(torch.trace(pre_s.C[:9, :9]))
    info = timu.information(pre_l)
    assert float(torch.linalg.eigvalsh(0.5 * (info + info.T)).min()) > 0


def test_gravity_only_free_fall():
    """A static body reads +g; the prediction stays in place."""
    T = 200
    acc = torch.tensor([[0.0, 0.0, timu.GRAVITY]]).repeat(T, 1)
    pre = timu.preintegrate(acc, torch.zeros((T, 3)), torch.full((T,), 1.0 / 200.0),
                            torch.zeros(6), TCAL_DEFAULT)
    _, pp, vp = timu.predict_state(torch.eye(3), torch.zeros(3), torch.zeros(3), torch.zeros(6), pre)
    torch.testing.assert_close(pp, torch.zeros(3), rtol=0, atol=1e-4)
    torch.testing.assert_close(vp, torch.zeros(3), rtol=0, atol=1e-4)
