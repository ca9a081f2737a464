"""Windowed visual-inertial BA of the port against the JAX package on the
CPU, and the twins of `tests/test_vi_ba.py::TestVIBA`.

Both packages get the simulated window of `test_vi_ba.build_problem` (6
body states, 200 landmarks, camera == body), the port's copy through
`convert`. Bounds, two float32 LMs that sum in another order: rotations,
positions and velocities within 1e-4, biases within 1e-5, landmarks seen by
>= 3 states within 1e-3 (a landmark seen twice is weakly held along its ray
and drifts apart by up to ~4 cm over 15 iterations, in both packages
alike), the same inliers, costs within 1e-4 relative. Once an LM reaches
its float32 noise floor, one package may accept a step the other rejects
(seed 2: at iteration 7 the cost change is below float32 resolution, and
the accepted step moves positions by ~1e-3): there the states are held
within 2e-3 of each other (landmarks 5e-3), and the port to the twin's
bar. Chained
`vi_bundle_adjust_step` bites equal one run, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_vi_ba import build_problem
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.optim import vi_ba as jvi_ba
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie
from orb_slam3_comments_ghr_torch.optim import vi_ba as tvi_ba

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
NAMES = ("Rwb", "pwb", "vel", "bias", "p")
TOL = {"Rwb": 1e-4, "pwb": 1e-4, "vel": 1e-4, "bias": 1e-5}


def _port(prob) -> tvi_ba.VIBAProblem:
    arrays = {k: np.asarray(v) for k, v in prob._asdict().items()
              if k in tvi_ba.VIBAProblem._fields and k != "pre"}
    arrays["pre"] = {k: np.asarray(v) for k, v in prob.pre._asdict().items()}
    return convert.vi_ba_problem_from_numpy(arrays, device="cpu")


def _assert_states_close(out_t, out_j, obs_valid, floor=None):
    for name, a, b in zip(NAMES, out_t, out_j):
        a, b = a.numpy(), np.asarray(b)
        if name == "p":
            held = np.asarray(obs_valid).sum(1) >= 3
            np.testing.assert_allclose(a[held], b[held], rtol=0, atol=2.5 * floor if floor else 1e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=floor or TOL[name], err_msg=name)


@pytest.mark.parametrize("seed,iters,floor", [(0, 15, None), (2, 6, None), (2, 12, 2e-3)])
def test_vi_bundle_adjust_against_jax(seed, iters, floor):
    prob, (_, pg, _, _) = build_problem(seed=seed)
    out_j = jvi_ba.vi_bundle_adjust(JCAM, prob, iters=iters)
    out_t = tvi_ba.vi_bundle_adjust(TCAM, _port(prob), iters=iters)
    _assert_states_close(out_t[:5], out_j[:5], prob.obs_valid, floor)
    np.testing.assert_array_equal(out_t[5].numpy(), np.asarray(out_j[5]))
    np.testing.assert_allclose(float(out_t[6]), float(out_j[6]), rtol=1e-4)
    assert float(np.abs(out_t[1].numpy() - np.asarray(pg)).max()) < 0.02


def test_vi_bundle_adjust_step_against_jax():
    prob, _ = build_problem(K=6, P=256, seed=5)
    lam0 = 1e-4
    out_j = jvi_ba.vi_bundle_adjust_step(JCAM, prob, jnp.asarray(lam0, jnp.float32), iters=4)
    tprob = _port(prob)
    out_t = tvi_ba.vi_bundle_adjust_step(TCAM, tprob, torch.tensor(lam0), iters=4)
    _assert_states_close(out_t[:5], out_j[:5], prob.obs_valid)
    np.testing.assert_allclose(float(out_t[5]), float(out_j[5]), rtol=1e-6)
    # two bites of 2 chain to the same bits as one of 4
    Rwb, pwb, vel, bias, p, lam = tvi_ba.vi_bundle_adjust_step(TCAM, tprob, torch.tensor(lam0),
                                                               iters=2)
    chained = tvi_ba.vi_bundle_adjust_step(
        TCAM, tprob._replace(Rwb=Rwb, pwb=pwb, vel=vel, bias=bias, p=p), lam, iters=2)
    for a, b in zip(chained, out_t):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- twins
def test_recovers_states():
    prob, (Rg, pg, vg, _) = build_problem()
    Rwb, pwb, vel, _, _, _, _ = tvi_ba.vi_bundle_adjust(TCAM, _port(prob), iters=15)
    assert float(torch.linalg.norm(pwb - torch.tensor(np.asarray(pg)), dim=-1).max()) < 0.02
    assert float(torch.linalg.norm(vel - torch.tensor(np.asarray(vg)), dim=-1).max()) < 0.08
    dR = Rwb @ torch.tensor(np.asarray(Rg)).transpose(-1, -2)
    assert float(torch.linalg.norm(tlie.so3_log(dR), dim=-1).max()) < 0.01


def test_reduces_cost():
    prob = _port(build_problem(seed=2)[0])
    c0 = tvi_ba.vi_bundle_adjust(TCAM, prob, iters=0)[6]
    c1 = tvi_ba.vi_bundle_adjust(TCAM, prob, iters=12)[6]
    assert float(c1) < 0.2 * float(c0)


def test_fixed_state_unmoved():
    prob = _port(build_problem(seed=3)[0])
    Rwb, pwb = tvi_ba.vi_bundle_adjust(TCAM, prob, iters=8)[:2]
    torch.testing.assert_close(Rwb[0], prob.Rwb[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(pwb[0], prob.pwb[0], rtol=0, atol=1e-4)


def test_imu_constrains_scale_drift():
    """With IMU factors a global scale error of the initial guess is
    corrected, which a visual BA cannot do."""
    prob, (_, pg, _, _) = build_problem(seed=4, perturb=False)
    prob = _port(prob)
    s = 1.05
    prob_s = prob._replace(pwb=prob.pwb[0] + (prob.pwb - prob.pwb[0]) * s,
                           p=prob.pwb[0] + (prob.p - prob.pwb[0]) * s, vel=prob.vel * s)
    pwb = tvi_ba.vi_bundle_adjust(TCAM, prob_s, iters=15)[1]
    pg = torch.tensor(np.asarray(pg))
    ratio = (torch.linalg.norm(pwb[1:] - pwb[0], dim=-1)
             / torch.clamp_min(torch.linalg.norm(pg[1:] - pg[0], dim=-1), 1e-6))
    assert float((ratio - 1.0).abs().max()) < 0.02, ratio
