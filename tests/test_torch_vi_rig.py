"""Second-camera (fisheye rig) observations in the port's visual-inertial
BA, on the CPU: the twins of `tests/test_vi_ba.py::TestVIRigObservations`
(2), on the simulated window of `test_vi_ba.build_problem` (camera ==
body), in both packages.

Bounds: the JAX tests' bars on the port (landmarks seen only by the right
camera with >= 2 valid rows converge within 1 cm; the chunked solver with
an all-left rig within 5e-3 of the dense one without it) and the port's
solve within 1e-3 of the JAX package's (float32 LMs summing in another
order; `tests/test_torch_vi_ba.py`'s bound for landmarks)."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_vi_ba import JCAM, TCAM, _port
from test_vi_ba import CAM, build_problem
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import vi_ba as jvi_ba
from orb_slam3_comments_ghr_torch.optim import vi_ba as tvi_ba

torch.set_num_threads(1)


def _rig():
    R_rl = np.asarray(jlie.so3_exp(jnp.array([0.0, 0.02, 0.0])), np.float32).T
    t_rl = -R_rl @ np.array([0.11, 0.001, -0.002], np.float32)
    return (np.stack([np.eye(3, dtype=np.float32), R_rl]),
            np.stack([np.zeros(3, np.float32), t_rl]).astype(np.float32))


def _with_rig(prob, obs_rig, **fields):
    """The JAX problem with rig slots (and other fields replaced), and the
    port's copy."""
    rig_R, rig_t = _rig()
    jprob = prob._replace(obs_rig=jnp.asarray(obs_rig), rig_R=jnp.asarray(rig_R),
                          rig_t=jnp.asarray(rig_t), **fields)
    return jprob, _port(jprob)


def test_right_only_points_constrained_in_vi_ba():
    prob, _ = build_problem(K=6, P=128, seed=9, perturb=False)
    rig_R, rig_t = _rig()
    P, D = prob.obs_cam.shape
    n_r = 12
    obs_rig = np.zeros((P, D), np.int32)
    obs_rig[:n_r] = 1  # these points are seen only by the right camera
    Rcw = jnp.swapaxes(prob.Rwb, -1, -2)
    pc0 = (jnp.einsum("kij,pj->pki", Rcw, prob.p)
           - jnp.einsum("kij,kj->ki", Rcw, prob.pwb)[None])
    pc0 = jnp.take_along_axis(pc0, jnp.asarray(prob.obs_cam)[..., None], axis=1)
    pc = jnp.where(jnp.asarray(obs_rig)[..., None] == 1,
                   jnp.einsum("ij,pdj->pdi", jnp.asarray(rig_R[1]), pc0) + rig_t[1], pc0)
    uv = jcameras.project(CAM, pc)
    ok = np.asarray(prob.obs_valid) & np.asarray(pc[..., 2] > 0.5)
    p0 = np.array(prob.p)
    p0[:n_r] += np.random.default_rng(5).normal(0, 0.06, (n_r, 3)).astype(np.float32)
    jprob, tprob = _with_rig(prob, obs_rig, p=jnp.asarray(p0), obs_uv=uv,
                             obs_valid=jnp.asarray(ok))
    tp = tvi_ba.vi_bundle_adjust(TCAM, tprob, iters=15)[4].numpy()
    jp = np.asarray(jvi_ba.vi_bundle_adjust(JCAM, jprob, iters=15)[4])
    constrained = ok[:n_r].sum(1) >= 2
    assert int(constrained.sum()) >= 8
    for p in (tp, jp):
        err = np.linalg.norm(p[:n_r] - np.asarray(prob.p)[:n_r], axis=-1)
        assert float(err[constrained].max()) < 0.01, err
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)


def test_chunked_matches_dense_with_rig():
    prob, _ = build_problem(K=6, P=128, seed=10)
    P, D = prob.obs_cam.shape
    jprob, tprob_r = _with_rig(prob, np.zeros((P, D), np.int32))  # all-left rig
    lam0 = 1e-4
    out_d = tvi_ba.vi_bundle_adjust_step(TCAM, _port(prob), torch.tensor(lam0), iters=3)
    out_c = tvi_ba.vi_bundle_adjust_chunked(TCAM, tprob_r, torch.tensor(lam0), iters=3,
                                            point_chunk=64)
    for a, b in zip(out_d, out_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)
    out_j = jvi_ba.vi_bundle_adjust_chunked(JCAM, jprob, jnp.asarray(lam0, jnp.float32), iters=3,
                                            point_chunk=64)
    for a, b in zip(out_c, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)
