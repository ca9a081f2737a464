"""The point-chunked whole-map VI-BA of the port (`vi_bundle_adjust_chunked`)
against the JAX package on the CPU, and the twins of
`tests/test_vi_ba.py::TestChunkedVIBA`.

Both packages get the simulated window of `test_vi_ba.build_problem` (6
body states, 256 landmarks, camera == body), the port's copy through
`convert`; the JAX solver runs at matmul precision "high", which is float32
on the CPU. Bounds are `tests/test_torch_vi_ba.py`'s: after 4 iterations
rotations, positions and velocities within 1e-4, biases within 1e-5,
landmarks seen by >= 3 states within 1e-3, the damping equal to 1e-6
relative. After 10 iterations of seed 6 both LMs are at their float32
noise floor, where one may accept a step the other rejects: the states are
held within 2e-3 (landmarks 5e-3), and the port to the JAX test's bar.
Inside the port, the chunked solver equals the dense bite solver
(`vi_bundle_adjust_step`) within the same 4-iteration bounds, on one chunk
and on four."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vi_ba import JCAM, TCAM, _assert_states_close, _port
from test_vi_ba import build_problem
from orb_slam3_comments_ghr_tpu.optim import vi_ba as jvi_ba
from orb_slam3_comments_ghr_torch.optim import vi_ba as tvi_ba

torch.set_num_threads(1)

LAM0 = 1e-4


def _jax_chunked(prob, iters, point_chunk):
    with jax.default_matmul_precision("high"):
        return jvi_ba.vi_bundle_adjust_chunked(JCAM, prob, jnp.asarray(LAM0, jnp.float32),
                                               iters=iters, point_chunk=point_chunk)


def test_chunked_against_jax():
    """The twin of TestChunkedVIBA::test_matches_dense_bite_solver's
    problem, solved chunked in both packages."""
    prob, _ = build_problem(K=6, P=256, seed=5)
    out_j = _jax_chunked(prob, 4, 64)
    out_t = tvi_ba.vi_bundle_adjust_chunked(TCAM, _port(prob), torch.tensor(LAM0), iters=4,
                                            point_chunk=64)
    _assert_states_close(out_t[:5], out_j[:5], prob.obs_valid)
    np.testing.assert_allclose(float(out_t[5]), float(out_j[5]), rtol=1e-6)


def test_reduces_cost_multi_chunk_against_jax():
    """TestChunkedVIBA::test_reduces_cost_multi_chunk in both packages: 8
    chunks of 32 points, 10 iterations; the gauge state kept."""
    prob, (_, pg, _, _) = build_problem(K=6, P=256, seed=6)
    out_j = _jax_chunked(prob, 10, 32)
    tprob = _port(prob)
    out_t = tvi_ba.vi_bundle_adjust_chunked(TCAM, tprob, torch.tensor(LAM0), iters=10,
                                            point_chunk=32)
    _assert_states_close(out_t[:5], out_j[:5], prob.obs_valid, floor=2e-3)
    pwb = out_t[1]
    assert float(torch.linalg.norm(pwb - torch.tensor(np.asarray(pg)), dim=-1).max()) < 0.03
    torch.testing.assert_close(pwb[0], tprob.pwb[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("point_chunk", [256, 64])
def test_chunked_equals_dense(point_chunk):
    tprob = _port(build_problem(K=6, P=256, seed=5)[0])
    dense = tvi_ba.vi_bundle_adjust_step(TCAM, tprob, torch.tensor(LAM0), iters=4)
    chunked = tvi_ba.vi_bundle_adjust_chunked(TCAM, tprob, torch.tensor(LAM0), iters=4,
                                              point_chunk=point_chunk)
    _assert_states_close(chunked[:5], dense[:5], tprob.obs_valid.numpy())
    np.testing.assert_allclose(float(chunked[5]), float(dense[5]), rtol=1e-6)


def test_rig_observations_wait_for_fisheye():
    """Rig observations were refused until the fisheye slice (ROADMAP A7);
    now a rig whose every row is the keyframe's own camera (slot 0, the
    identity) gives the solver's result without a rig, bit for bit."""
    tprob = _port(build_problem(K=4, P=64, seed=1)[0])
    rig = tprob._replace(obs_rig=torch.zeros_like(tprob.obs_cam),
                         rig_R=torch.eye(3).repeat(2, 1, 1), rig_t=torch.zeros(2, 3))
    args = dict(iters=2, point_chunk=32)
    for a, b in zip(tvi_ba.vi_bundle_adjust_chunked(TCAM, rig, torch.tensor(LAM0), **args),
                    tvi_ba.vi_bundle_adjust_chunked(TCAM, tprob, torch.tensor(LAM0), **args)):
        assert torch.equal(a, b)
