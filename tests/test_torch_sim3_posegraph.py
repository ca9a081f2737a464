"""Sim(3) estimation and the essential graph through the port, against the
JAX package: the twin of `tests/test_sim3_posegraph.py` (all 14 cases),
with the Sim(3) group, Horn's closed form and the port's own minimal-set
draw.

Each case runs both packages on the same inputs and holds the port to the
JAX test's bars. Bounds:
- the Sim(3) group: exp within 1e-6, log within 1e-5 (the port inverts W by
  cofactors, JAX solves);
- `horn_sim3`: s and R within 1e-5, t within 1e-4 (the port takes the
  rotation from Jacobi sweeps in float64, JAX from a float32 SVD);
- `sim3_ransac`, fed the minimal sets JAX draws from its key (`gumbel` and
  `top_k`): s and R within 1e-5, t within 1e-4, the inlier masks equal but
  for at most 2 rows at the chi2 threshold;
- `optimize_sim3`: s and R within 1e-5, t within 1e-4, inlier counts
  within 2;
- the dense and CG pose graphs and `solve_pose_graph`: s and R within 1e-5,
  t within 1e-4, costs within 1e-4 relative (float32 Gauss-Newton with
  another summation order).
The 4096-keyframe CG case runs the port alone, on a ring built in numpy,
to the JAX test's bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sim3_posegraph import TestPoseGraph as JaxPoseGraph, sim3_pair
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import posegraph as jposegraph, sim3 as jsim3
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, lie as tlie
from orb_slam3_comments_ghr_torch.optim import posegraph as tposegraph, sim3 as tsim3

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port, ref, s_tol=1e-5, R_tol=1e-5, t_tol=1e-4):
    for a, b, tol in zip(port, ref, (s_tol, R_tol, t_tol)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


def rot_err(R, R_ref) -> float:
    return float(torch.linalg.norm(tlie.so3_log(R @ T(R_ref).T)))


def test_sim3_group_against_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (64, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-7   # rotation below the small-angle branch
    xi[8:16, 6] *= 1e-7   # scale below the small-sigma branch
    xi[16:20, 3:7] *= 1e-7
    ref = jlie.sim3_exp(jnp.asarray(xi))
    port = tlie.sim3_exp(T(xi))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlie.sim3_log(*port).numpy(),
                               np.asarray(jlie.sim3_log(*ref)), rtol=0, atol=1e-5)
    a, b = port, tuple(x.flip(0) for x in port)
    ja, jb = ref, tuple(x[::-1] for x in ref)
    for p, r in zip(tlie.sim3_mul(*a, *b), jlie.sim3_mul(*ja, *jb)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    for p, r in zip(tlie.sim3_inv(*a), jlie.sim3_inv(*ja)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    pts = rng.normal(0, 3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.sim3_apply(*a, T(pts)).numpy(),
                               np.asarray(jlie.sim3_apply(*ja, jnp.asarray(pts))), atol=1e-5)
    R, t = tlie.se3_exp(T(xi[:, :6]))
    np.testing.assert_allclose(tlie.se3_log(R, t).numpy(),
                               np.asarray(jlie.se3_log(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_against_jax(fix_scale):
    p1, p2, _, _ = sim3_pair(jax.random.PRNGKey(7), n=40, noise=0.02)
    for sl in (slice(0, 3), slice(0, 40)):  # a minimal set (rank-2) and a full one
        ref = jsim3.horn_sim3(p1[sl], p2[sl], fix_scale)
        close(tsim3.horn_sim3(T(p1[sl]), T(p2[sl]), fix_scale), ref)


def jax_draw(key, valid, n_hyp=tsim3.RANSAC_ITERS):
    """The minimal sets `jsim3.sim3_ransac` draws from `key`."""
    g = jax.random.gumbel(key, (n_hyp, valid.shape[0])) + jnp.where(valid, 0.0, -1e9)[None]
    return np.asarray(jax.lax.top_k(g, 3)[1])


def both_ransac(p1, p2, valid, key, fix_scale=False):
    lv = jnp.zeros(p1.shape[0], jnp.int32)
    ref = jsim3.sim3_ransac(JCAM, p1, p2, lv, lv, valid, key, fix_scale=fix_scale)
    port = tsim3.sim3_ransac(TCAM, T(p1), T(p2), T(lv), T(lv), T(valid), T(jax_draw(key, valid)),
                             fix_scale=fix_scale)
    close(port[:3], ref[:3])
    assert int((port[3].numpy() != np.asarray(ref[3])).sum()) <= 2
    return port


class TestSim3Ransac:
    def test_recovers_similarity(self):
        p1, p2, (s, R, t), valid = sim3_pair(jax.random.PRNGKey(0))
        se, Re, te, inl, n = both_ransac(p1, p2, valid, jax.random.PRNGKey(1))
        assert abs(float(se) - 1.3) < 0.02
        assert rot_err(Re, R) < 0.02
        assert int(n) > 150

    def test_with_outliers(self):
        p1, p2, (s, R, t), valid = sim3_pair(jax.random.PRNGKey(2), outliers=0.3)
        se, Re, te, inl, n = both_ransac(p1, p2, valid, jax.random.PRNGKey(3))
        assert abs(float(se) - 1.3) < 0.05
        assert rot_err(Re, R) < 0.05

    def test_fix_scale(self):
        p1, p2, (s, R, t), valid = sim3_pair(jax.random.PRNGKey(4), scale=1.0)
        se, Re, te, inl, n = both_ransac(p1, p2, valid, jax.random.PRNGKey(5), fix_scale=True)
        assert float(se) == 1.0
        assert int(n) > 150

    def test_optimize_refines(self):
        p1, p2, (s, R, t), valid = sim3_pair(jax.random.PRNGKey(6), noise=0.005)
        lv = jnp.zeros(p1.shape[0], jnp.int32)
        uv1, uv2 = jcameras.project(JCAM, p1), jcameras.project(JCAM, p2)
        s0 = s * 1.05
        R0 = jlie.so3_exp(jnp.array([0.02, 0.0, -0.01])) @ R
        t0 = t + 0.05
        ref = jsim3.optimize_sim3(JCAM, s0, R0, t0, p1, uv1, lv, p2, uv2, lv, valid)
        args = [T(a) for a in (p1, uv1, lv, p2, uv2, lv, valid)]
        se, Re, te, inl, n = tsim3.optimize_sim3(
            TCAM, *convert.sim3_from_numpy(s0, R0, t0, device="cpu"), *args)
        close((se, Re, te), ref[:3])
        assert abs(int(n) - int(ref[4])) <= 2
        assert abs(float(se) - float(s)) < 0.01
        assert rot_err(Re, R) < 0.01
        assert int(n) > 150

    def test_draw_minimal_sets(self):
        """The port's own draw: three distinct valid rows per hypothesis,
        the same sets from the same seed."""
        valid = torch.zeros(50, dtype=torch.bool)
        valid[::3] = True
        draw = lambda seed: tsim3.draw_minimal_sets(valid, torch.Generator().manual_seed(seed))
        idx = draw(11)
        assert idx.shape == (tsim3.RANSAC_ITERS, 3)
        assert bool(valid[idx].all())
        assert bool((idx[:, 0] != idx[:, 1]).all() & (idx[:, 1] != idx[:, 2]).all()
                    & (idx[:, 0] != idx[:, 2]).all())
        assert torch.equal(idx, draw(11)) and not torch.equal(idx, draw(12))


def port_problem(prob):
    return convert.pose_graph_from_numpy({k: np.asarray(v) for k, v in prob._asdict().items()},
                                         device="cpu")


def same_solution(port, ref):
    close(port[:3], ref[:3])
    np.testing.assert_allclose(port[3].numpy(), np.asarray(ref[3]), rtol=1e-4, atol=1e-6)


def centres(s, R, t) -> torch.Tensor:
    return -torch.einsum("kji,kj->ki", R, t / s[:, None])


class TestPoseGraph:
    _ring_problem = JaxPoseGraph._ring_problem

    def test_corrects_drift(self):
        prob, (s_gt, R_gt, t_gt) = self._ring_problem()
        ref = jposegraph.optimize_pose_graph(prob, iters=20)
        s, R, t, costs = port = tposegraph.optimize_pose_graph(port_problem(prob), iters=20)
        same_solution(port, ref)
        assert rot_err(T(prob.R)[-1], R_gt[-1]) > 0.2
        assert rot_err(R[-1], R_gt[-1]) < 0.05
        c_gt = -torch.einsum("kji,kj->ki", T(R_gt), T(t_gt))
        assert float(torch.linalg.norm(centres(s, R, t) - c_gt, dim=-1).max()) < 0.25

    def test_fixed_vertex_unmoved(self):
        prob, _ = self._ring_problem()
        ref = jposegraph.optimize_pose_graph(prob, iters=10)
        s, R, t, _ = port = tposegraph.optimize_pose_graph(port_problem(prob), iters=10)
        same_solution(port, ref)
        np.testing.assert_allclose(R[0].numpy(), np.asarray(prob.R[0]), atol=1e-5)
        np.testing.assert_allclose(t[0].numpy(), np.asarray(prob.t[0]), atol=1e-4)

    def test_dof4_freezes_scale(self):
        prob, _ = self._ring_problem()
        ref = jposegraph.optimize_pose_graph(prob, iters=10, dof4=True)
        port = tposegraph.optimize_pose_graph(port_problem(prob), iters=10, dof4=True)
        same_solution(port, ref)
        np.testing.assert_allclose(port[0].numpy(), 1.0, atol=1e-3)


def numpy_ring(K: int, drift_per_step: float):
    """The JAX test's `_ring_problem` in numpy float32 (for K = 4096, where
    the JAX test's per-step dispatches take a minute): cameras on a
    circle of radius 3, odometry with a yaw bias per step, consecutive
    edges measured from the drifted poses, the loop edge K-1 -> 0 exact."""
    def yaw(a):  # so3_exp([0, a, 0])
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R_gt = np.stack([yaw(a) for a in ang])
    c_gt = np.stack([np.sin(ang) * 3, np.zeros(K), -np.cos(ang) * 3], -1).astype(np.float32)
    t_gt = -np.einsum("kij,kj->ki", R_gt, c_gt)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    dR = yaw(drift_per_step)
    for k in range(1, K):
        R_rel = R_gt[k] @ R_gt[k - 1].T
        t_rel = t_gt[k] - R_rel @ t_gt[k - 1]
        R_rel = R_rel @ dR
        R0.append(R_rel @ R0[-1])
        t0.append(R_rel @ t0[-1] + t_rel)
    R0, t0 = np.stack(R0).astype(np.float32), np.stack(t0).astype(np.float32)

    def rel(Ra, ta, Rb, tb):
        R = Ra @ np.swapaxes(Rb, -1, -2)
        return R, ta - np.einsum("kij,kj->ki", R, tb)

    ei = np.arange(1, K)
    ej = ei - 1
    cross = np.arange(64, K, 64)  # the long-range edges of the JAX test
    ei, ej = np.concatenate([ei, [K - 1], cross]), np.concatenate([ej, [0], cross - 32])
    eR, et = rel(R0[ei], t0[ei], R0[ej], t0[ej])
    eR[K - 1], et[K - 1] = rel(R_gt[K - 1:], t_gt[K - 1:], R_gt[:1], t_gt[:1])
    w = np.ones(len(ei), np.float32)
    w[K - 1] = 5.0
    prob = dict(s=np.ones(K), R=R0, t=t0, fixed=np.arange(K) == 0, e_i=ei, e_j=ej,
                e_s=np.ones(len(ei)), e_R=eR, e_t=et, e_valid=np.ones(len(ei), bool), e_weight=w)
    return convert.pose_graph_from_numpy(prob, device="cpu"), R_gt


class TestPoseGraphCG(TestPoseGraph):
    def test_cg_matches_dense(self):
        prob, _ = self._ring_problem()
        ref = jposegraph.optimize_pose_graph_cg(prob, iters=15, cg_iters=120)
        port = tposegraph.optimize_pose_graph_cg(port_problem(prob), iters=15, cg_iters=120)
        same_solution(port, ref)
        dense = tposegraph.optimize_pose_graph(port_problem(prob), iters=15)
        assert float(torch.linalg.norm(centres(*dense[:3]) - centres(*port[:3]), dim=-1).max()) < 0.03

    def test_cg_corrects_drift(self):
        prob, (s_gt, R_gt, t_gt) = self._ring_problem()
        ref = jposegraph.optimize_pose_graph_cg(prob, iters=20)
        port = tposegraph.optimize_pose_graph_cg(port_problem(prob), iters=20)
        same_solution(port, ref)
        assert rot_err(port[1][-1], R_gt[-1]) < 0.05

    def test_4k_keyframes_scale(self):
        prob, R_gt = numpy_ring(4096, 0.0005)
        pre_err = rot_err(prob.R[-1], R_gt[-1])
        s, R, t, _ = tposegraph.optimize_pose_graph_cg(prob, iters=10, cg_iters=150)
        post_err = rot_err(R[-1], R_gt[-1])
        assert pre_err > 0.5, pre_err
        assert post_err < 0.1 * pre_err, (pre_err, post_err)

    def test_solve_dispatch(self):
        prob, _ = self._ring_problem()
        ref = jposegraph.solve_pose_graph(prob, iters=5)
        port = tposegraph.solve_pose_graph(port_problem(prob), iters=5)
        same_solution(port, ref)
        assert port[0].shape[0] == prob.s.shape[0]
