"""The port's windowed bundle adjustment against the JAX package on a
seeded problem: 8 cameras on an arc, 512 points, every point seen by every
camera that sees it, 10 % of the observations outliers (20-50 px off).

Bounds: the normal-equation blocks and the Schur system are sums of float32
products taken in another order (segment sums by scatter-add here, one-hot
contractions in JAX), so they agree to rtol 1e-4 of the largest entry of
their block. After 10 LM iterations the accept/reject decisions are the
same, poses agree to 1e-4 and the points held by >= 2 inlier views to
1e-3, and the chi2 inlier masks are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, lie as jlie
from orb_slam3_comments_ghr_tpu.optim import ba as jba
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.optim import ba as tba

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()


def problem(seed=0, n_cams=8, n_pts=512, outliers=0.1, n_fixed=2, K_pad=8, P_pad=512):
    """A padded BA problem as numpy arrays, with its ground truth."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n_pts, 3)) * [8, 5, 4] + [-4, -2.5, 8]).astype(np.float32)
    Rs, ts = [], []
    for i in range(n_cams):
        a = 0.06 * (i - n_cams / 2)
        c = np.array([3.0 * np.sin(a), 0.1 * i, -3.0 * (1 - np.cos(a))])
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, -a, 0.0], jnp.float32)))
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)
    D = n_cams
    pc = np.einsum("kij,pj->pki", Rs, pts) + ts[None]
    uv = np.stack([JCAM.fx * pc[..., 0] / pc[..., 2] + JCAM.cx, JCAM.fy * pc[..., 1] / pc[..., 2] + JCAM.cy], -1)
    vis = (pc[..., 2] > 0.5) & (uv[..., 0] > 0) & (uv[..., 0] < JCAM.width) & (uv[..., 1] > 0) & (uv[..., 1] < JCAM.height)
    level = rng.integers(0, 3, (n_pts, D)).astype(np.int32)
    obs_uv = uv + rng.normal(0, 0.5, uv.shape) * 1.2 ** level[..., None]
    bad = rng.random((n_pts, D)) < outliers
    obs_uv[bad] += rng.choice([-1, 1], (int(bad.sum()), 2)) * rng.uniform(20, 50, (int(bad.sum()), 2))

    cam_R = np.tile(np.eye(3, dtype=np.float32), (K_pad, 1, 1))
    cam_t = np.zeros((K_pad, 3), np.float32)
    # perturbed start for the free cameras, exact for the fixed ones
    for i in range(n_cams):
        dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.005, 3), jnp.float32)))
        cam_R[i] = Rs[i] if i < n_fixed else dR @ Rs[i]
        cam_t[i] = ts[i] if i < n_fixed else ts[i] + rng.normal(0, 0.03, 3)
    cam_fixed = np.ones(K_pad, bool)
    cam_fixed[n_fixed:n_cams] = False
    p = np.zeros((P_pad, 3), np.float32)
    p[:n_pts] = pts + rng.normal(0, 0.05, pts.shape)
    p_valid = np.zeros(P_pad, bool)
    p_valid[:n_pts] = True

    def pad(a, fill=0):
        out = np.full((P_pad,) + a.shape[1:], fill, a.dtype)
        out[:n_pts] = a
        return out

    arrays = dict(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed, p=p, p_valid=p_valid,
        obs_cam=pad(np.where(vis, np.arange(D)[None], 0).astype(np.int32)),
        obs_uv=pad(np.where(vis[..., None], obs_uv, 0).astype(np.float32)),
        obs_ur=np.full((P_pad, D), -1.0, np.float32),
        obs_level=pad(level), obs_valid=pad(vis),
    )
    return arrays, (Rs, ts, pts, bad & vis)


def _jax_problem(arrays):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_problem(arrays):
    return convert.ba_problem_from_numpy(arrays, device="cpu")


def _close(ours, ref, rtol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rtol * scale)


def test_normal_equations_and_schur_system_match_jax():
    arrays, _ = problem(0)
    jp, tp = _jax_problem(arrays), _port_problem(arrays)
    K = arrays["cam_R"].shape[0]
    jt = jba._obs_terms(JCAM, jp, jp.cam_R, jp.cam_t, jp.p, True)
    tt = tba._obs_terms(TCAM, tp, tp.cam_R, tp.cam_t, tp.p, True)
    for name, a, b in zip(("r", "Jc", "Jp", "w", "chi2"), tt[:5], jt[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-3, err_msg=name)
    jb = jba._assemble(jp, *jt[:4], jt[5], K)
    tb = tba._assemble(tp, *tt[:4], tt[5], K)
    for name, a, b in zip(("H_pp", "b_p", "H_cc", "b_c", "W"), tb, jb):
        _close(a.numpy(), b)
    lam = 1e-4
    jinv = jba._point_blocks_inv(jb[0], jp.p_valid, jnp.float32(lam))
    tinv = tba._point_blocks_inv(tb[0], tp.p_valid, torch.tensor(lam))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=2e-3, atol=1e-9)
    # the reduced system from the same (JAX) blocks, so only its assembly differs
    S_j, rhs_j = jba._reduced_system(jp.obs_cam, jb[2], jb[3], jb[4], jinv, jb[1], K)
    S_t, rhs_t = tba._reduced_system(
        tp.obs_cam, *(torch.from_numpy(np.array(x)) for x in (jb[2], jb[3], jb[4], jinv, jb[1])), K)
    _close(S_t.numpy(), S_j)
    _close(rhs_t.numpy(), rhs_j)
    dxc_j = jba._solve_reduced(S_j, rhs_j, jp.cam_fixed, jnp.diagonal(jb[2], axis1=-2, axis2=-1), lam, K)
    dxc_t = tba._solve_reduced(S_t, rhs_t, tp.cam_fixed, torch.diagonal(tb[2], dim1=-2, dim2=-1),
                               torch.tensor(lam), K)
    _close(dxc_t.numpy(), dxc_j, rtol=1e-3)
    assert not dxc_t.numpy()[arrays["cam_fixed"]].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_matches_jax(seed):
    arrays, (_, _, pts, bad) = problem(seed)
    Rj, tj, pj, inl_j, cost_j = jba.bundle_adjust(JCAM, _jax_problem(arrays), iters=10)
    Rt, tt, pt, inl_t, cost_t = tba.bundle_adjust(TCAM, _port_problem(arrays), iters=10)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    # points held by >= 2 inlier views; one with fewer is unconstrained and
    # drifts along its ray differently in either package
    held = np.asarray(inl_j).sum(1) >= 2
    assert held[: len(pts)].mean() > 0.9
    np.testing.assert_allclose(pt.numpy()[held], np.asarray(pj)[held], atol=1e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    # the outliers are classified out, and the chi2 of the true inliers fell
    # to a tenth of the start's
    assert not (inl_t.numpy()[: len(pts)] & bad).any()
    tp = _port_problem(arrays)
    good = tp.obs_valid & ~torch.from_numpy(np.pad(bad, ((0, len(tp.p) - len(pts)), (0, 0))))

    def inlier_chi2(R, t, p):
        return float(tba._obs_terms(TCAM, tp, R, t, p, False)[4][good].sum())

    assert inlier_chi2(Rt, tt, pt) < 0.1 * inlier_chi2(tp.cam_R, tp.cam_t, tp.p)


def test_bite_chain_equals_one_call_and_classify():
    arrays, _ = problem(2)
    tp = _port_problem(arrays)
    R, t, p, inl, _ = tba.bundle_adjust(TCAM, tp, iters=4)
    lam = torch.tensor(1e-4)
    Rb, tb_, pb = tp.cam_R, tp.cam_t, tp.p
    for _ in range(2):
        Rb, tb_, pb, lam = tba.bundle_adjust_step(TCAM, tp._replace(cam_R=Rb, cam_t=tb_, p=pb), lam, iters=2)
    assert torch.equal(R, Rb) and torch.equal(t, tb_) and torch.equal(p, pb)
    assert torch.equal(tba.classify_observations(TCAM, tp._replace(cam_R=R, cam_t=t, p=p)), inl)


def test_failed_factorization_is_rejected():
    # a NaN step (non-positive-definite system) must leave the state alone
    arrays, _ = problem(3, n_pts=64, P_pad=64)
    tp = _port_problem(arrays)
    S = torch.full((8, 8, 6, 6), float("nan"))
    dxc = tba._solve_reduced(S, torch.zeros(8, 6), tp.cam_fixed, torch.ones(8, 6), torch.tensor(1e-4), 8)
    assert torch.isnan(dxc[~tp.cam_fixed]).all()
