"""Calls replayed from CUDA graphs (`utils/device.GraphCache`), on what
the mapping worker replays beside a tracker (`LocalMapper._bites`): the
local BA's bite (`ba.bundle_adjust_step`) on a seeded windowed problem of
6 cameras (the first two fixed, so that the scale is held too; padded to
8) and 200 points (padded to 256) seen with 0.7 px noise, the free cameras
and the points started off their truth; and the new-point program (`programs.map_new_points_multi` with
`graphs`) on 512 points seen from a keyframe and three neighbours 0.2-0.6 m
to its side, each neighbour's features a shuffled copy with the same
descriptors.

On CPU tensors the cache is the eager call, bit for bit, and the nested
arguments it flattens come back as they went in. On the card (the `gpu`
tests, which need no JAX: `python -m pytest --noconftest -m gpu
tests/test_torch_graph_cache.py`), two problems of one shape through one
graph match two eager bites (the same damping; poses within 1e-4, points
within 1e-3 m: the same kernels, but cuBLAS may choose another algorithm
inside a capture), each new shape captures one graph, a replay returns the
graph's own tensors, and the graphed new-point program makes the eager
one's matches and kept points (within 1e-4 m)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.ops import cameras, lie
from orb_slam3_comments_ghr_torch.optim import ba
from orb_slam3_comments_ghr_torch.pipeline import programs
from orb_slam3_comments_ghr_torch.utils.device import GraphCache, _flatten

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()


def _problem(device, seed: int, n_pts: int = 200, P: int = 256, n_cams: int = 6, K: int = 8):
    """(BAProblem, lam) of one window, on `device`."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    # se3_exp takes [rho, phi]: the cameras 0.3 m apart along x, turned a little
    xi = np.concatenate([np.stack([-0.3 * np.arange(n_cams), rng.normal(0, 0.05, n_cams),
                                   rng.normal(0, 0.05, n_cams)], -1),
                         rng.normal(0, 0.02, (n_cams, 3))], -1)
    R, t = lie.se3_exp(f32(xi))
    pts = f32(np.stack([rng.uniform(-2, 2, n_pts) - 0.75, rng.uniform(-1.5, 1.5, n_pts),
                        rng.uniform(4, 8, n_pts)], -1))
    pc = torch.einsum("kij,pj->pki", R, pts) + t[None]           # (n_pts, n_cams, 3)
    uv = cameras.project(CAM, pc) + f32(rng.normal(0, 0.7, (n_pts, n_cams, 2)))
    vis = ((pc[..., 2] > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < CAM.width)
           & (uv[..., 1] >= 0) & (uv[..., 1] < CAM.height))
    D = n_cams
    cam_R = torch.eye(3).repeat(K, 1, 1)
    cam_t = torch.zeros(K, 3)
    dR, dt = lie.se3_exp(f32(rng.normal(0, [0.02] * 3 + [0.003] * 3, (n_cams, 6))))
    start_R, start_t = lie.se3_mul(dR, dt, R, t)
    cam_R[:n_cams] = torch.cat([R[:2], start_R[2:]])
    cam_t[:n_cams] = torch.cat([t[:2], start_t[2:]])
    cam_fixed = torch.ones(K, dtype=torch.bool)
    cam_fixed[2:n_cams] = False

    def pad(x, fill=0):
        out = torch.full((P,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n_pts] = x
        return out

    prob = ba.BAProblem(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
        p=pad(pts + f32(rng.normal(0, 0.05, (n_pts, 3)))),
        p_valid=pad(torch.ones(n_pts, dtype=torch.bool)),
        obs_cam=pad(torch.where(vis, torch.arange(D), 0).to(torch.int32)),
        obs_uv=pad(torch.where(vis[..., None], uv, 0.0)), obs_ur=torch.full((P, D), -1.0),
        obs_level=pad(torch.as_tensor(rng.integers(0, 4, (n_pts, D)), dtype=torch.int32)),
        obs_valid=pad(vis))
    prob = ba.BAProblem(*(x.to(device) for x in prob[:10]))
    return prob, torch.full((), 1e-4, device=device)


def _bite(cache, prob, lam, iters: int = 2):
    return cache(lambda *a: ba.bundle_adjust_step(CAM, *a, iters=iters), ("ba", CAM, iters),
                 prob, lam)


def test_cache_is_the_eager_call_on_cpu():
    cache = GraphCache()
    for seed in (0, 1):
        prob, lam = _problem("cpu", seed)
        eager = ba.bundle_adjust_step(CAM, prob, lam, iters=2)
        got = _bite(cache, prob, lam)
        for x, y in zip(got, eager):
            assert torch.equal(x, y)
        # the bite moved the free cameras towards the truth
        assert float(got[3]) < 1e-4 and not torch.equal(got[0], prob.cam_R)
    assert (cache.eager, cache.captures, cache.replays) == (2, 0, 0) and not cache._graphs


class _Inner(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor | None = None


def test_flatten_round_trip():
    x, y, z = torch.zeros(2), torch.ones(3), torch.arange(4)
    tree = (x, _Inner(y), (z, _Inner(x, y)))
    leaves, rebuild = _flatten(tree)
    assert [id(v) if v is not None else None for v in leaves] == [id(x), id(y), None, id(z),
                                                                  id(x), id(y)]
    back = rebuild(leaves)
    assert back == tree and type(back[1]) is _Inner and type(back[2][1]) is _Inner


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_ba_bite_replay_equals_eager_on_card():
    _card()
    cache = GraphCache()
    for seed in (0, 1):
        prob, lam = _problem("cuda", seed)
        eager = ba.bundle_adjust_step(CAM, prob, lam, iters=2)
        got = _bite(cache, prob, lam)
        assert torch.equal(got[3], eager[3])
        torch.testing.assert_close(got[0], eager[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], eager[1], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], eager[2], rtol=0, atol=1e-3)
    assert (cache.captures, cache.replays, cache.eager) == (1, 2, 0)


@pytest.mark.gpu
def test_one_capture_per_shape_on_card():
    _card()
    cache = GraphCache()
    outs = [_bite(cache, *_problem("cuda", 0, P=P)) for P in (256, 512, 256)]
    assert cache.captures == 2 and len(cache._graphs) == 2 and cache.replays == 3
    # a replay returns the graph's own tensors, which the next replay overwrites
    assert all(x is y for x, y in zip(outs[0], outs[2]))


def _new_points_args(device, seed: int = 0, n: int = 512, nbs: int = 3):
    """map_new_points_multi's arguments for one keyframe and `nbs`
    neighbours, on `device`."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)

    def seen(t):
        pc = X + t
        return np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                         CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)

    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    perms = [rng.permutation(n) for _ in range(nbs)]
    ts = [np.array([-0.2 * (b + 1), 0.01 * b, 0.0]) for b in range(nbs)]
    f32, i32 = (lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device),
                lambda a: torch.as_tensor(np.asarray(a), device=device))
    eye = np.eye(3)
    return (CAM, i32(desc), f32(seen(np.zeros(3))), i32(rng.integers(0, 4, n).astype(np.int32)),
            f32(np.full(n, -1.0)), i32(rng.random(n) < 0.9), f32(eye), f32(np.zeros(3)),
            i32(np.stack([desc[p] for p in perms])), f32(np.stack([seen(t)[p] for p, t in
                                                                   zip(perms, ts)])),
            i32(rng.integers(0, 4, (nbs, n)).astype(np.int32)), f32(np.full((nbs, n), -1.0)),
            i32(rng.random((nbs, n)) < 0.9), f32(np.stack([eye] * nbs)), f32(np.stack(ts)))


def test_new_points_through_the_cache_on_cpu():
    args = _new_points_args("cpu")
    eager = programs.map_new_points_multi(*args)
    cache = GraphCache()
    got = programs.map_new_points_multi(*args, graphs=cache)
    for x, y in zip(got, eager):
        assert torch.equal(x, y)
    assert int(eager[2].sum()) > 1000 and (cache.eager, cache.captures) == (6, 0)


@pytest.mark.gpu
def test_new_points_replay_equals_eager_on_card():
    _card()
    args = _new_points_args("cuda")
    eager = programs.map_new_points_multi(*args)
    cache = GraphCache()
    for _ in range(2):
        got = programs.map_new_points_multi(*args, graphs=cache)
        assert torch.equal(got[0], eager[0]) and torch.equal(got[2], eager[2])
        good = eager[2]  # the other rows' points are never read
        torch.testing.assert_close(got[1][good], eager[1][good], rtol=0, atol=1e-4)
    # two graphs (the match and design matrices, the gates), one replay a neighbour each
    assert (cache.captures, cache.replays) == (2, 12)
