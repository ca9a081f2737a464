"""The frame program's pose LM replayed from a CUDA graph
(`optim/pose_opt.PoseLMGraph`) against `optimize_pose`, on seeded problems:
points seen from a known pose with 0.5 px noise scaled by octave, 20 %
gross outliers, mono rows alone or a third of them stereo, 10 % padding
rows, the start a few centimetres and degrees off.

On CPU tensors the graph object is the eager call, bit for bit. On the
card (the `gpu` tests, which need no JAX: `python -m pytest --noconftest
-m gpu tests/test_torch_pose_graph.py`), two frames through one graph match
two eager calls (the same inliers, poses within 1e-5: the same kernels;
cuBLAS may choose another algorithm inside a capture), a result stays as it
was after the next call, the LM and the replay run without a host sync,
and each new input shape captures one graph."""

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.ops import cameras, lie
from orb_slam3_comments_ghr_torch.optim import pose_opt

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()


def _problem(device, seed: int, n: int = 512, stereo_share: float = 0.33):
    """(R0, t0, PoseObs) of one frame, on `device`."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt = (x.numpy() for x in lie.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03,
                                                               0.01])))
    uv = rng.random((n, 2)) * [CAM.width, CAM.height]
    depth = rng.random(n) * 8 + 2
    pc = np.stack([(uv[:, 0] - CAM.cx) / CAM.fx, (uv[:, 1] - CAM.cy) / CAM.fy,
                   np.ones(n)], -1) * depth[:, None]
    level = rng.integers(0, 4, n)
    obs_uv = uv + rng.normal(size=(n, 2)) * 0.5 * 1.2 ** level[:, None]
    out = rng.random(n) < 0.2
    obs_uv[out] += rng.normal(size=(out.sum(), 2)) * 40
    stereo = rng.random(n) < stereo_share
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    obs = pose_opt.PoseObs(p_world=t((pc - t_gt) @ R_gt),
                           uv=t(obs_uv), u_right=t(np.where(stereo, obs_uv[:, 0] - CAM.bf / depth,
                                                            -1.0)),
                           level=t(level, torch.int32), valid=t(rng.random(n) > 0.1, torch.bool))
    xi0 = torch.tensor([0.05, 0.03, -0.04, 0.01, 0.015, -0.02]) * (1 + seed % 3)
    R0, t0 = lie.se3_mul(*lie.se3_exp(xi0), torch.from_numpy(R_gt), torch.from_numpy(t_gt))
    return R0.to(device), t0.to(device), obs


def _same(got, want, atol):
    R_g, t_g, inl_g, n_g = got
    R_w, t_w, inl_w, n_w = want
    assert torch.equal(inl_g, inl_w) and torch.equal(n_g, n_w)
    torch.testing.assert_close(R_g, R_w, rtol=0, atol=atol)
    torch.testing.assert_close(t_g, t_w, rtol=0, atol=atol)


@pytest.mark.parametrize("stereo_share", [0.0, 0.33], ids=["mono", "stereo"])
def test_graph_object_is_the_eager_call_on_cpu(stereo_share):
    graph = pose_opt.PoseLMGraph()
    for seed in (0, 1):
        R0, t0, obs = _problem("cpu", seed, stereo_share=stereo_share)
        eager = pose_opt.optimize_pose(CAM, R0, t0, obs)
        got = graph(CAM, R0, t0, obs)
        for x, y in zip(got, eager):
            assert torch.equal(x, y)
        assert int(eager[3]) > 0.6 * int(obs.valid.sum())
        assert not bool(eager[2][~obs.valid].any())  # padding rows are never inliers
    assert (graph.eager, graph.captures, graph.replays) == (2, 0, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_graph_replay_equals_eager_on_card():
    _card()
    graph = pose_opt.PoseLMGraph()
    first = None
    for seed, share in ((0, 0.33), (1, 0.0)):
        args = _problem("cuda", seed, 4096, share)
        eager = pose_opt.optimize_pose(CAM, *args)
        got = graph(CAM, *args)
        _same(got, eager, 1e-5)
        if first is None:
            first, kept = got, [x.clone() for x in got]
    # the second call left the first call's result as it was: no aliasing
    for x, y in zip(first, kept):
        assert torch.equal(x, y)
    assert (graph.captures, graph.replays, graph.eager) == (1, 2, 0)


@pytest.mark.gpu
def test_no_host_sync_on_card():
    _card()
    graph = pose_opt.PoseLMGraph()
    args = _problem("cuda", 2, 4096)
    pose_opt.optimize_pose(CAM, *args)
    graph(CAM, *args)  # the capture syncs the device once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pose_opt.optimize_pose(CAM, *args)
        graph(CAM, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_one_capture_per_shape_on_card():
    _card()
    graph = pose_opt.PoseLMGraph()
    for n in (4096, 2048, 4096, 2048):
        graph(CAM, *_problem("cuda", n, n))
    assert graph.captures == 2 and len(graph._graphs) == 2 and graph.replays == 4
