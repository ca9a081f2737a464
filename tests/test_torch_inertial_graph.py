"""The tracker's visual-inertial refinement replayed from a CUDA graph
(`optim/inertial.PoseInertialGraph`) against `pose_inertial_optimize`
without a prior, on one frame of the port's `vi_sequence` (gravity-aligned):
512 padded rows, 300 of them valid, the start 3 cm off the true pose.

On CPU tensors the graph object is the eager call, bit for bit. On the
card (the `gpu` test, which needs no JAX: `python -m pytest --noconftest
-m gpu tests/test_torch_inertial_graph.py`), two frames through one graph
match two eager calls: the same inliers, states within 1e-5 (the same
kernels; cuBLAS may choose another algorithm inside a capture)."""

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.optim import imu, inertial, pose_opt
from orb_slam3_comments_ghr_torch.utils import synthetic

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()
CALIB = imu.ImuCalib(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                     noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5)


def _frame(device, k: int, seed: int = 0):
    """(state0, prev, pre, obs, Tcb) of frame k of a gravity-aligned
    `vi_sequence(40)`, the previous keyframe at frame k - 10 (body ==
    camera)."""
    poses, rows, times = synthetic.vi_sequence(40, gravity_tilt=(0.0, 0.0))
    state = lambda i: (poses[i][0].T, -poses[i][0].T @ poses[i][1])
    (R1, p1), (R2, p2) = state(k - 10), state(k)
    v1 = (state(k - 9)[1] - state(k - 11)[1]) / (times[k - 9] - times[k - 11])
    live = (rows[:, 0] > times[k - 10]) & (rows[:, 0] <= times[k])
    dts = np.diff(np.concatenate([[times[k - 10]], rows[live, 0]]))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pre = imu.preintegrate(t(rows[live, 1:4]), t(rows[live, 4:7]), t(dts),
                           torch.zeros(6, device=device), CALIB)
    prev = inertial.VIState(Rwb=t(R1), pwb=t(p1), vel=t(v1), bias=torch.zeros(6, device=device))
    Rp, pp, vp = imu.predict_state(prev.Rwb, prev.pwb, prev.vel, prev.bias, pre)
    state0 = inertial.VIState(Rwb=Rp, pwb=pp + t([0.03, -0.02, 0.01]), vel=vp, bias=prev.bias)
    rng = np.random.default_rng(seed)
    uv = rng.uniform([20, 20], [720, 460], (512, 2)).astype(np.float32)
    z = rng.uniform(4, 12, (512, 1)).astype(np.float32)
    pc = cameras.unproject(CAM, torch.from_numpy(uv)).numpy() * z
    p_world = pc @ R2.astype(np.float32).T + p2.astype(np.float32)
    uv_obs = uv + rng.normal(0, 0.4, uv.shape).astype(np.float32)
    obs = pose_opt.PoseObs(p_world=t(p_world), uv=t(uv_obs), u_right=t(np.full(512, -1.0)),
                           level=torch.zeros(512, dtype=torch.int64, device=device),
                           valid=torch.arange(512, device=device) < 300)
    return state0, prev, pre, obs, (torch.eye(3, device=device), torch.zeros(3, device=device))


def _same(a, b, atol):
    st_a, inl_a, n_a, prior_a = a
    st_b, inl_b, n_b, prior_b = b
    assert prior_a is None and prior_b is None
    assert torch.equal(inl_a, inl_b) and int(n_a) == int(n_b)
    for x, y in zip(st_a, st_b):
        torch.testing.assert_close(x, y, rtol=0, atol=atol)


def test_graph_object_is_the_eager_call_on_cpu():
    args = _frame("cpu", 20)
    eager = inertial.pose_inertial_optimize(CAM, *args, None)
    _same(inertial.PoseInertialGraph()(CAM, *args), eager, 0.0)
    assert int(eager[2]) > 280  # of the 300 valid rows
    assert float(torch.linalg.norm(eager[0].pwb - args[0].pwb)) > 0.01  # it moved


@pytest.mark.gpu
def test_graph_replay_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graph = inertial.PoseInertialGraph()
    for k, seed in ((20, 0), (30, 1)):
        args = _frame("cuda", k, seed)
        eager = inertial.pose_inertial_optimize(CAM, *args, None)
        _same(graph(CAM, *args), eager, 1e-5)
    assert len(graph._graphs) == 1  # the second frame replayed the first one's graph
