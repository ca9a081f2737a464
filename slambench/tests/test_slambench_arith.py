"""The benchmark's own arithmetic on hand-made inputs: the window's rate
and tail with a stall in it, RPE, and the output check's references
against their controls."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import reference as ref  # noqa: E402
from slambench import run  # noqa: E402


def test_window_metrics_see_a_stall():
    # 200 frames of 100 ms, then one stall of 3 s and ten frames at 400 ms
    lat = [100.0] * 200 + [3000.0] + [400.0] * 10
    ok = [True] * len(lat)
    m = run.window_metrics(lat, ok, window_s=sum(lat) / 1e3)
    assert m["fps"] == pytest.approx(211 / 27.0)
    assert m["frame_ms.p95"] == 400.0  # rank 201 of 211 sorted: in the slow tail
    steady = run.window_metrics([100.0] * 211, ok, window_s=21.1)
    assert steady["fps"] == pytest.approx(10.0) and steady["frame_ms.p95"] == 100.0
    assert m["fps"] < 0.8 * steady["fps"]


def test_failed_frames_count_as_missing():
    lat = [100.0] * 100
    ok = [True] * 90 + [False] * 10
    m = run.window_metrics(lat, ok, window_s=10.0)
    assert m["fps"] == pytest.approx(9.0)
    assert math.isinf(m["frame_ms.p95"])


def _line(n, speed=0.5, dt=0.05):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 0, 3] = speed * dt * np.arange(n)
    return T, dt * np.arange(n)


def test_rpe_on_hand_made_trajectories():
    gt, times = _line(100)
    # a rigid offset and a rotated world frame leave the RPE at 0
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    W = np.eye(4)
    W[:3, :3], W[:3, 3] = R, [1.0, 2.0, 3.0]
    est = W @ gt
    assert ref.rpe(est, gt, times, 1.0, False)[0] == pytest.approx(0.0, abs=1e-12)
    # a monocular map at another scale: 0 after the Sim(3) scale, not before
    half = gt.copy()
    half[:, :3, 3] *= 0.5
    assert ref.rpe(half, gt, times, 1.0, True)[0] == pytest.approx(0.0, abs=1e-9)
    assert ref.rpe(half, gt, times, 1.0, False)[0] == pytest.approx(0.25)
    # a drift of 1 cm per second along y: 10 mm over every 1-s pair
    drift = gt.copy()
    drift[:, 1, 3] += 0.01 * times
    value, pairs = ref.rpe(drift, gt, times, 1.0, False)
    assert value == pytest.approx(0.01) and pairs == 80


def _wm_args(seed=0, n=64, m=80):
    g = torch.Generator().manual_seed(seed)
    qd = torch.randint(-2**31, 2**31 - 1, (n, 8), generator=g, dtype=torch.int64).to(torch.int32)
    td = torch.randint(-2**31, 2**31 - 1, (m, 8), generator=g, dtype=torch.int64).to(torch.int32)
    quv = torch.rand((n, 2), generator=g) * 100
    txy = torch.rand((m, 2), generator=g) * 100
    r = torch.where(torch.rand(n, generator=g) < 0.8, 15.0, -1.0)
    lo = torch.zeros(n)
    hi = torch.full((n,), 7.0)
    lvl = torch.randint(0, 8, (m,), generator=g).float()
    return (qd, quv, r, lo, hi, td, txy, lvl, torch.ones(m))


def _plain_window_match(args):
    qd, quv, r, lo, hi, td, txy, lvl, valid = args
    out = []
    for i in range(qd.shape[0]):
        best, idx, dists = ref.BIG, 0, []
        for j in range(td.shape[0]):
            inside = (abs(float(quv[i, 0] - txy[j, 0])) < float(r[i])
                      and abs(float(quv[i, 1] - txy[j, 1])) < float(r[i])
                      and valid[j] > 0 and lo[i] <= lvl[j] <= hi[i])
            d = sum(bin(int(a) & 0xFFFFFFFF ^ int(b) & 0xFFFFFFFF).count("1")
                    for a, b in zip(qd[i], td[j])) if inside else ref.BIG
            dists.append(d)
            if d < best:
                best, idx = d, j
        second = min([d for j, d in enumerate(dists) if j != idx] + [ref.BIG])
        out.append((idx if best < ref.BIG else 0, best, second))
    return [torch.tensor(c) for c in zip(*out)]


def test_window_match_reference_and_its_check():
    args = _wm_args()
    want = ref.window_match(args)
    plain = _plain_window_match(args)
    assert ref.window_match_mismatches(plain, want) == 0
    altered = (plain[0] + 1, plain[1], plain[2])
    assert ref.window_match_mismatches(altered, want) > 0
    half = [x.clone() for x in plain]
    half[1][::2] = ref.BIG
    assert ref.window_match_mismatches(half, want) > 0


def test_window_match_control_misses():
    """The window test in bfloat16 moves candidates across the window's
    edge: at the pixel coordinates of a frame (hundreds of pixels) its
    8-bit mantissa rounds by up to 2 px."""
    args = list(_wm_args(1, n=256, m=400))
    args[1] = args[1] * 7.0
    args[6] = args[6] * 7.0
    want = ref.window_match(tuple(args))
    ctrl = ref.window_match(tuple(args), torch.bfloat16)[:3]
    assert ref.window_match_mismatches(ctrl, want) > 0


def _pose_problem(seed=0, n=300):
    g = np.random.default_rng(seed)
    cam = dict(fx=435.2, fy=435.2, cx=367.45, cy=252.2, bf=47.9)
    p = np.c_[g.uniform(-3, 3, n), g.uniform(-2, 2, n), g.uniform(2, 8, n)]
    R = torch.eye(3, dtype=torch.float64)
    t = torch.tensor([0.05, -0.02, 0.1], dtype=torch.float64)
    pc = torch.from_numpy(p) + t
    uv = torch.stack([cam["fx"] * pc[:, 0] / pc[:, 2] + cam["cx"],
                      cam["fy"] * pc[:, 1] / pc[:, 2] + cam["cy"]], -1)
    uv = uv + torch.from_numpy(g.normal(0, 0.5, (n, 2)))
    ur = torch.where(torch.arange(n) % 2 == 0, uv[:, 0] - cam["bf"] / pc[:, 2], -1.0)
    level = torch.from_numpy(g.integers(0, 4, n))
    return cam, torch.from_numpy(p), uv, ur, level, R, t


def test_pose_reference_converges_and_control_departs():
    cam, p, uv, ur, level, R, t = _pose_problem()
    valid = torch.ones(len(p), dtype=torch.bool)
    R0, t0 = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    Rr, tr = ref.pose_lm(cam, R0.float(), t0.float(), p.float(), uv.float(), ur.float(), level,
                         valid)
    assert float(torch.linalg.norm(tr - t)) < 0.01
    Rc, tc = ref.pose_lm(cam, R0.float(), t0.float(), p.float(), uv.float(), ur.float(), level,
                         valid, dtype=torch.bfloat16)
    gap = float(torch.linalg.norm(Rr.T @ tr - Rc.T @ tc)) * 1e3
    assert gap > 0.05  # mm: the control's pose is off by far more than float32 round-off


def test_preintegration_reference_and_control():
    g = torch.Generator().manual_seed(0)
    acc = torch.randn((10, 3), generator=g) + torch.tensor([0.0, 0.0, 9.81])
    gyr = torch.randn((10, 3), generator=g) * 0.3
    dts = torch.full((10,), 0.005)
    bias = torch.zeros(6)
    want = ref.preintegrate(acc, gyr, dts, bias)
    # float64 against the same integration in float32: round-off only
    got32 = ref.preintegrate(acc, gyr, dts, bias, torch.float32)
    assert ref.preint_gap(want, got32) < 1e-5
    ctrl = ref.preintegrate(acc, gyr, dts, bias, torch.bfloat16)
    assert ref.preint_gap(want, ctrl) > 1e-3
    # the velocity after 50 ms under gravity: 9.81 * 0.05
    assert float(want[1][2]) == pytest.approx(0.4905, rel=0.05)
