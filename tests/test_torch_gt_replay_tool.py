"""The port's GT-replay tools against the JAX package's scripts, on a
stand-in EuRoC ground truth: the JAX package's own estimate of MH01's real
motion (`results/mh01_img_stereo_full_r5.tum`, 3637 poses at 20 Hz)
written as `MH01_GT.txt` in EuRoC's layout into a temporary folder, which
both packages' `gt_replay.GT_DIR` point at.

- `orb_slam3_comments_ghr_torch/scripts/run_gt_replay.main` (on the CPU)
  against `scripts/run_gt_replay.py --platform cpu` (beside it, in a process
  of its own): the first 40 frames
  as rendered features, mono, 512 features a frame. The same JSON keys;
  each >= 90 % tracked; tracked counts within 2 of each other; Sim(3) ATE
  within 5 mm of each other and under 5 cm.
- `analyze_trajectory` against `scripts/analyze_trajectory.py` on the
  port's replayed trajectory: the same printed lines, and the per-frame
  aligned errors and per-segment RMSE and maximum within 1e-6 m.
- The five tools run `--help` with JAX blocked.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.utils import gt_replay as jgt
from orb_slam3_comments_ghr_torch.utils import gt_replay as tgt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STAND_IN_TUM = REPO / "results" / "mh01_img_stereo_full_r5.tum"
FRAMES = 40
REPLAY = ["--sensor", "mono", "--render", "features", "--max-frames", str(FRAMES),
          "--n-features", "512"]
TOOLS = ("run_gt_replay", "analyze_trajectory", "train_vocabulary", "eval_vocabulary",
         "bench_dba_scaling")


def load_script(name: str):
    """The JAX package's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """The stand-in ground truth's folder, in both packages' GT_DIR."""
    d = tmp_path_factory.mktemp("euroc_gt")
    assert tgt.euroc_gt_from_tum(str(STAND_IN_TUM), str(d / "MH01_GT.txt")) == 3637
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgt, "GT_DIR", str(d))
        mp.setattr(tgt, "GT_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def replays(stand_in):
    """(the port's JSON, the JAX script's JSON, the port's TUM file). The
    JAX script runs as its own process (`EUROC_GT_DIR` naming the stand-in)
    while the port's tool runs in this one."""
    from orb_slam3_comments_ghr_torch.scripts import run_gt_replay

    env = dict(os.environ, EUROC_GT_DIR=str(stand_in))
    jax_proc = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "run_gt_replay.py")] + REPLAY
        + ["--platform", "cpu"], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port_tum = str(stand_in / "port.tum")
        port = printed(run_gt_replay.main, REPLAY + ["--device", "cpu", "--out", port_tum])
        jax_out, jax_err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, jax_err[-3000:]
    return json.loads(port.strip().splitlines()[-1]), \
        json.loads(jax_out.strip().splitlines()[-1]), port_tum


def test_stand_in_ground_truth_loads_in_both_packages(stand_in):
    """The written file reads back as the TUM trajectory's poses (T_WC),
    the same in both packages' loaders."""
    got = tgt.load_euroc_gt("MH01")
    for a, b in zip(got, jgt.load_euroc_gt("MH01")):
        assert np.array_equal(a, np.asarray(b))
    rows = np.loadtxt(STAND_IN_TUM)
    times, R_cw, t_cw, p_wc, q_wc = got
    np.testing.assert_allclose(times, rows[:, 0] - rows[0, 0], atol=1e-9)
    np.testing.assert_allclose(p_wc, rows[:, 1:4], atol=1e-9)
    np.testing.assert_allclose(q_wc, rows[:, [7, 4, 5, 6]], atol=1e-9)


def test_run_gt_replay_matches_jax_script(replays):
    port, jax, _ = replays
    assert sorted(port) == sorted(jax)
    assert port["frames"] == jax["frames"] == FRAMES
    assert port["tracked_ratio"] >= 0.9 and jax["tracked_ratio"] >= 0.9, (port, jax)
    assert abs(port["tracked"] - jax["tracked"]) <= 2, (port, jax)
    assert abs(port["ate_rmse_m"] - jax["ate_rmse_m"]) <= 0.005, (port, jax)
    assert port["ate_rmse_m"] < 0.05 and jax["ate_rmse_m"] < 0.05
    assert port["maps"] == 1 and port["map_resets"] == 0


def test_analyze_trajectory_matches_jax_script(replays, monkeypatch):
    from orb_slam3_comments_ghr_torch.scripts import analyze_trajectory

    _, _, tum = replays
    argv = ["--seq", "MH01", "--tum", tum, "--segments", "8", "--scale"]
    got = analyze_trajectory.analyze("MH01", tum, segments=8, scale=True)
    port_text = printed(analyze_trajectory.main, argv)
    jax_mod = load_script("analyze_trajectory")
    horn = jax_mod._horn
    seen = {}

    def kept_horn(A, B, with_scale=False):
        seen["in"], seen["out"] = (A, B), horn(A, B, with_scale)
        return seen["out"]

    monkeypatch.setattr(jax_mod, "_horn", kept_horn)
    monkeypatch.setattr(sys, "argv", ["analyze_trajectory.py"] + argv)
    jax_text = printed(jax_mod.main)
    assert port_text == jax_text
    (P_est, P_gt), (s, R, t0) = seen["in"], seen["out"]
    err = np.linalg.norm(s * (P_est @ R.T) + t0 - P_gt, axis=1)
    assert got["matched"] == len(err) > 10
    np.testing.assert_allclose(got["err"], err, atol=1e-6)
    ts = got["ts"]
    edges = np.linspace(ts[0], ts[-1], 9)
    want = []
    for i in range(8):
        m = (ts >= edges[i]) & (ts < edges[i + 1])
        if m.sum() >= 2:
            want.append((np.sqrt((err[m] ** 2).mean()), err[m].max(), int(m.sum())))
    assert len(got["segments"]) == len(want) > 0
    for (_, _, rmse, mx, n), (rmse_j, mx_j, n_j) in zip(got["segments"], want):
        assert abs(rmse - rmse_j) < 1e-6 and abs(mx - mx_j) < 1e-6 and n == n_j


def test_tools_run_without_jax():
    """`--help` of each tool in a process where JAX cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for name in {TOOLS!r}:\n"
            "    mod = importlib.import_module('orb_slam3_comments_ghr_torch.scripts.' + name)\n"
            "    try:\n"
            "        mod.main(['--help'])\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "assert not any(m.startswith('orb_slam3_comments_ghr_tpu') for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("usage:") == len(TOOLS)
