"""`orb_slam3_comments_ghr_torch/scripts/bench_dba_scaling.py` on 1 and 2
gloo ranks of CPU processes, at the sizes of `tests/test_torch_multiprocess.py`
(8 keyframes, 256 points, 12 LM iterations): the port's twin of
`scripts/bench_dba_scaling.py`, held against the one-process BA.

Bounds, those of `tests/test_parallel.py`: each world's cameras against
the single-process `optim/ba.bundle_adjust` on the same problem, rotations
within 5e-4, translations within 5e-3, the cost within 5 %. The report has
the JAX script's keys.
"""

import argparse

import numpy as np
import torch

torch.set_num_threads(1)


def test_bench_dba_scaling_one_and_two_ranks(tmp_path):
    from orb_slam3_comments_ghr_torch.optim import ba
    from orb_slam3_comments_ghr_torch.scripts import bench_dba_scaling as bench

    args = argparse.Namespace(devices=2, points=256, kfs=8, iters=12, reps=1, device="cpu")
    report = bench.bench(args, str(tmp_path))
    assert {"ms_per_lm_iter", "efficiency", "points", "keyframes", "obs_per_point",
            "platform"} <= set(report)
    assert sorted(report["ms_per_lm_iter"]) == [1, 2] and report["platform"] == "cpu"
    assert report["backend"] == {1: None, 2: "gloo"}
    assert report["efficiency"][1] == 1.0
    cam, prob = bench.make_problem(8, 256, torch.device("cpu"))
    R1, t1, _, _, c1 = ba.bundle_adjust(cam, prob, iters=12)
    for n, res in report["results"].items():
        np.testing.assert_allclose(res["R"], R1.numpy(), atol=5e-4)
        np.testing.assert_allclose(res["t"], t1.numpy(), atol=5e-3)
        assert abs(float(res["cost"]) - float(c1)) / max(float(c1), 1.0) < 0.05, n
