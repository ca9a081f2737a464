"""Two processes form one world through the environment: the twin of
`tests/test_multiprocess.py`.

Each worker is this file run as a script with SLAM_COORDINATOR /
SLAM_NUM_PROCS / SLAM_PROC_ID set; `parallel.distributed.initialize()`
reads them (gloo on the CPU), and the two ranks run the landmark-sharded BA
on `make_problem`'s inputs of `tests/test_parallel.py` (drawn by JAX, passed
as numpy): the camera system's all_reduce crosses the process boundary.
Rank 0 writes the result. Bounds, those of the JAX test: against the JAX
package's single-process `ba.bundle_adjust`, rotations within 5e-4,
translations within 5e-3, the cost within 5 %. Workers import no JAX.
"""

import os
import sys

import numpy as np

from test_torch_parallel import FIELDS, free_port, jax_bundle_adjust, jax_problem, tail, \
    worker_env

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ITERS = 12


class TestTwoProcessDistributedBA:
    def test_matches_single_process(self, tmp_path):
        import subprocess

        arrays = jax_problem(0)[0]
        np.savez(str(tmp_path / "problem.npz"), **arrays)
        coordinator = f"127.0.0.1:{free_port()}"
        procs, logs = [], []
        for pid in range(2):
            env = worker_env()
            env.update(SLAM_COORDINATOR=coordinator, SLAM_NUM_PROCS="2", SLAM_PROC_ID=str(pid))
            log = open(str(tmp_path / f"env{pid}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(tmp_path)],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
        try:
            for pid, p in enumerate(procs):
                rc = p.wait(timeout=300)
                assert rc == 0, tail(tmp_path, "env", pid)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()

        R1, t1, c1 = jax_bundle_adjust(arrays, ITERS)
        got = np.load(str(tmp_path / "dist_result.npz"))
        assert int(got["world"]) == 2 and str(got["backend"]) == "gloo"
        np.testing.assert_allclose(got["R"], R1, atol=5e-4)
        np.testing.assert_allclose(got["t"], t1, atol=5e-3)
        assert abs(float(got["cost"]) - c1) / max(c1, 1.0) < 0.05


def _worker(out_dir: str) -> None:
    import torch

    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.parallel import dba, distributed

    torch.set_num_threads(1)
    assert distributed.initialize(), "distributed.initialize did not read the environment"
    info = distributed.process_info()
    assert info["process_count"] == 2, info
    with np.load(os.path.join(out_dir, "problem.npz")) as z:
        prob = convert.ba_problem_from_numpy({f: z[f] for f in FIELDS}, device="cpu")
    mesh = distributed.global_mesh()
    R, t, _, _, cost, _ = dba.bundle_adjust_sharded(
        cameras.euroc_cam0(), dba.shard_problem(prob, mesh), mesh, iters=ITERS)
    if info["process_index"] == 0:
        np.savez(os.path.join(out_dir, "dist_result.npz"), R=R.numpy(), t=t.numpy(),
                 cost=cost.item(), world=info["process_count"], backend=info["backend"])
    print(f"[worker {info['process_index']}] done cost={cost.item():.3f}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1])
