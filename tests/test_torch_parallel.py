"""Distributed BA through the port, against the JAX package: the twins of
the 7 cases of `tests/test_parallel.py`.

The three `TestDistributedBA` cases and the world half of the runtime cases
run in one 4-rank gloo world of CPU processes, formed once per module
(`ba_world`): each rank shards `make_problem`'s inputs (drawn by JAX, passed
as numpy) and runs `parallel.dba.bundle_adjust_sharded`. The live case
builds a 36-frame map once in this process through the port, writes its
atlas, and two ranks load it with `SlamConfig(dba_devices=-1)` and run
`mapper.global_ba` sharded; this process runs the single-process
`global_ba` on the same atlas, in the port and in the JAX package.

Bounds, those of the JAX test: against the JAX package's single-device
`ba.bundle_adjust` on the same inputs, rotations within 5e-4, translations
within 5e-3 and the cost within 5 %; the solved translations within 2 cm
(20 iterations) and 5 cm (10) of the truth; the live sharded GBA within
5e-3 of the single-process one of either package. The ranks' cameras (and the live ranks'
keyframe poses) must be the same bits.

The file is also its own worker: `python tests/test_torch_parallel.py
{ba,live} --rank R --world N --port P --dir D`. Workers import no JAX.
"""

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BA_WORLD = 4
LIVE_WORLD = 2
WORKER_TIMEOUT = 300
# case: (make_problem key, LM iterations), as in tests/test_parallel.py
CASES = {"matches": (0, 12), "converges": (1, 20), "shardings": (2, 2), "global_mesh": (3, 10)}
FIELDS = ("cam_R", "cam_t", "cam_fixed", "p", "p_valid", "obs_cam", "obs_uv", "obs_ur",
          "obs_level", "obs_valid")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(mode: str, world: int, out_dir) -> None:
    """Run `world` workers of this file and fail with their logs unless all
    exit 0 within WORKER_TIMEOUT."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(str(out_dir), f"{mode}{rank}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, os.path.abspath(__file__), mode, "--rank", str(rank),
               "--world", str(world), "--port", str(port), "--dir", str(out_dir)]
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                      env=worker_env()))
    try:
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=WORKER_TIMEOUT)
            assert rc == 0, f"{mode} rank {rank} exited {rc}:\n" + tail(out_dir, mode, rank)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("SLAM_COORDINATOR", "SLAM_NUM_PROCS", "SLAM_PROC_ID", "MASTER_ADDR",
                        "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def tail(out_dir, mode: str, rank: int) -> str:
    try:
        with open(os.path.join(str(out_dir), f"{mode}{rank}.log")) as f:
            return f.read()[-3000:]
    except OSError:
        return "<no log>"


def jax_problem(key: int):
    """make_problem(PRNGKey(key)) of tests/test_parallel.py: (the problem's
    arrays as numpy, Rg, tg, points)."""
    import jax
    from test_parallel import make_problem

    prob, Rg, tg, pts = make_problem(jax.random.PRNGKey(key))
    return {f: np.asarray(getattr(prob, f)) for f in FIELDS}, np.asarray(Rg), np.asarray(tg), \
        np.asarray(pts)


def jax_bundle_adjust(arrays: dict, iters: int):
    """The JAX package's single-device ba.bundle_adjust on the arrays:
    (R, t, cost)."""
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import cameras
    from orb_slam3_comments_ghr_tpu.optim import ba

    prob = ba.BAProblem(**{f: jnp.asarray(a) for f, a in arrays.items()})
    R, t, _, _, cost = ba.bundle_adjust(cameras.euroc_cam0(), prob, iters=iters)
    return np.asarray(R), np.asarray(t), float(cost)


# ----------------------------------------------------------------- workers
def _ba_worker(opts) -> None:
    """One rank of the 4-rank world: every case's problem sharded and
    solved; its results, its shard and process_info written per rank."""
    from orb_slam3_comments_ghr_torch import convert
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.parallel import dba, distributed

    assert distributed.initialize(f"127.0.0.1:{opts.port}", opts.world, opts.rank, device="cpu")
    mesh = distributed.global_mesh()
    cam = cameras.euroc_cam0()
    out = {f"info_{k}": "" if v is None else v for k, v in distributed.process_info().items()}
    for case, (_, iters) in CASES.items():
        with np.load(os.path.join(opts.dir, f"{case}.npz")) as z:
            prob = convert.ba_problem_from_numpy({f: z[f] for f in FIELDS}, device="cpu")
        local = dba.shard_problem(prob, mesh)
        R, t, p, inlier, cost, lam = dba.bundle_adjust_sharded(cam, local, mesh, iters=iters)
        out.update({f"{case}_R": R.numpy(), f"{case}_t": t.numpy(), f"{case}_p": p.numpy(),
                    f"{case}_inlier": inlier.numpy(), f"{case}_cost": cost.item(),
                    f"{case}_lam": lam.item(), f"{case}_mesh": mesh.size})
    np.savez(os.path.join(opts.dir, f"rank{opts.rank}.npz"), **out)


def live_cfg(dba_devices: int):
    """The configuration of tests/test_parallel.py's live case."""
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    return SlamConfig(n_features=512, local_points_cap=2048, local_ba_points=2048,
                      max_frames_between_kf=6, min_init_matches=60, enable_loop_closing=False,
                      async_mapping=False, dba_devices=dba_devices)


def _live_worker(opts) -> None:
    """One rank of the 2-rank world: the atlas loaded into a SLAM with
    dba_devices=-1, then global_ba(iters=6) with a spy on the sharded BA."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.parallel import dba, distributed
    from orb_slam3_comments_ghr_torch.system import SLAM

    assert distributed.initialize(f"127.0.0.1:{opts.port}", opts.world, opts.rank, device="cpu")
    slam = SLAM(cameras.euroc_cam0(), live_cfg(-1), device="cpu")
    slam.load_atlas(os.path.join(opts.dir, "live_atlas.npz"), new_session=False)
    mesh = slam.mapper._dba_mesh()
    calls = []
    orig = dba.bundle_adjust_sharded

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    dba.bundle_adjust_sharded = spy
    try:
        slam.mapper.global_ba(iters=6)
    finally:
        dba.bundle_adjust_sharded = orig
    np.savez(os.path.join(opts.dir, f"live{opts.rank}.npz"), kf_R=slam.map.kf_R,
             kf_t=slam.map.kf_t, mp_pos=slam.map.mp_pos, kfs=slam.map.kf_ids(),
             calls=len(calls), mesh=-1 if mesh is None else mesh.size)


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def ba_world(tmp_path_factory):
    """The 4-rank world's results: (per-rank results, the JAX inputs per case)."""
    d = tmp_path_factory.mktemp("dba")
    inputs = {}
    for case, (key, _) in CASES.items():
        inputs[case] = jax_problem(key)
        np.savez(str(d / f"{case}.npz"), **inputs[case][0])
    run_world("ba", BA_WORLD, d)
    ranks = [dict(np.load(str(d / f"rank{r}.npz"))) for r in range(BA_WORLD)]
    return ranks, inputs


def same_cameras(ranks, case: str):
    for r in ranks[1:]:
        assert np.array_equal(r[f"{case}_R"], ranks[0][f"{case}_R"])
        assert np.array_equal(r[f"{case}_t"], ranks[0][f"{case}_t"])
        assert float(r[f"{case}_cost"]) == float(ranks[0][f"{case}_cost"])


def against_jax(ranks, inputs, case: str):
    arrays = inputs[case][0]
    R1, t1, c1 = jax_bundle_adjust(arrays, CASES[case][1])
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"{case}_R"], R1, atol=5e-4)
    np.testing.assert_allclose(r0[f"{case}_t"], t1, atol=5e-3)
    c = float(r0[f"{case}_cost"])
    assert abs(c - c1) / max(c1, 1.0) < 0.05, (c, c1)


class TestDistributedBA:
    def test_matches_single_device(self, ba_world):
        ranks, inputs = ba_world
        same_cameras(ranks, "matches")
        against_jax(ranks, inputs, "matches")

    def test_converges_to_geometry(self, ba_world):
        ranks, inputs = ba_world
        same_cameras(ranks, "converges")
        tg = inputs["converges"][2]
        assert np.linalg.norm(ranks[0]["converges_t"] - tg, axis=-1).max() < 0.02
        against_jax(ranks, inputs, "converges")

    def test_output_shardings(self, ba_world):
        """Points stay sharded (each rank its contiguous P/4 rows, their
        observations beside them); cameras replicated, bit for bit."""
        ranks, inputs = ba_world
        P, D = inputs["shardings"][0]["obs_cam"].shape
        for r in ranks:
            assert r["shardings_p"].shape == (P // BA_WORLD, 3)
            assert r["shardings_inlier"].shape == (P // BA_WORLD, D)
            assert int(r["shardings_mesh"]) == BA_WORLD
        same_cameras(ranks, "shardings")
        # the shards' inliers lie inside their own rows' valid observations
        valid = inputs["shardings"][0]["obs_valid"].reshape(BA_WORLD, P // BA_WORLD, D)
        for k, r in enumerate(ranks):
            assert not (r["shardings_inlier"] & ~valid[k]).any()
        against_jax(ranks, inputs, "shardings")


class TestDistributedRuntime:
    def test_initialize_noop_single_process(self, monkeypatch):
        from orb_slam3_comments_ghr_torch.parallel import distributed

        for k in ("SLAM_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        assert distributed.initialize() is False
        assert not torch.distributed.is_initialized()

    def test_global_mesh_runs_dba(self, ba_world):
        ranks, inputs = ba_world
        for r in ranks:
            assert int(r["global_mesh_mesh"]) == int(r["info_global_devices"]) == BA_WORLD
        same_cameras(ranks, "global_mesh")
        tg = inputs["global_mesh"][2]
        assert np.linalg.norm(ranks[0]["global_mesh_t"] - tg, axis=-1).max() < 0.05

    def test_process_info(self, ba_world):
        from orb_slam3_comments_ghr_torch.parallel import distributed

        info = distributed.process_info()
        assert info["process_count"] == 1 and info["global_devices"] == 1
        assert info["backend"] is None
        ranks, _ = ba_world
        for k, r in enumerate(ranks):
            assert int(r["info_process_index"]) == k
            assert int(r["info_process_count"]) == BA_WORLD
            assert str(r["info_backend"]) == "gloo"


class TestLiveDistributedGBA:
    """SlamConfig.dba_devices routes mapper.global_ba through
    parallel.dba.bundle_adjust_sharded over the ranks."""

    def test_global_ba_sharded_matches_single_device(self, tmp_path):
        from orb_slam3_comments_ghr_torch.ops import cameras
        from orb_slam3_comments_ghr_torch.system import SLAM
        from orb_slam3_comments_ghr_torch.utils import synthetic

        torch.set_num_threads(1)
        cam = cameras.euroc_cam0()
        world = synthetic.make_world(9, n_points=3000)
        poses = synthetic.circular_trajectory(36)
        built = SLAM(cam, live_cfg(0), device="cpu")
        for i, (R, t) in enumerate(poses):
            feats, _ = synthetic.render_features(world, cam, R, t, n_feat=512, seed=300 + i,
                                                 device="cpu")
            built.track_features(feats, i * 0.05)
        path = str(tmp_path / "live_atlas.npz")
        built.save_atlas(path)

        a = SLAM(cam, live_cfg(-1), device="cpu")  # one process: the single-device path
        a.load_atlas(path, new_session=False)
        assert a.mapper._dba_mesh() is None
        ka = [int(k) for k in a.map.kf_ids()]
        assert len(ka) >= 4
        a.mapper.global_ba(iters=6)

        run_world("live", LIVE_WORLD, tmp_path)
        b = [dict(np.load(str(tmp_path / f"live{r}.npz"))) for r in range(LIVE_WORLD)]
        for r in b:
            assert int(r["mesh"]) == LIVE_WORLD
            assert int(r["calls"]) >= 1, "live global_ba never dispatched the sharded BA"
            assert list(r["kfs"]) == ka
        for f in ("kf_R", "kf_t", "mp_pos"):
            assert np.array_equal(b[1][f], b[0][f]), f
        # same optimum modulo reduction order / chunked-vs-dense assembly
        np.testing.assert_allclose(a.map.kf_t[ka], b[0]["kf_t"][ka], atol=5e-3)
        np.testing.assert_allclose(a.map.kf_R[ka], b[0]["kf_R"][ka], atol=5e-3)
        # and the JAX package's global_ba on the same atlas
        from orb_slam3_comments_ghr_tpu import system as jsystem
        from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
        from orb_slam3_comments_ghr_tpu.utils import config as jconfig

        j = jsystem.SLAM(jcameras.euroc_cam0(), jconfig.SlamConfig(**vars(live_cfg(0))))
        j.load_atlas(path, new_session=False)
        j.mapper.global_ba(iters=6)
        np.testing.assert_allclose(j.map.kf_t[ka], b[0]["kf_t"][ka], atol=5e-3)
        np.testing.assert_allclose(j.map.kf_R[ka], b[0]["kf_R"][ka], atol=5e-3)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["ba", "live"])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    opts = ap.parse_args()
    (_ba_worker if opts.mode == "ba" else _live_worker)(opts)
    torch.distributed.destroy_process_group()
