"""Scaling of the landmark-sharded bundle adjustment over ranks: the port of
`scripts/bench_dba_scaling.py` (SURVEY.md §5.8).

Runs `parallel/dba.bundle_adjust_sharded` on one problem over worlds of 1,
2, 4, ... `torch.distributed` ranks, each rank a process of this module
(`tcp://127.0.0.1:<free port>`), and reports the ms per LM iteration and
the parallel efficiency t_1 / (n t_n). On the CPU the ranks are gloo
processes of one thread each. On a machine with one card every rank
shares that card (gloo; NCCL takes one rank per card): such a run measures
what the collectives and the shared card cost, not scaling across cards,
and its JSON says so. Each world's cameras and cost are held against the
one-rank world's.

    python -m orb_slam3_comments_ghr_torch.scripts.bench_dba_scaling \\
        [--devices 4] [--points 8192] [--kfs 32] [--iters 10] [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

OBS_PER_POINT = 8
WORKER_TIMEOUT_S = 600
_DIST_ENV = ("SLAM_COORDINATOR", "SLAM_NUM_PROCS", "SLAM_PROC_ID", "MASTER_ADDR", "MASTER_PORT",
             "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def make_problem(K: int, P: int, device, seed: int = 0):
    """The JAX script's problem, drawn with numpy: P points seen by K
    cameras on a 4 m line, OBS_PER_POINT observations each, the free
    cameras perturbed by 0.02 in se(3) and the points by 2 cm."""
    import torch

    from ..ops import cameras, lie
    from ..optim import ba

    rng = np.random.default_rng(seed)
    cam = cameras.euroc_cam0()
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    uv = f32(rng.random((P, 2)) * [700.0, 440.0] + 20.0)
    pts = cameras.unproject(cam, uv) * f32(rng.random((P, 1)) * 8 + 5)
    cam_c = torch.stack([torch.linspace(-2, 2, K), torch.zeros(K), torch.zeros(K)], -1)
    Rg = torch.eye(3).expand(K, 3, 3).contiguous()
    tg = -torch.einsum("kij,kj->ki", Rg, cam_c)
    D = OBS_PER_POINT
    obs_cam = ((torch.arange(P)[:, None] * 3 + torch.arange(D)[None, :] * (K // D + 1)) % K
               ).to(torch.int32)
    pc = torch.einsum("pdij,pj->pdi", Rg[obs_cam.long()], pts) + tg[obs_cam.long()]
    uv_obs = cameras.project(cam, pc)
    ok = cameras.in_image(cam, uv_obs, 2.0) & (pc[..., 2] > 0.5)
    dR, dt = lie.se3_exp(f32(rng.normal(size=(K, 6)) * 0.02))
    R0, t0 = lie.se3_mul(dR, dt, Rg, tg)
    prob = ba.BAProblem(cam_R=R0, cam_t=t0, cam_fixed=torch.arange(K) < 2, p=pts + 0.02,
                        p_valid=torch.ones(P, dtype=torch.bool), obs_cam=obs_cam,
                        obs_uv=uv_obs, obs_ur=torch.full((P, D), -1.0),
                        obs_level=torch.zeros((P, D), dtype=torch.int32), obs_valid=ok)
    return cam, prob._replace(**{f: getattr(prob, f).to(device) for f in prob._fields
                                 if getattr(prob, f) is not None})


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worker(args) -> int:
    """One rank: shard the problem, one untimed call, then `--reps` timed
    calls of `--iters` LM iterations; writes rank{R}.json (and rank 0 the
    cameras and cost, result.npz) into `--out`."""
    import torch

    from ..parallel import dba, distributed
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.worker_rank,
                           device=device)
    mesh = distributed.global_mesh()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cam, prob = make_problem(args.kfs, args.points, device)
    local = dba.shard_problem(prob, mesh)
    out = dba.bundle_adjust_sharded(cam, local, mesh, iters=args.iters)
    _sync(device)
    if mesh.size > 1:
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = dba.bundle_adjust_sharded(cam, local, mesh, iters=args.iters)
    _sync(device)
    ms = (time.perf_counter() - t0) / args.reps / args.iters * 1e3
    info = distributed.process_info()
    with open(os.path.join(args.out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"ms": ms, "backend": info["backend"], "world": mesh.size,
                   "device": str(device)}, f)
    if mesh.rank == 0:
        R, t, _, _, cost, _ = out
        np.savez(os.path.join(args.out, "result.npz"), R=R.cpu().numpy(), t=t.cpu().numpy(),
                 cost=float(cost))
    if mesh.size > 1:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(args, n: int, out_dir: str) -> dict:
    """n ranks of this module; returns each rank's record and rank 0's
    result. Fails with the ranks' output unless every rank exits 0."""
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    procs = []
    for r in range(n):
        cmd = [sys.executable, "-m", "orb_slam3_comments_ghr_torch.scripts.bench_dba_scaling",
               "--worker-rank", str(r), "--world", str(n), "--port", str(port), "--out", out_dir,
               "--points", str(args.points), "--kfs", str(args.kfs), "--iters", str(args.iters),
               "--reps", str(args.reps)]
        if args.device:
            cmd += ["--device", args.device]
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for r, (p, log) in enumerate(procs):
            rc = p.wait(timeout=WORKER_TIMEOUT_S)
            log.close()
            if rc != 0:
                with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                    raise RuntimeError(f"{n} ranks: rank {r} exited {rc}:\n{f.read()[-3000:]}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with np.load(os.path.join(out_dir, "result.npz")) as z:
        result = {k: z[k] for k in z.files}
    return {"ranks": ranks, "result": result}


def bench(args, work: str) -> dict:
    """Every world of 1, 2, 4, ... <= `--devices` ranks, in `work`; the
    JSON line's dict, with rank 0's cameras and cost per world under
    "results"."""
    import torch

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    ms, backends, results = {}, {}, {}
    n = 1
    while n <= args.devices:
        w = run_world(args, n, os.path.join(work, f"world{n}"))
        ms[n] = round(max(r["ms"] for r in w["ranks"]), 3)
        backends[n] = w["ranks"][0]["backend"]
        results[n] = w["result"]
        n *= 2
    one = results[1]
    report = {
        "ms_per_lm_iter": ms,
        "efficiency": {k: round(ms[1] / (v * k), 3) for k, v in ms.items()},
        "points": args.points, "keyframes": args.kfs, "obs_per_point": OBS_PER_POINT,
        "platform": device.type,
        "backend": backends,
        "max_abs_dR_vs_1": {k: float(np.abs(r["R"] - one["R"]).max()) for k, r in results.items()},
        "max_abs_dt_vs_1": {k: float(np.abs(r["t"] - one["t"]).max()) for k, r in results.items()},
        "cost": {k: float(r["cost"]) for k, r in results.items()},
    }
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        report["cards"] = cards
        report["device_name"] = torch.cuda.get_device_name(0)
        if args.devices > cards:
            report["note"] = (f"ranks share {cards} card(s): this measures the collectives and "
                              "a shared card, not scaling across cards")
    report["results"] = results
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4, help="the largest world (ranks)")
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--kfs", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3, help="timed calls per world")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the CUDA card; 'cpu' for the host)")
    ap.add_argument("--worker-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker_rank is not None:
        return worker(args)
    if args.points % args.devices:
        ap.error(f"--points {args.points} must divide over {args.devices} ranks")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dba_scaling_") as work:
        report = bench(args, work)
    report.pop("results")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
