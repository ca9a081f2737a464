"""Multi-process runtime (SURVEY §2.3 P7 / §5.8) on `torch.distributed`.

Port of `orb_slam3_comments_ghr_tpu/parallel/distributed.py`. The reference
is a single-process system; here every process runs the same program, the
map-point blocks of the whole-map BA are sharded over the ranks
(`parallel.dba`), and the Schur-reduced camera system is summed by
`all_reduce`. The JAX package's global mesh of every device of every process
becomes the world of ranks, one device per rank (`Mesh`).

In a single process everything degrades gracefully: `initialize()` does
nothing and returns False, and `global_mesh()` is one rank.

Env contract (the first set wins; torchrun sets the second):
    SLAM_COORDINATOR  host:port of rank 0   (or MASTER_ADDR + MASTER_PORT)
    SLAM_NUM_PROCS    number of processes   (or WORLD_SIZE)
    SLAM_PROC_ID      this process's rank   (or RANK)
    LOCAL_WORLD_SIZE / LOCAL_RANK (torchrun) place ranks on this host's
    cards; without them every process is taken to run on this host.

Backend: `nccl` when every rank on the host has a card of its own, `gloo`
otherwise (the CPU, or several ranks sharing one card; gloo takes CUDA
tensors for `broadcast` and `all_reduce`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A set of ranks that shard one problem: the world, or its first
    `size` ranks. `group` is None for the world (or a single process)."""

    size: int
    rank: int
    group: Optional[object] = None


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _local_rank(rank: int, world: int) -> tuple[int, int]:
    """(local rank, ranks on this host)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return int(os.environ.get("LOCAL_RANK", rank % local_world)), local_world


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Form the world when a multi-process launch is configured (the
    arguments, else the environment above); does nothing and returns False
    in a single process. Safe to call twice. On a CUDA run (`device` the
    card or None, and a card present) each rank takes its host-local card,
    `torch.cuda.set_device(local_rank % cards)`, so that the port's
    unindexed `cuda` tensors land on it."""
    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator is None:
        coordinator = _env("SLAM_COORDINATOR")
        if coordinator is None and _env("MASTER_ADDR") and _env("MASTER_PORT"):
            coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    n = num_processes if num_processes is not None else int(
        _env("SLAM_NUM_PROCS", "WORLD_SIZE") or 1)
    if not coordinator or n <= 1:
        return False
    rank = process_id if process_id is not None else int(_env("SLAM_PROC_ID", "RANK") or 0)
    local_rank, local_world = _local_rank(rank, n)
    cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    backend = "gloo"
    if cuda:
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=n,
                            rank=rank)
    return True


def global_mesh() -> Mesh:
    """Every rank of the world (one rank in a single process): the
    landmark-shard axis of the distributed BA."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(size=dist.get_world_size(), rank=dist.get_rank())
    return Mesh(size=1, rank=0)


_SUB_MESHES: dict[int, Optional[Mesh]] = {}


def first_ranks(n: int) -> Optional[Mesh]:
    """The mesh of the world's first n ranks (a `new_group`, made once per
    n and process: every rank must call this in the same order), or None
    on a rank outside them."""
    world = global_mesh()
    if n >= world.size:
        return world
    if n not in _SUB_MESHES:
        group = dist.new_group(list(range(n)))
        _SUB_MESHES[n] = Mesh(size=n, rank=world.rank, group=group) if world.rank < n else None
    return _SUB_MESHES[n]


def process_info() -> dict:
    mesh = global_mesh()
    return {
        "process_index": mesh.rank,
        "process_count": mesh.size,
        "local_devices": 1,
        "global_devices": mesh.size,
        "backend": dist.get_backend() if mesh.size > 1 else None,
    }
