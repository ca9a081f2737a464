"""Fused windowed descriptor match: the Hopper kernel and its plain version.

Port of `orb_slam3_comments_ghr_tpu/ops/pallas_match.py:window_match_tpu`.
Per query row i (a local map point) and every target j (a frame feature):
Hamming distance of the packed descriptors, masked by |du| < r_i,
|dv| < r_i, lo_i <= level_j <= hi_i and valid_j > 0; returns the best
distance, its argmin (lowest index on ties) and the second best (the min
after masking the argmin column). A row without a candidate gives
best = second = BIG and idx 0. An invisible query comes in with r = -1.

`window_match` launches the CUDA kernel of `csrc/window_match.cu` on CUDA
tensors and runs `window_match_plain` on CPU tensors. There is no fallback:
on a CUDA tensor the kernel runs or the call raises. Each call with N > 0
is one launch, counted in this module's `launches` and, by the name of the
thread that launched it, in `launches_by_thread`; a lock keeps both exact
when the tracker and the mapping worker launch at once.

The kernel (its head note has the details) is bound by latency, not by
its few operations and bytes: the launch, two global round trips, and the
dependent steps of building and searching a grid. A block whose rows all
have r <= 0 leaves before reading a target; the others load the targets'
pixels into registers, stage the descriptors into shared memory by one TMA
bulk copy, sort the live targets into a grid of cells over their bounding
box, and let each warp scan only the cells its row's window overlaps, with
the exact f32 test on every candidate. Tensor cores were considered and not
taken: a dense distance product would leave the dense mask and top-2 that
the grid avoids. The results are a function of the candidate set alone, so
two launches give the same bits, and the kernel can be captured in a CUDA
graph. Inputs need only be contiguous: a descriptor pointer that is not
16-B aligned is staged by 4-B copies in the kernel.

The kernel is compiled with nvcc for sm_90a at first use into
`orb_slam3_comments_ghr_torch/build/` (ignored by git through the `build/`
line of `.gitignore`), named by the hash of its source, and loaded with
ctypes: it includes no PyTorch header, so it builds in seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import matching

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "window_match.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def window_match_plain(qdesc, q_uv, q_radius, q_lvl_lo, q_lvl_hi,
                       tdesc, t_xy, t_level, t_valid):
    """The XLA path's composition: window_mask, the Hamming distances,
    masked_best2. Returns (idx, best, second), each (N,) int32. Only the
    in-window pairs' distances are computed (the others are masked to BIG
    by masked_best2 anyway): the same values as the full matrix of
    `matching.hamming_matrix`, for a few thousand pairs where the matrix has
    millions."""
    mask = matching.window_mask(q_uv, t_xy, t_level, t_valid > 0.0, q_radius, q_lvl_lo, q_lvl_hi)
    qi, tj = mask.nonzero(as_tuple=True)
    dist = torch.full(mask.shape, matching.BIG, dtype=torch.int32, device=mask.device)
    d = torch.zeros(qi.shape, dtype=torch.int32, device=mask.device)
    for k in range(qdesc.shape[1]):
        d += matching.popcount32(qdesc[qi, k] ^ tdesc[tj, k])
    dist[qi, tj] = d
    return matching.masked_best2(dist, mask)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> Path:
    """Compile the kernel if its source changed; returns the library path.
    Raises RuntimeError with the compiler's output if nvcc fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"window_match_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The launch entry of the built kernel, built and loaded once per
    process."""
    fn = ctypes.CDLL(str(build())).window_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


launches = 0  # kernel launches of window_match, in this process
launches_by_thread: dict[str, int] = {}  # the same, by thread name
_count_lock = threading.Lock()


def count_launch():
    """Count one kernel launch (in `launches` and `launches_by_thread`)."""
    global launches
    name = threading.current_thread().name
    with _count_lock:
        launches += 1
        launches_by_thread[name] = launches_by_thread.get(name, 0) + 1


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def window_match(qdesc, q_uv, q_radius, q_lvl_lo, q_lvl_hi,
                 tdesc, t_xy, t_level, t_valid):
    """qdesc (N,8) int32, q_uv (N,2), q_radius/q_lvl_lo/q_lvl_hi (N,) f32;
    tdesc (M,8) int32, t_xy (M,2), t_level/t_valid (M,) f32, all on one
    device. Returns (idx, best, second), each (N,) int32."""
    n, m = qdesc.shape[0], tdesc.shape[0]
    dev = qdesc.device
    f32, i32 = torch.float32, torch.int32
    _check("qdesc", qdesc, i32, (n, 8), dev)
    _check("q_uv", q_uv, f32, (n, 2), dev)
    for name, x in (("q_radius", q_radius), ("q_lvl_lo", q_lvl_lo), ("q_lvl_hi", q_lvl_hi)):
        _check(name, x, f32, (n,), dev)
    _check("tdesc", tdesc, i32, (m, 8), dev)
    _check("t_xy", t_xy, f32, (m, 2), dev)
    _check("t_level", t_level, f32, (m,), dev)
    _check("t_valid", t_valid, f32, (m,), dev)
    if dev.type == "cpu":
        return window_match_plain(qdesc, q_uv, q_radius, q_lvl_lo, q_lvl_hi,
                                  tdesc, t_xy, t_level, t_valid)
    if dev.type != "cuda":
        raise ValueError(f"window_match runs on cpu or cuda tensors, got {dev}")

    args = (qdesc, q_uv, q_radius, q_lvl_lo, q_lvl_hi, tdesc, t_xy, t_level, t_valid)
    out = torch.empty((3, n), dtype=i32, device=dev)  # idx, best, second
    if n:
        ptr = out.data_ptr()
        err = _library()(*[a.data_ptr() for a in args], n, m, ptr, ptr + 4 * n, ptr + 8 * n,
                         torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if err != 0:
            raise RuntimeError(f"window_match kernel launch failed: cudaError {err}")
        count_launch()
    return out.unbind(0)
