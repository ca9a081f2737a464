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
on a CUDA tensor the kernel runs or the call raises.

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
    """The XLA path's composition: window_mask + hamming_matrix +
    masked_best2. Returns (idx, best, second), each (N,) int32."""
    mask = matching.window_mask(q_uv, t_xy, t_level, t_valid > 0.0, q_radius, q_lvl_lo, q_lvl_hi)
    return matching.masked_best2(matching.hamming_matrix(qdesc, tdesc), mask)


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
    lib = ctypes.CDLL(str(build()))
    fn = lib.window_match_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


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

    launch = _library()
    idx = torch.empty(n, dtype=i32, device=dev)
    best = torch.empty(n, dtype=i32, device=dev)
    second = torch.empty(n, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            qdesc.data_ptr(), q_uv.data_ptr(), q_radius.data_ptr(),
            q_lvl_lo.data_ptr(), q_lvl_hi.data_ptr(),
            tdesc.data_ptr(), t_xy.data_ptr(), t_level.data_ptr(), t_valid.data_ptr(),
            n, m, idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_match kernel launch failed: cudaError {err}")
    window_match.launches += 1
    return idx, best, second


window_match.launches = 0
