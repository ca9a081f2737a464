"""ctypes bindings for the native prefetching image loader (native/slamio.cpp).

Port of `orb_slam3_comments_ghr_tpu/io/native_loader.py`. The library is
compiled on first use from the repo's `native/slamio.cpp`, with the g++
command of `native/build.sh`, into this package's `build/` directory (named
by the source's hash; nothing is written under `native/`). If the toolchain
or libpng is missing the loader falls back to the Python decoder in
io.datasets: the same interface, no prefetch (`PrefetchLoader.native` says
which one runs). It decodes on the host; `SLAM` uploads the frames."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "slamio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]  # native/build.sh
GXX_LIBS = ["-lpng", "-lz", "-lpthread"]

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Compile slamio.cpp if its source changed; returns the library path.
    Raises RuntimeError with the compiler's output if g++ fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libslamio_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads half a file
    return lib


def _load_library():
    """The bound library, built and loaded once per process; False when it
    cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _LIB = False
            return False
        lib.slamio_open.restype = ctypes.c_int64
        lib.slamio_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.slamio_next.restype = ctypes.c_int32
        lib.slamio_next.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.slamio_close.argtypes = [ctypes.c_int64]
        _LIB = lib
        return lib


class PrefetchLoader:
    """In-order prefetching image iterator over a list of file paths."""

    def __init__(self, paths, n_workers: int = 2, capacity: int = 8,
                 max_hw=(2048, 2048)):
        self.paths = list(paths)
        self.max_elems = max_hw[0] * max_hw[1]
        self._buf = np.empty(self.max_elems, np.float32)
        self._lib = _load_library()
        self._handle = None
        self._py_iter = None
        if self._lib:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._handle = self._lib.slamio_open(
                arr, len(self.paths), n_workers, capacity
            )
        else:
            from . import datasets

            self._py_iter = (datasets.load_image(p) for p in self.paths)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for _ in range(len(self.paths)):
            yield self.next()

    def next(self) -> np.ndarray:
        if self._py_iter is not None:
            return next(self._py_iter)
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        rc = self._lib.slamio_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.max_elems, ctypes.byref(h), ctypes.byref(w),
        )
        if rc == -1:
            raise StopIteration
        if rc == 0:
            raise IOError("native decode failed")
        return self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle is not None and self._lib:
            self._lib.slamio_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
