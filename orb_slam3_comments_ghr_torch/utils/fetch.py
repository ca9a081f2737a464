"""One-copy device->host fetch of a tree of tensors.

Port of `orb_slam3_comments_ghr_tpu/utils/fetch.py`. A tree is a tensor, or
a tuple, list, NamedTuple or dict of trees; None is a subtree with no
leaves. Every leaf is promoted to a 32-bit dtype (bool and sub-word
integers to int32, float64 to float32, int64 to int32, as the JAX
package's `_promote32`), reinterpreted as int32 words (`.view`, so that
every 32-bit pattern, uint32 words near 2^32 included, comes back exactly),
and packed into one buffer, which one copy brings to the host. The host
side restores the leaves' shapes and dtypes (float64 and int64 leaves come
back as float32 and int32, as in the JAX package).

On the card `device_fetch_async` copies the packed buffer with
`non_blocking=True` into pinned host memory on the current stream and
records an event after the copy: `AsyncFetch.ready()` asks the event,
`get()` waits for it and unpacks. On the CPU the copy is a plain one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_BACK = {torch.bool: np.bool_, torch.int8: np.int8, torch.uint8: np.uint8,
         torch.int16: np.int16, torch.float64: np.float32, torch.int64: np.int32,
         torch.float32: np.float32, torch.int32: np.int32, torch.uint32: np.uint32}


def _flatten(tree, leaves: list):
    """The tree's leaves appended to `leaves` in order; returns a function
    that rebuilds the tree from an iterator of host arrays."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        subs = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda it: {k: f(it) for k, f in subs.items()}
    if isinstance(tree, (tuple, list)):
        subs = [_flatten(v, leaves) for v in tree]
        cls = type(tree)  # not the tree itself: its tensors are not kept
        if hasattr(tree, "_fields"):  # a NamedTuple
            return lambda it: cls(*(f(it) for f in subs))
        return lambda it: cls(f(it) for f in subs)
    leaves.append(torch.as_tensor(tree))
    return lambda it: next(it)


def _promote32(x: torch.Tensor) -> torch.Tensor:
    """x as a 32-bit dtype whose words the host can read back."""
    if x.dtype in (torch.float32, torch.int32, torch.uint32):
        return x
    if x.dtype in (torch.float64, torch.float16, torch.bfloat16):
        return x.to(torch.float32)
    return x.to(torch.int32)


def _pack(leaves: list) -> torch.Tensor:
    """The leaves as one (n,) int32 buffer, on the device of the first CUDA
    leaf (or the CPU)."""
    dev = next((x.device for x in leaves if x.device.type == "cuda"), torch.device("cpu"))
    parts = [_promote32(x.to(dev)).reshape(-1).view(torch.int32) for x in leaves]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int32)


def _unpack(buf: np.ndarray, meta: list, rebuild):
    """The tree from the host buffer; `meta` holds each leaf's (dtype,
    shape)."""
    out, at = [], 0
    for dtype, shape in meta:
        n = int(np.prod(shape, dtype=np.int64))
        seg = buf[at:at + n]
        at += n
        back = np.dtype(_BACK.get(dtype, np.float32))
        if back.itemsize == 4:
            seg = seg.view(back)
        else:  # bool and sub-word integers travelled as int32 values
            seg = seg.astype(back)
        out.append(seg.reshape(shape))
    return rebuild(iter(out))


def device_fetch(tree):
    """The tree with its leaves as numpy arrays, in one device->host copy."""
    return device_fetch_async(tree).get()


class AsyncFetch:
    """A device->host copy in flight: `ready()` says whether it has landed,
    `get()` waits for it and returns the tree of numpy arrays."""

    __slots__ = ("_host", "_event", "_meta", "_rebuild", "_result")

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event], meta, rebuild):
        self._host = host
        self._event = event
        self._meta = meta
        self._rebuild = rebuild
        self._result = None

    def ready(self) -> bool:
        return self._result is not None or self._event is None or self._event.query()

    def get(self):
        if self._result is None:
            if self._event is not None:
                self._event.synchronize()
            self._result = _unpack(self._host.numpy(), self._meta, self._rebuild)
            self._host = self._event = None
        return self._result


def device_fetch_async(tree) -> AsyncFetch:
    """Start the one-buffer copy of `tree` to the host; harvest it with
    `.get()`."""
    leaves: list = []
    rebuild = _flatten(tree, leaves)
    buf = _pack(leaves)
    meta = [(x.dtype, tuple(x.shape)) for x in leaves]
    if buf.device.type != "cuda":
        return AsyncFetch(buf.clone(), None, meta, rebuild)
    host = torch.empty(buf.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return AsyncFetch(host, event, meta, rebuild)
