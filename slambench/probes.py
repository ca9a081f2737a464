"""The harness's wrappers around the program's calls into each layer.

Nothing here changes what a call computes. A `Sampler` keeps copies of the
arguments and results of the calls the output check drew from the seed
(copies on the device, without a host sync). A `Timer` (traced runs only)
puts each call in a `record_function` range and appends its host
milliseconds, ending in a device sync, to a list. `Patches` installs both
and restores every attribute it replaced.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def _copy(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, tuple):
        return type(x)(*map(_copy, x)) if hasattr(x, "_fields") else tuple(map(_copy, x))
    return x


class Patches:
    """Attribute replacements, undone in reverse order by `restore`."""

    def __init__(self):
        self._saved = []

    def wrap(self, obj, name: str, make):
        """obj.name = make(obj.name)."""
        self._saved.append((obj, name, vars(obj).get(name, _MISSING)))
        setattr(obj, name, make(getattr(obj, name)))

    def restore(self):
        for obj, name, own in reversed(self._saved):
            if own is _MISSING:  # a method of the class: drop the instance's
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._saved.clear()


_MISSING = object()


class Sampler:
    """Counts the calls of one function from 0 once `armed`, and keeps a
    device copy of `keep(args, kwargs, result)` (by default all three) of
    the calls whose index is in `picks`."""

    def __init__(self, picks, keep=None):
        self.picks = set(int(p) for p in picks)
        self.keep = keep or (lambda args, kwargs, out: (args, kwargs, out))
        self.calls = 0
        self.armed = False
        self.kept = []

    def __call__(self, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed:
                if self.calls in self.picks:
                    self.kept.append((self.calls, _copy(self.keep(args, kwargs, out))))
                self.calls += 1
            return out
        return wrapper


class Timer:
    """Host ms of each call, ending in a device sync, by key; each call in
    a `record_function` range named by the key. `on_call(key)` runs after
    each call."""

    def __init__(self, sync):
        self.ms = defaultdict(list)
        self.sync = sync
        self.on_call = None

    def __call__(self, key: str):
        def make(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                with torch.profiler.record_function(key):
                    out = fn(*args, **kwargs)
                    self.sync()
                self.ms[key].append((time.perf_counter() - t0) * 1e3)
                if self.on_call is not None:
                    self.on_call(key)
                return out
            return wrapper
        return make
