"""Where the port's stateful parts run: the card unless the caller asks for
another device; the lock that keeps forward-mode AD to one thread at a
time; and calls replayed from CUDA graphs (`GraphCache`)."""

from __future__ import annotations

import functools
import threading

import torch

# torch's forward-mode AD levels (what torch.func.jacfwd enters and leaves)
# are one stack for the whole process, not one per thread: two threads in
# jacfwd at once leave each other's level (with asynchronous mapping the
# tracker's VI refinement and the worker's inertial init, VI-BA, Sim(3) and
# pose-graph Jacobians would). Every forward-mode Jacobian of the port is
# taken under this lock.
FORWARD_AD_LOCK = threading.RLock()


def forward_ad_locked(fn):
    """fn, called under FORWARD_AD_LOCK."""
    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with FORWARD_AD_LOCK:
            return fn(*args, **kwargs)

    return locked


def resolve_device(device=None) -> torch.device:
    """`device`, or the card (`torch.device("cuda")`) when it is None.
    Raises when the card is asked for and there is none: nothing carries on
    on the CPU unless the caller passed `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _flatten(tree):
    """(leaves, rebuild) of nested tuples and NamedTuples whose leaves are
    tensors or None: `rebuild(leaves)` gives the structure back."""
    if not isinstance(tree, tuple):
        return [tree], lambda leaves: leaves[0]
    parts = [_flatten(x) for x in tree]
    leaves = [leaf for part, _ in parts for leaf in part]

    def rebuild(flat):
        out, i = [], 0
        for part, inner in parts:
            out.append(inner(flat[i:i + len(part)]))
            i += len(part)
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)

    return leaves, rebuild


def capture_graph(run):
    """(graph, out): `run()` captured into a CUDA graph on the card, and
    what the captured call returned (the graph's own tensors, which each
    replay overwrites). Two warm-up calls come first, so that library
    handles and workspaces exist before the capture. All three run on a
    side stream of their own, and nothing syncs the whole device: the
    tracker and a mapping worker may each capture at the same time, each
    beside the other's work (`thread_local`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = run()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out


class GraphCache:
    """Calls `fn(*args)` replayed from CUDA graphs on the card. One graph
    per `key` (the hashable arguments that fix what fn runs: a camera, an
    iteration count) and the shape and dtype of every tensor in `args`
    (nested tuples and NamedTuples of tensors; a leaf may be None), captured
    on the first call with a new key (`capture_graph`). Each call copies its
    tensors into the graph's buffers and replays. It returns the graph's own
    outputs, which the next replay of that key overwrites: a caller that
    holds a result across calls clones it. On CPU tensors it is `fn(*args)`
    itself. `captures`, `replays` and `eager` count the calls by how they
    ran (a capturing call also replays)."""

    def __init__(self):
        self._graphs = {}
        self.captures = self.replays = self.eager = 0

    def __call__(self, fn, key, *args):
        leaves, rebuild = _flatten(args)
        if next(x for x in leaves if x is not None).device.type != "cuda":
            self.eager += 1
            return fn(*args)
        key = (key,) + tuple(None if x is None else (x.shape, x.dtype) for x in leaves)
        if key not in self._graphs:
            self._graphs[key] = self._capture(fn, leaves, rebuild)
        static, graph, out = self._graphs[key]
        for buf, x in zip(static, leaves):
            if buf is not None:
                buf.copy_(x)
        graph.replay()
        self.replays += 1
        return out

    def _capture(self, fn, leaves, rebuild):
        static = [None if x is None else x.clone() for x in leaves]
        graph, out = capture_graph(lambda: fn(*rebuild(static)))
        self.captures += 1
        return static, graph, out
