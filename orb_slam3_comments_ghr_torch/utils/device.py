"""Where the port's stateful parts run: the card unless the caller asks for
another device; and the lock that keeps forward-mode AD to one thread at a
time."""

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
