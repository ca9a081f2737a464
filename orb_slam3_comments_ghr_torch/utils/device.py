"""Where the port's stateful parts run: the card unless the caller asks for
another device."""

from __future__ import annotations

import torch


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
