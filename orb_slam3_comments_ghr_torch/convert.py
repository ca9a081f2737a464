"""State carried between the JAX package and the port.

The tracking slice has no learned weights: its state is the camera, the
frame features and the local map, plus static tables that both packages
rebuild from the same recipes. These helpers move the containers across as
numpy arrays (from the JAX side take `np.asarray` of each field, e.g.
`{k: np.asarray(v) for k, v in feats._asdict().items()}`), so this module
needs no JAX. Descriptors are uint32 on the JAX side and int32 here, the
same bits viewed through another dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .frontend.types import Features
from .ops.cameras import Camera
from .pipeline.programs import LocalPoints


def camera_from_jax(cam) -> Camera:
    """The port's Camera with the fields of a JAX-package Camera."""
    return Camera(**{f.name: getattr(cam, f.name) for f in dataclasses.fields(Camera)})


def _tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name == "desc":
        a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    elif name == "valid":
        a = a.astype(bool)
    elif name == "level":
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def features_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> Features:
    return Features(**{k: _tensor(k, arrays[k], device) for k in Features._fields})


def local_points_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> LocalPoints:
    return LocalPoints(**{k: _tensor(k, arrays[k], device) for k in LocalPoints._fields})


def to_numpy(container) -> dict:
    """Fields of a port NamedTuple (Features, LocalPoints, TrackResult) as
    numpy arrays, descriptors viewed back as uint32."""
    out = {}
    for k, v in container._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k == "desc" else a
    return out
