"""State carried between the JAX package and the port, and from host numpy
onto the device.

The system has no learned weights: its state is the camera, the
configuration, the frame features, the map (host numpy in both packages)
and the padded views the device programs take (local points, BA problems).
These helpers move the containers across as numpy arrays (from the JAX side
take `np.asarray` of each field, e.g. `{k: np.asarray(v) for k, v in
feats._asdict().items()}`), so this module needs no JAX. Descriptors are
uint32 on the JAX side and in the map, int32 in tensors: the same bits
viewed through another dtype.

Tensors are made on the card (`device="cuda"`) unless the caller asks for
another device, as the CPU tests do.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .frontend.types import Features
from .map.state import MapConfig, MapState
from .ops.cameras import Camera
from .optim.ba import BAProblem
from .optim.imu import ImuCalib, Preintegrated
from .optim.inertial import VIPrior, VIState
from .optim.posegraph import PoseGraphProblem
from .optim.vi_ba import VIBAProblem
from .pipeline.programs import LocalPoints
from .utils.config import SlamConfig


def camera_from_jax(cam) -> Camera:
    """The port's Camera with the fields of a JAX-package Camera."""
    return Camera(**{f.name: getattr(cam, f.name) for f in dataclasses.fields(Camera)})


def config_from_jax(cfg) -> SlamConfig:
    """The port's SlamConfig with the fields of a JAX-package SlamConfig."""
    return SlamConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(SlamConfig)})


def desc_tensor(desc: np.ndarray, device="cuda") -> torch.Tensor:
    """(..., 8) uint32 descriptor words as an int32 tensor on `device`."""
    return torch.from_numpy(np.array(desc, np.uint32).view(np.int32)).to(device)  # a writable copy


_INT_FIELDS = ("level", "obs_cam", "obs_level", "obs_rig", "e_i", "e_j")
_BOOL_FIELDS = ("valid", "cam_fixed", "p_valid", "obs_valid", "fixed", "pre_valid", "e_valid")


def _tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name == "desc":
        return desc_tensor(a, device)
    if name in _BOOL_FIELDS:
        a = a.astype(bool)
    elif name in _INT_FIELDS:
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def features_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Features:
    return Features(**{k: _tensor(k, arrays[k], device) for k in Features._fields})


def local_points_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> LocalPoints:
    return LocalPoints(**{k: _tensor(k, arrays[k], device) for k in LocalPoints._fields})


def local_points_from_map(m: MapState, ids: np.ndarray, cap: int, device="cuda") -> LocalPoints:
    """The map points `ids` (at most `cap`) as a LocalPoints view padded
    to `cap` rows, on `device`."""
    ids = np.asarray(ids)[:cap]
    fields = {"pos": m.mp_pos, "desc": m.mp_desc, "normal": m.mp_normal, "min_dist": m.mp_min_dist,
              "max_dist": m.mp_max_dist, "valid": m.mp_valid, "angle": m.mp_angle}
    padded = {}
    for k, a in fields.items():
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[: len(ids)] = True if k == "valid" else a[ids]
        padded[k] = out
    return local_points_from_numpy(padded, device)


def ba_problem_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> BAProblem:
    """A windowed BA problem from its padded arrays (the fields of the JAX
    package's BAProblem; the rig fields may be absent or None)."""
    return BAProblem(**_problem_fields(BAProblem, arrays, device))


def imu_calib_from_jax(calib) -> ImuCalib:
    """The port's ImuCalib with the values of a JAX-package ImuCalib (the
    extrinsics as host float32 arrays)."""
    return ImuCalib(Rbc=np.asarray(calib.Rbc, np.float32), tbc=np.asarray(calib.tbc, np.float32),
                    noise_g=float(calib.noise_g), noise_a=float(calib.noise_a),
                    walk_g=float(calib.walk_g), walk_a=float(calib.walk_a))


def preintegrated_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Preintegrated:
    """A Preintegrated (or a stack of them) from its fields."""
    return Preintegrated(**{k: _tensor(k, arrays[k], device) for k in Preintegrated._fields})


def vi_state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> VIState:
    return VIState(**{k: _tensor(k, arrays[k], device) for k in VIState._fields})


def vi_prior_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> VIPrior:
    return VIPrior(**{k: _tensor(k, arrays[k], device) for k in VIPrior._fields})


def vi_ba_problem_from_numpy(arrays: Mapping, device="cuda") -> VIBAProblem:
    """A windowed VI-BA problem from its padded arrays; `pre` is a mapping
    of the stacked preintegrations' fields (the rig fields may be absent
    or None)."""
    return VIBAProblem(pre=preintegrated_from_numpy(arrays["pre"], device),
                       **_problem_fields(VIBAProblem, arrays, device, skip=("pre",)))


def _problem_fields(cls, arrays: Mapping, device, skip=()) -> dict:
    """The fields of a BA problem class as tensors; an optional field
    (default None) that is absent or None (also `np.asarray(None)`) stays
    None."""
    out = {}
    for k in cls._fields:
        if k in skip:
            continue
        a = arrays.get(k) if k in cls._field_defaults else arrays[k]
        out[k] = None if a is None or np.asarray(a).dtype == object else _tensor(k, a, device)
    return out


def pose_graph_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> PoseGraphProblem:
    """An essential-graph problem from the fields of the JAX package's
    PoseGraphProblem."""
    return PoseGraphProblem(**{k: _tensor(k, arrays[k], device) for k in PoseGraphProblem._fields})


def sim3_from_numpy(s, R, t, device="cuda") -> tuple:
    """A Sim(3) triple (s, R, t), scalars or batches, as float32 tensors."""
    return tuple(_tensor("sim3", a, device) for a in (s, R, t))


def to_numpy(container) -> dict:
    """Fields of a port NamedTuple (Features, LocalPoints, TrackResult,
    BAProblem) as numpy arrays, descriptors viewed back as uint32; a field
    that is None (a problem's unused rig slots) stays None."""
    out = {}
    for k, v in container._asdict().items():
        if v is None:
            out[k] = None
            continue
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k == "desc" else a
    return out


def map_state_to_numpy(m) -> dict:
    """Every array and counter of a MapState (either package's: both are
    host numpy) as a dict of copies; the config under "cfg", and the fisheye
    rig's (R_rl, t_rl) under "rig" where the map has one. The port's
    `mp_born` stays out: it orders one process's readers against its
    writers, and a copy starts with every slot born at version 0."""
    out = {"cfg": dataclasses.asdict(m.cfg)}
    if m.rig is not None:
        out["rig"] = tuple(np.array(a, np.float32) for a in m.rig)
    for k, v in vars(m).items():
        if k == "mp_born":
            continue
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif isinstance(v, (int, float, list, dict)) and k != "cfg":
            out[k] = type(v)(v)
    return out


def map_state_from_numpy(arrays: Mapping) -> MapState:
    """The port's MapState holding copies of what `map_state_to_numpy`
    gave."""
    m = MapState(MapConfig(**arrays["cfg"]))
    for k, v in arrays.items():
        if k == "rig":
            m.rig = tuple(np.array(a) for a in v)
        elif k != "cfg":
            setattr(m, k, v.copy() if isinstance(v, np.ndarray) else type(v)(v))
    return m
