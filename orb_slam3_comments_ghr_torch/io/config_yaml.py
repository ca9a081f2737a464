"""Reference-compatible YAML settings ingestion.

Replaces the Settings loader (reference: src/Settings.cc, Settings.h:128-163):
reads the same `File.version: "1.0"` key schema (Camera1.fx, Camera.width,
ORBextractor.nFeatures, IMU.NoiseGyro, ...) plus the legacy flat keys
(Camera.fx, ORBextractor.*, Tracking.cc:691 parsers) so reference YAMLs run
unmodified. Missing REQUIRED keys raise with the key name, like the
reference's hard exit (Settings.h:128-151).

Port of `orb_slam3_comments_ghr_tpu/io/config_yaml.py`: the same keys and
results; the IMU extrinsics stay host numpy (the port's `ImuCalib` takes
either) and a raw stereo YAML builds the port's `io/rectify` rectifier.
PyYAML is imported only when a file is read."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import cameras
from ..optim import imu as imu_mod
from ..utils.config import (
    SlamConfig, MONOCULAR, STEREO, RGBD, IMU_MONOCULAR, IMU_STEREO, IMU_RGBD,
)

SENSOR_NAMES = {
    "MONOCULAR": MONOCULAR, "STEREO": STEREO, "RGBD": RGBD,
    "IMU_MONOCULAR": IMU_MONOCULAR, "IMU_STEREO": IMU_STEREO,
    "IMU_RGBD": IMU_RGBD,
}


def _load_flat(path: str) -> dict:
    """cv::FileStorage YAMLs start with '%YAML:1.0' which PyYAML rejects;
    strip directives, accept `!!opencv-matrix` tagged mappings (Tbc etc.),
    parse, and flatten 'A.b' style keys."""
    import yaml

    class _CvLoader(yaml.SafeLoader):
        pass

    def _mat(loader, node):
        return loader.construct_mapping(node, deep=True)

    _CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _mat)
    _CvLoader.add_constructor("!opencv-matrix", _mat)

    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    doc = yaml.load("\n".join(lines), Loader=_CvLoader) or {}
    # cv::FileStorage files use literal dotted keys ("Camera.fx: 458"), which
    # PyYAML keeps as-is; nested mappings are flattened one level.
    flat = {}
    for k, v in doc.items():
        # cv matrices (rows/cols/dt/data mappings, e.g. IMU.T_b_c1) must stay
        # whole — flattening them would lose the 4x4 extrinsics
        if isinstance(v, dict) and "data" not in v:
            for k2, v2 in v.items():
                flat[f"{k}.{k2}"] = v2
        else:
            flat[k] = v
    return flat


def _req(flat: dict, *names):
    for n in names:
        if n in flat:
            return flat[n]
    raise KeyError(
        f"required setting missing: one of {names} (Settings.h hard-exit semantics)"
    )


def _opt(flat: dict, default, *names):
    for n in names:
        if n in flat:
            return flat[n]
    return default


def _rig_from_flat(flat: dict):
    """Stereo rectification precompute (Settings.h:153-163 needToRectify):
    raw stereo YAMLs declare Camera2.* + Stereo.T_c1_c2 (right-in-left
    extrinsics); build the undistort+rectify maps and the rectified rig.
    Returns a rectify.StereoRectifier, or None when the YAML is already
    rectified or the rig is fisheye (KB8 rigs are matched unrectified,
    Settings.cc:153 area / SLAM.track_stereo_fisheye)."""
    if "Camera2.fx" not in flat or "Stereo.T_c1_c2" not in flat:
        return None
    if "Kannala" in str(_opt(flat, "PinHole", "Camera.type", "Camera1.type")):
        return None
    from .rectify import build_rectifier

    node = flat["Stereo.T_c1_c2"]
    T = np.asarray(node["data"], np.float64).reshape(4, 4)

    def intr(prefix):
        return {
            k: float(_opt(flat, 0.0, f"{prefix}.{k}"))
            for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")
        }

    return build_rectifier(
        intr("Camera1"), intr("Camera2"), T[:3, :3], T[:3, 3],
        width=int(_opt(flat, 752, "Camera.width", "Camera1.width")),
        height=int(_opt(flat, 480, "Camera.height", "Camera1.height")),
        fps=float(_opt(flat, 20.0, "Camera.fps")),
    )


def load_stereo_rig(path: str):
    """Public: the rectifier for a raw stereo YAML (or None)."""
    return _rig_from_flat(_load_flat(path))


def load_settings(path: str, sensor: Optional[int] = None):
    """Returns (Camera, SlamConfig, ImuCalib|None). Accepts both v1.0
    ('Camera1.fx') and legacy ('Camera.fx') key schemas. For RAW stereo
    YAMLs (Camera2 + Stereo.T_c1_c2) the returned camera is the RECTIFIED
    rig (Settings.cc precomputes the maps and swaps intrinsics the same
    way); fetch the per-frame maps with load_stereo_rig."""
    flat = _load_flat(path)
    cam_type = str(_opt(flat, "PinHole", "Camera.type", "Camera1.type"))
    kind = cameras.KANNALA_BRANDT8 if "Kannala" in cam_type else cameras.PINHOLE
    cam = cameras.Camera(
        kind=kind,
        fx=float(_req(flat, "Camera1.fx", "Camera.fx")),
        fy=float(_req(flat, "Camera1.fy", "Camera.fy")),
        cx=float(_req(flat, "Camera1.cx", "Camera.cx")),
        cy=float(_req(flat, "Camera1.cy", "Camera.cy")),
        k1=float(_opt(flat, 0.0, "Camera1.k1", "Camera.k1")),
        k2=float(_opt(flat, 0.0, "Camera1.k2", "Camera.k2")),
        k3=float(_opt(flat, 0.0, "Camera1.k3", "Camera.k3")),
        k4=float(_opt(flat, 0.0, "Camera1.k4", "Camera.k4")),
        width=int(_opt(flat, 752, "Camera.width", "Camera1.width")),
        height=int(_opt(flat, 480, "Camera.height", "Camera1.height")),
        # legacy Camera.bf is baseline*fx already; v1.0 Stereo.b is the
        # baseline in meters and must be scaled by fx (Settings.cc bf_ = b*fx)
        bf=(
            float(flat["Camera.bf"]) if "Camera.bf" in flat
            else float(_opt(flat, 0.0, "Stereo.b"))
            * float(_req(flat, "Camera1.fx", "Camera.fx"))
        ),
        fps=float(_opt(flat, 30.0, "Camera.fps")),
    )
    if sensor is None:
        sensor = MONOCULAR
    if sensor in (STEREO, IMU_STEREO):
        rig = _rig_from_flat(flat)
        if rig is not None:
            cam = rig.cam_rect
    cfg = SlamConfig(
        sensor=sensor,
        n_features=int(_opt(flat, 1024, "ORBextractor.nFeatures")),
        n_levels=int(_opt(flat, 8, "ORBextractor.nLevels")),
        scale_factor=float(_opt(flat, 1.2, "ORBextractor.scaleFactor")),
        ini_th_fast=float(_opt(flat, 20, "ORBextractor.iniThFAST")),
        min_th_fast=float(_opt(flat, 7, "ORBextractor.minThFAST")),
        max_frames_between_kf=int(cam.fps),
        depth_th_factor=float(_opt(flat, 35.0, "ThDepth", "Stereo.ThDepth", "Camera.ThDepth")),
    )
    calib = None
    if sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
        freq = float(_opt(flat, 200.0, "IMU.Frequency"))
        sf = freq ** 0.5
        # camera->body extrinsics: v1.0 `IMU.T_b_c1` / legacy `Tbc`, stored
        # as a cv 4x4 row-major matrix (Settings.cc readImu / Tracking.cc:652)
        Tbc_node = _opt(flat, None, "IMU.T_b_c1", "Tbc")
        Rbc, tbc = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        if isinstance(Tbc_node, dict) and "data" in Tbc_node:
            T = np.asarray(Tbc_node["data"], np.float32).reshape(4, 4)
            Rbc, tbc = T[:3, :3].copy(), T[:3, 3].copy()
        # noise sigma*sqrt(freq), walk sigma/sqrt(freq) (Tracking.cc:680-681)
        calib = imu_mod.ImuCalib(
            Rbc=Rbc,
            tbc=tbc,
            noise_g=float(_req(flat, "IMU.NoiseGyro")) * sf,
            noise_a=float(_req(flat, "IMU.NoiseAcc")) * sf,
            walk_g=float(_req(flat, "IMU.GyroWalk")) / sf,
            walk_a=float(_req(flat, "IMU.AccWalk")) / sf,
        )
    return cam, cfg, calib
