"""Per-dataset presets: camera intrinsics + tuned pipeline configurations.

The SLAM analog of a model zoo — one call gives the (Camera, SlamConfig,
ImuCalib) triple for a standard benchmark, mirroring the reference's shipped
YAMLs (Examples/*/EuRoC.yaml, TUM-VI.yaml, the fork's orbbec335L_rgbd.yaml).

Port of `orb_slam3_comments_ghr_tpu/models/presets.py`: the same numbers,
the IMU extrinsics as host numpy (the port's `ImuCalib` takes either)."""

from __future__ import annotations

import numpy as np

from ..ops import cameras
from ..optim import imu as imu_mod
from ..utils.config import (
    SlamConfig, MONOCULAR, RGBD, IMU_MONOCULAR, IMU_STEREO, IMU_RGBD,
)


def _calib(Tbc, noise_g, noise_a, walk_g, walk_a, rate: float = 200.0) -> imu_mod.ImuCalib:
    """Continuous-time sigmas discretized at `rate` (noise sigma*sqrt(rate),
    walk sigma/sqrt(rate), Tracking.cc:680-681)."""
    sf = rate ** 0.5
    Tbc = np.asarray(Tbc, np.float32)
    return imu_mod.ImuCalib(Rbc=Tbc[:3, :3].copy(), tbc=Tbc[:3, 3].copy(),
                            noise_g=noise_g * sf, noise_a=noise_a * sf,
                            walk_g=walk_g / sf, walk_a=walk_a / sf)


def euroc(sensor: int = MONOCULAR):
    """EuRoC MAV (rectified pinhole, ADIS16448 IMU @200 Hz)."""
    cam = cameras.euroc_cam0()
    cfg = SlamConfig(sensor=sensor, n_features=1024, max_frames_between_kf=20)
    calib = None
    if sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
        # cam0->body (IMU) extrinsics from the EuRoC sensor.yaml (the
        # standard ORB-SLAM3 EuRoC Tbc; ~90 deg cam/IMU rotation)
        calib = _calib([
            [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
            [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
            [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
            [0.0, 0.0, 0.0, 1.0],
        ], 1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
    return cam, cfg, calib


def tum_vi(sensor: int = IMU_MONOCULAR):
    """TUM-VI (512x512 fisheye KB8, BMI160 IMU @200 Hz)."""
    cam = cameras.Camera(
        kind=cameras.KANNALA_BRANDT8,
        fx=190.978477, fy=190.973307, cx=254.931706, cy=256.897442,
        k1=0.003482389402, k2=0.000715034845, k3=-0.002053236141,
        k4=0.000202936736, width=512, height=512, fps=20.0,
    )
    cfg = SlamConfig(sensor=sensor, n_features=1024, max_frames_between_kf=20)
    calib = None
    if sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
        # cam0->body extrinsics from the ORB-SLAM3 TUM-VI 512 config
        calib = _calib([
            [-0.9995250378696743, 0.0296153438858632, -0.0085223282116547, 0.0472798822491439],
            [0.0075019185074052, 0.0343973606139314, 0.9993800792498829, -0.0474432321433671],
            [-0.0298901303164331, -0.9989693453701750, 0.0341588512738562, -0.0681999605066297],
            [0.0, 0.0, 0.0, 1.0],
        ], 0.00016, 0.0028, 2.2e-5, 8.6e-4)
    return cam, cfg, calib


def tum_rgbd():
    """TUM RGB-D freiburg-style pinhole."""
    cam = cameras.Camera(
        kind=cameras.PINHOLE,
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        width=640, height=480, bf=40.0, fps=30.0,
    )
    return cam, SlamConfig(sensor=RGBD, n_features=1024, max_frames_between_kf=30), None


PRESETS = {"euroc": euroc, "tum_vi": tum_vi, "tum_rgbd": tum_rgbd}
