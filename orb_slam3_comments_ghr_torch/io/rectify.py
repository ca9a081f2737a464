"""Stereo rectification: host-precomputed undistort + rectify maps, and a
bilinear remap on the device.

Port of `orb_slam3_comments_ghr_tpu/io/rectify.py` (the reference's map
precompute in Settings, Settings.h:153-163, cv::initUndistortRectifyMap +
cv::stereoRectify; and the per-frame cv::remap of its ROS drivers,
ros_stereo_inertial.cc:102-120). From a raw rig's intrinsics and
extrinsics it computes the Bouguet rectifying rotations (a common
orientation with the baseline along x), then once, on the host, each
camera's (H, W, 2) map from rectified pixel to raw source coordinate
through the inverse rotation and the radial-tangential model. Per frame
`remap_bilinear` samples the raw image there, on the image's device. The
rectified rig is a pinhole pair with one set of intrinsics and
bf = fx * baseline: what the stereo row matcher assumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cameras
from ..utils.device import resolve_device


def _rect_rotations(R12: np.ndarray, t12: np.ndarray):
    """Bouguet rectification: the rows of R_rect are the new common axes in
    camera-1 coordinates (x along the baseline); R1 = R_rect and R2 =
    R_rect @ R12 (x_rect = R1 x_c1 = R2 x_c2 up to the baseline offset).
    Returns (R1, R2, baseline)."""
    t = np.asarray(t12, np.float64)
    nt = np.linalg.norm(t)
    e1 = t / nt
    if e1[0] < 0:
        e1 = -e1  # +x points from the left camera to the right one
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 /= n2
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])
    return R_rect, R_rect @ np.asarray(R12, np.float64), float(nt)


def _project_radtan(intr: dict, rays: np.ndarray) -> np.ndarray:
    """Projection through the radial-tangential (plumb-bob) model of raw
    EuRoC pinhole calibrations (k1 k2 p1 p2, optional k3)."""
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    k1 = intr.get("k1", 0.0)
    k2 = intr.get("k2", 0.0)
    p1 = intr.get("p1", 0.0)
    p2 = intr.get("p2", 0.0)
    k3 = intr.get("k3", 0.0)
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([intr["fx"] * xd + intr["cx"], intr["fy"] * yd + intr["cy"]], -1)


def _source_map(intr: dict, cam_new: cameras.Camera, R_rect: np.ndarray) -> np.ndarray:
    """(H, W, 2) float32: each rectified pixel's raw-image source
    coordinate (ray Knew^-1 [u v 1], rotated back by R_rect^T, projected
    through the raw distorted model)."""
    u, v = np.meshgrid(np.arange(cam_new.width, dtype=np.float64),
                       np.arange(cam_new.height, dtype=np.float64))
    rays = np.stack([(u - cam_new.cx) / cam_new.fx, (v - cam_new.cy) / cam_new.fy,
                     np.ones_like(u)], -1)
    return _project_radtan(intr, rays @ R_rect).astype(np.float32)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Bilinear remap (cv::remap, INTER_LINEAR): img (H,W) float32,
    src_map (H,W,2) the raw (x, y) of each output pixel, on img's device.
    Samples outside the image clamp to its border (BORDER_REPLICATE)."""
    h, w = img.shape
    x = torch.clamp(src_map[..., 0], 0.0, w - 1.001)
    y = torch.clamp(src_map[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


@dataclasses.dataclass
class StereoRectifier:
    """Precomputed rectification of a raw stereo rig."""

    cam_rect: cameras.Camera     # the common rectified pinhole (bf set)
    map_left: np.ndarray         # (H, W, 2)
    map_right: np.ndarray

    def rectify(self, img_left, img_right, device=None):
        """The rectified float32 pair. Tensors stay on their device; arrays
        go to `device`, the card unless the caller names another."""
        dev = img_left.device if torch.is_tensor(img_left) else resolve_device(device)

        def one(img, src_map):
            img = torch.as_tensor(img, device=dev).to(torch.float32)
            return remap_bilinear(img, torch.from_numpy(src_map).to(dev))

        return one(img_left, self.map_left), one(img_right, self.map_right)


def build_rectifier(intr1: dict, intr2: dict, R12: np.ndarray, t12: np.ndarray,
                    width: int, height: int, fps: float = 20.0) -> StereoRectifier:
    """intr1 / intr2: raw distorted-pinhole intrinsics {fx fy cx cy k1 k2
    p1 p2}; x_c1 = R12 @ x_c2 + t12 (Stereo.T_c1_c2, the right camera in
    the left one's frame)."""
    R1, R2, baseline = _rect_rotations(R12, t12)
    f_new = 0.5 * (intr1["fy"] + intr2["fy"])
    cam_rect = cameras.Camera(
        kind=cameras.PINHOLE, fx=f_new, fy=f_new, cx=width / 2.0, cy=height / 2.0,
        width=width, height=height, bf=f_new * baseline, fps=fps,
    )
    return StereoRectifier(cam_rect=cam_rect, map_left=_source_map(intr1, cam_rect, R1),
                           map_right=_source_map(intr2, cam_rect, R2))
