"""Camera projection models: pinhole and Kannala-Brandt 8 (fisheye).

Port of `orb_slam3_comments_ghr_tpu/ops/cameras.py` (GeometricCamera,
reference src/CameraModels/Pinhole.cpp and KannalaBrandt8.cpp). A camera is
a frozen dataclass of intrinsics and a `kind`; each function switches on the
kind in Python, so every tensor op runs for one model only.

KB8 projects through the theta polynomial theta_d = theta (1 + k1 theta^2 +
... + k4 theta^8) with an on-axis pinhole branch, and unprojects by exactly
10 Newton steps from theta_d clamped to +-pi/2 (the reference's fixed count,
not iterated to convergence). Its Jacobian is the closed form of that
projection. A fisheye system extracts on the raw image and runs its
geometry on undistorted keypoints under `pinhole_equivalent(cam)`
(Frame::UndistortKeyPoints); `undistort_points` is that map.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera intrinsics. fx, fy, cx, cy always; k1..k4 for KB8;
    width/height for frustum bounds; bf = baseline*fx for stereo."""

    kind: int
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    width: int = 752
    height: int = 480
    bf: float = 0.0
    fps: float = 20.0

    @property
    def baseline(self) -> float:
        """Stereo baseline in metres (bf / fx), 0 for a monocular camera."""
        return self.bf / self.fx if self.bf > 0 else 0.0


_K_ON_CARD: dict = {}


def camera_matrix(cam: Camera, device=None) -> torch.Tensor:
    """The (3,3) float32 intrinsic matrix, the JAX package's `Camera.K`. On
    the card it is made once per camera and device and shared (its callers
    only read it): a new one is a blocking copy from the host, which the
    mapper's new-point program would make twice per neighbour keyframe."""
    if device is not None and torch.device(device).type == "cuda":
        key = (cam, torch.device(device))
        if key not in _K_ON_CARD:
            _K_ON_CARD[key] = camera_matrix(cam).to(key[1])
        return _K_ON_CARD[key]
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _kb8_radius(cam: Camera, pc: torch.Tensor):
    """(r, theta, theta_d) of KB8's projection: the distance from the
    optical axis (floored at 1e-9), the angle from it, and the polynomial."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * cam.k4))))
    return r, theta, theta_d


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (...,3) -> pixel coords (...,2). KB8: the
    theta polynomial (KannalaBrandt8.cpp:40-118), the pinhole limit within
    1e-8 of the axis."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    if cam.kind == PINHOLE:
        inv_z = _inv_z(z)
        return torch.stack([cam.fx * x * inv_z + cam.cx, cam.fy * y * inv_z + cam.cy], dim=-1)
    r, _, theta_d = _kb8_radius(cam, pc)
    scale = theta_d / torch.clamp_min(r, 1e-12)
    small = r < 1e-8
    zc = torch.clamp_min(z, 1e-9)
    u = torch.where(small, cam.cx + cam.fx * x / zc, cam.fx * x * scale + cam.cx)
    v = torch.where(small, cam.cy + cam.fy * y / zc, cam.fy * y * scale + cam.cy)
    return torch.stack([u, v], dim=-1)


def project_jac(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(u,v)/d(pc): (...,2,3). KB8: the closed form of `project`'s
    branches (KannalaBrandt8.cpp:229-320): with s = theta_d / r,
    du/dx = fx (s + x^2/r ds/dr), du/dy = fx x y/r ds/dr,
    du/dz = fx x/r dtheta_d/dtheta dtheta/dz, and v alike."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zero = torch.zeros_like(x)
    if cam.kind == PINHOLE:
        inv_z = _inv_z(z)
        inv_z2 = inv_z * inv_z
        row_u = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
        row_v = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
    r, theta, theta_d = _kb8_radius(cam, pc)
    t2 = theta * theta
    dtd = 1.0 + t2 * (3.0 * cam.k1 + t2 * (5.0 * cam.k2 + t2 * (7.0 * cam.k3 + t2 * 9.0 * cam.k4)))
    rho2 = r * r + z * z
    s = theta_d / r
    ds_dr = (dtd * z / rho2 - s) / r           # d(theta_d / r)/dr
    ds_dz = -dtd / rho2                          # d(theta_d / r)/dz
    gx, gy = x / r, y / r
    kb_u = torch.stack([cam.fx * (s + x * ds_dr * gx), cam.fx * x * ds_dr * gy,
                        cam.fx * x * ds_dz], dim=-1)
    kb_v = torch.stack([cam.fy * y * ds_dr * gx, cam.fy * (s + y * ds_dr * gy),
                        cam.fy * y * ds_dz], dim=-1)
    # on the axis: the pinhole limit of `project`, 1/z floored at 1e-9
    zc = torch.clamp_min(z, 1e-9)
    live = (z > 1e-9).to(x.dtype)
    axis_u = torch.stack([cam.fx / zc, zero, -cam.fx * x / (zc * zc) * live], dim=-1)
    axis_v = torch.stack([zero, cam.fy / zc, -cam.fy * y / (zc * zc) * live], dim=-1)
    small = (r < 1e-8)[..., None]
    return torch.stack([torch.where(small, axis_u, kb_u), torch.where(small, axis_v, kb_v)],
                       dim=-2)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (...,2) -> bearing (...,3) with z = 1. KB8: 10 fixed Newton
    steps on the theta polynomial from theta_d clamped to +-pi/2
    (KannalaBrandt8.cpp:142-228), then the bearing (mx, my) tan(theta) /
    theta_d; a pixel near pi/2 from the axis gives a large finite bearing."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if cam.kind == PINHOLE:
        return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = theta_d_c
    for _ in range(10):
        t2 = theta * theta
        k_poly = cam.k1 * t2 + cam.k2 * t2 * t2 + cam.k3 * t2 ** 3 + cam.k4 * t2 ** 4
        k_poly_d = (3 * cam.k1 * t2 + 5 * cam.k2 * t2 * t2 + 7 * cam.k3 * t2 ** 3
                    + 9 * cam.k4 * t2 ** 4)
        theta = theta - (theta * (1 + k_poly) - theta_d_c) / (1 + k_poly_d)
    scale = torch.where(theta_d > 1e-8, torch.tan(theta) / torch.clamp_min(theta_d, 1e-12), 1.0)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Bounds check (...,2) -> bool (...,)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= margin) & (u < cam.width - margin) & (v >= margin) & (v < cam.height - margin)


def stereo_right_u(cam: Camera, u: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Virtual right-image u coordinate: uR = u - bf/z."""
    return u - cam.bf / torch.clamp_min(depth, 1e-9)


def pinhole_equivalent(cam: Camera) -> Camera:
    """The virtual undistorted pinhole sharing cam's fx/fy/cx/cy."""
    return dataclasses.replace(cam, kind=PINHOLE, k1=0.0, k2=0.0, k3=0.0, k4=0.0)


def undistort_points(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw (distorted) pixels (...,2) -> the virtual pinhole image of
    `pinhole_equivalent(cam)`; a pinhole camera's pixels pass through."""
    if cam.kind == PINHOLE:
        return uv
    return project(pinhole_equivalent(cam), unproject(cam, uv))


def euroc_cam0() -> Camera:
    """EuRoC MAV cam0 intrinsics (rectified pinhole)."""
    return Camera(
        kind=PINHOLE,
        fx=435.2046959714599,
        fy=435.2046959714599,
        cx=367.4517211914062,
        cy=252.2008514404297,
        width=752,
        height=480,
        bf=47.90639384423901,
        fps=20.0,
    )
