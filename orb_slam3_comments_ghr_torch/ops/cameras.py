"""Pinhole camera model.

Port of the pinhole part of `orb_slam3_comments_ghr_tpu/ops/cameras.py`.
The Kannala-Brandt fisheye model is not ported yet: `project`,
`project_jac` and `unproject` raise for it.
"""

from __future__ import annotations

import dataclasses

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


def camera_matrix(cam: Camera, device=None) -> torch.Tensor:
    """The (3,3) float32 intrinsic matrix, the JAX package's `Camera.K`."""
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def _require_pinhole(cam: Camera):
    if cam.kind != PINHOLE:
        raise NotImplementedError("only the pinhole camera model is ported")


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (...,3) -> pixel coords (...,2)."""
    _require_pinhole(cam)
    inv_z = _inv_z(pc[..., 2])
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_jac(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(u,v)/d(pc): (...,2,3)."""
    _require_pinhole(cam)
    x, y = pc[..., 0], pc[..., 1]
    inv_z = _inv_z(pc[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (...,2) -> bearing (...,3) with z = 1."""
    _require_pinhole(cam)
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)


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
