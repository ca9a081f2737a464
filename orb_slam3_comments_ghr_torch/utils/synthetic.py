"""Synthetic two-plane scene, camera arc and local map (numpy only).

Re-implements `make_textured_scene`, `render_image` and
`circular_trajectory` of `orb_slam3_comments_ghr_tpu/utils/synthetic.py`
(the same arithmetic, so the same images), the exact two-plane depth map,
and a `LocalPoints` builder that back-projects keyframe features with that
depth the way the map's point-geometry update sets normals and distance
bands. Runs where JAX is absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cameras, lie
from ..pipeline.programs import LocalPoints


@dataclasses.dataclass
class TexturedScene:
    """Two fronto-parallel textured planes (near square over a far
    backdrop): exactly renderable and view-consistent, so the FAST/ORB front
    end re-finds the same corners across frames."""

    tex_far: np.ndarray     # (T,T) texture of the far plane
    tex_near: np.ndarray
    z_far: float
    z_near: float
    near_extent: float      # near plane covers |x|,|y| <= near_extent
    scale: float            # texels per meter


def make_textured_scene(seed: int, tex_size: int = 1024, z_far: float = 14.0,
                        z_near: float = 8.0, near_extent: float = 3.0,
                        span: float = 40.0) -> TexturedScene:
    rng = np.random.default_rng(seed)

    def multiscale(t):
        img = np.zeros((t, t), np.float32)
        amp = 1.0
        for cell in (4, 8, 16, 32):
            g = rng.random((t // cell, t // cell)).astype(np.float32)
            img += amp * np.kron(g, np.ones((cell, cell), np.float32))
            amp *= 0.6
        img -= img.min()
        return img / img.max() * 215.0 + 20.0

    return TexturedScene(
        tex_far=multiscale(tex_size),
        tex_near=multiscale(tex_size),
        z_far=z_far,
        z_near=z_near,
        near_extent=near_extent,
        scale=tex_size / span,
    )


def circular_trajectory(n_frames: int, radius: float = 2.0, z_amp: float = 0.2,
                        look_at=(0.0, 0.0, 10.0), arc: float = 0.8,
                        outward: bool = False):
    """List of (R_cw, t_cw) float32 world->cam poses on a horizontal arc,
    looking at a fixed target (or radially outward)."""
    poses = []
    look = np.asarray(look_at)
    for i in range(n_frames):
        a = arc * 2 * np.pi * i / n_frames
        c = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), z_amp * np.sin(3 * a)])
        fwd = np.array([np.sin(a), 0.0, np.cos(a)]) if outward else look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_cw = np.stack([right, down, fwd], axis=1).T
        poses.append((R_cw.astype(np.float32), (-R_cw @ c).astype(np.float32)))
    return poses


def fisheye_rays(cam):
    """A KB8 camera's per-pixel rays (h,w,3) with z = 1 (float64), from the
    exact inverse of its theta polynomial (Newton to convergence, no
    clamp), and (h,w) bool: the ray lies less than 90 degrees from the
    optical axis. A pixel beyond 90 degrees sees nothing."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    mx, my = (u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy
    theta_d = np.hypot(mx, my)
    k1, k2, k3, k4 = cam.k1, cam.k2, cam.k3, cam.k4
    theta = theta_d.copy()
    for _ in range(30):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        theta = theta - f / (1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4))))
    valid = (theta < np.pi / 2) & (np.abs(f) < 1e-9)
    # on the axis the pinhole limit; a pixel that sees nothing keeps the
    # pinhole ray, which the renderers mask
    scale = np.where(valid & (theta_d > 1e-12), np.tan(np.where(valid, theta, 0.0))
                     / np.maximum(theta_d, 1e-12), 1.0)
    return np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1), valid


def _rays(cam, R_cw, t_cw):
    """Per-pixel camera rays (h,w,3) with z = 1, world rays, the camera
    centre, and the pixels that see the scene ((h,w) bool; all of them for
    a pinhole camera; `fisheye_rays` for KB8)."""
    if cam.kind == cameras.PINHOLE:
        u, v = np.meshgrid(np.arange(cam.width, dtype=np.float32),
                           np.arange(cam.height, dtype=np.float32))
        rays_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
        valid = np.ones(u.shape, bool)
    else:
        rays_c, valid = fisheye_rays(cam)
        rays_c = rays_c.astype(np.float32)
    R_wc = R_cw.T
    return rays_c, rays_c @ R_wc.T, -R_wc @ t_cw, valid


def render_image(scene: TexturedScene, cam, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Exact render (per-pixel plane intersection + nearest-texel
    sampling) through the camera's model, pinhole or KB8; (h, w) float32,
    40 where no plane is seen."""
    _, rays_w, c, seen = _rays(cam, R_cw, t_cw)

    def sample(tex, z_plane):
        lam = (z_plane - c[2]) / rays_w[..., 2]
        X = c[None, None, :] + lam[..., None] * rays_w
        tx = X[..., 0] * scene.scale + tex.shape[1] / 2
        ty = X[..., 1] * scene.scale + tex.shape[0] / 2
        ti = np.clip(np.round(ty).astype(np.int64), 0, tex.shape[0] - 1)
        tj = np.clip(np.round(tx).astype(np.int64), 0, tex.shape[1] - 1)
        return tex[ti, tj], X, lam

    img_far, _, lam_far = sample(scene.tex_far, scene.z_far)
    img_near, X_near, lam_near = sample(scene.tex_near, scene.z_near)
    near_hit = (
        (np.abs(X_near[..., 0]) <= scene.near_extent)
        & (np.abs(X_near[..., 1]) <= scene.near_extent)
        & (lam_near > 0)
    )
    img = np.where(near_hit & (lam_far > 0), img_near, img_far)
    img = np.where((lam_far > 0) & seen, img, 40.0)
    return img.astype(np.float32)


def depth_map(scene: TexturedScene, cam, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Exact per-pixel z-depth of the two-plane scene; (h, w) float32, 0
    where no plane is hit."""
    _, rays_w, c, seen = _rays(cam, R_cw, t_cw)
    lam_far = (scene.z_far - c[2]) / rays_w[..., 2]
    lam_near = (scene.z_near - c[2]) / rays_w[..., 2]
    X_near = c[None, None, :] + lam_near[..., None] * rays_w
    near_hit = (
        (np.abs(X_near[..., 0]) <= scene.near_extent)
        & (np.abs(X_near[..., 1]) <= scene.near_extent)
        & (lam_near > 0)
    )
    # rays have z = 1 in the camera frame, so the ray parameter is the depth
    lam = np.where(near_hit & (lam_far > 0), lam_near, lam_far)
    return np.where((lam > 0) & seen, lam, 0.0).astype(np.float32)


def local_points_from_keyframes(cam, feats_list, poses, depth_maps, cap: int,
                                n_levels: int = 8, scale: float = 1.2) -> LocalPoints:
    """`LocalPoints` from keyframe features: every valid keypoint with depth
    at its nearest pixel is back-projected (a KB8 keypoint through its
    undistorted position under the virtual pinhole); its normal is the unit vector
    from the keyframe centre, max_dist = dist * scale^level and
    min_dist = max_dist / scale^(n_levels-1); descriptor and angle are the
    keyframe's. Keyframes are taken in order, truncated and padded to
    `cap`. The result lies on the device of the features."""
    pos, desc, normal, dist_all, level, angle = [], [], [], [], [], []
    for f, (R_cw, t_cw), depth in zip(feats_list, poses, depth_maps):
        xy = f.xy.cpu().numpy()
        ok = f.valid.cpu().numpy()
        px = np.clip(np.round(xy).astype(np.int64), 0, [depth.shape[1] - 1, depth.shape[0] - 1])
        z = depth[px[:, 1], px[:, 0]]
        ok &= z > 0
        if cam.kind != cameras.PINHOLE:
            xy = cameras.undistort_points(cam, f.xy).cpu().numpy()
        pc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z, (xy[:, 1] - cam.cy) / cam.fy * z, z], -1)
        pw = (pc[ok] - t_cw) @ R_cw  # R^T (pc - t)
        d = pw - (-R_cw.T @ t_cw)
        dist = np.linalg.norm(d, axis=-1)
        pos.append(pw)
        normal.append(d / np.maximum(dist[:, None], 1e-9))
        dist_all.append(dist)
        level.append(f.level.cpu().numpy()[ok])
        desc.append(f.desc.cpu().numpy()[ok])
        angle.append(f.angle.cpu().numpy()[ok])

    n = min(cap, sum(len(p) for p in pos))

    def padded(parts, dtype):
        a = np.concatenate(parts)[:n].astype(dtype)
        out = np.zeros((cap,) + a.shape[1:], dtype)
        out[:n] = a
        return torch.from_numpy(out).to(feats_list[0].xy.device)

    max_dist = np.concatenate(dist_all) * scale ** np.concatenate(level).astype(np.float64)
    return LocalPoints(
        pos=padded(pos, np.float32),
        desc=padded(desc, np.int32),
        normal=padded(normal, np.float32),
        min_dist=padded([max_dist / scale ** (n_levels - 1)], np.float32),
        max_dist=padded([max_dist], np.float32),
        valid=torch.arange(cap, device=feats_list[0].xy.device) < n,
        angle=padded(angle, np.float32),
    )


@dataclasses.dataclass
class World:
    points: np.ndarray       # (W,3)
    desc: np.ndarray         # (W,8) uint32 per-landmark descriptor
    patches: np.ndarray      # (W,21,21) float32 texture patch
    priority: np.ndarray     # (W,) detection priority: a real detector
                             # re-finds the same strong corners every frame


def make_world(seed: int, n_points: int = 4000, extent=(20.0, 12.0, 8.0),
               center=(0.0, 0.0, 10.0)) -> World:
    """Random landmarks in a box, with descriptors, patches and detection
    priorities (the JAX package's `make_world`, same draws)."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n_points, 3)) - 0.5) * np.asarray(extent) + np.asarray(center)
    desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
    patches = rng.random((n_points, 21, 21)).astype(np.float32) * 200.0 + 30.0
    priority = rng.random(n_points).astype(np.float32)
    return World(points=pts.astype(np.float32), desc=desc, patches=patches, priority=priority)


def make_ring_world(seed: int, n_points: int = 6000, r_min: float = 6.0,
                    r_max: float = 18.0, height: float = 8.0) -> World:
    """Landmarks on an annulus around the origin, for outward-looking loop
    trajectories where every heading sees other structure (the JAX
    package's `make_ring_world`, same draws)."""
    rng = np.random.default_rng(seed)
    a = rng.random(n_points) * 2 * np.pi
    r = rng.random(n_points) * (r_max - r_min) + r_min
    pts = np.stack([r * np.sin(a), (rng.random(n_points) - 0.5) * height, r * np.cos(a)], -1)
    desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
    patches = rng.random((n_points, 21, 21)).astype(np.float32) * 200.0 + 30.0
    priority = rng.random(n_points).astype(np.float32)
    return World(points=pts.astype(np.float32), desc=desc, patches=patches, priority=priority)


def render_features(world: World, cam, R_cw: np.ndarray, t_cw: np.ndarray, n_feat: int = 1024,
                    noise_px: float = 0.4, desc_flip_bits: int = 6, seed: int = 0,
                    stereo: bool = False, device="cuda"):
    """Project the landmarks into the view and emit Features (on `device`)
    with per-landmark descriptors, a few bits flipped per observation: the
    ideal front end. With `stereo` (and a camera with bf > 0) every feature
    also gets its depth, with 1 cm of noise, and the matching right-image u.
    A KB8 camera projects through its fisheye model, so the features hold
    raw fisheye pixels. Returns (features, landmark ids). The same draws and
    arithmetic as the JAX package's `render_features`."""
    from ..frontend.types import Features

    rng = np.random.default_rng(seed)
    pc = world.points @ R_cw.T + t_cw
    z = pc[:, 2]
    pc32 = pc.astype(np.float32)
    if cam.kind == cameras.PINHOLE:
        # the pinhole projection in float32, as the JAX package computes it
        inv_z = np.float32(1.0) / np.where(np.abs(pc32[:, 2]) < 1e-9, np.float32(1e-9), pc32[:, 2])
        uv = np.stack([np.float32(cam.fx) * pc32[:, 0] * inv_z + np.float32(cam.cx),
                       np.float32(cam.fy) * pc32[:, 1] * inv_z + np.float32(cam.cy)], -1)
    else:  # raw fisheye pixels, as a real extractor on the KB8 image gives them
        uv = cameras.project(cam, torch.from_numpy(pc32)).numpy()
    margin = 10.0
    vis = ((z > 0.3) & (uv[:, 0] >= margin) & (uv[:, 0] < cam.width - margin)
           & (uv[:, 1] >= margin) & (uv[:, 1] < cam.height - margin))
    ids = np.nonzero(vis)[0]
    # strongest first, with a small per-frame dropout (detection flicker)
    ids = ids[rng.random(len(ids)) > 0.05]
    ids = ids[np.argsort(-world.priority[ids])][:n_feat]
    n = len(ids)

    xy = np.zeros((n_feat, 2), np.float32)
    desc = np.zeros((n_feat, 8), np.uint32)
    level = np.zeros((n_feat,), np.int32)
    xy[:n] = uv[ids] + rng.normal(0, noise_px, (n, 2))
    desc[:n] = world.desc[ids]
    for _ in range(desc_flip_bits):
        word = rng.integers(0, 8, n)
        bit = rng.integers(0, 32, n).astype(np.uint32)
        desc[np.arange(n), word] ^= (np.uint32(1) << bit)
    level[:n] = (rng.random(n) < 0.15).astype(np.int32)
    valid = np.zeros((n_feat,), bool)
    valid[:n] = True
    u_right = np.full((n_feat,), -1.0, np.float32)
    depth = np.full((n_feat,), -1.0, np.float32)
    if stereo and cam.bf > 0:
        zs = pc[ids, 2].astype(np.float32)
        depth[:n] = zs + rng.normal(0, 0.01, n)
        u_right[:n] = xy[:n, 0] - cam.bf / np.maximum(depth[:n], 1e-6)
    t = lambda a: torch.from_numpy(a).to(device)
    return Features(
        xy=t(xy), level=t(level), angle=t(np.zeros((n_feat,), np.float32)),
        response=t(np.where(valid, np.float32(1.0), np.float32(-np.inf))),
        desc=t(desc.view(np.int32)), valid=t(valid),
        u_right=t(u_right), depth=t(depth),
    ), ids


def vi_sequence(n_frames: int, cam_hz: float = 20.0, imu_hz: float = 200.0, radius: float = 2.0,
                look_at=(0.0, 0.0, 10.0), arc: float = 0.8, gravity_tilt=(0.15, -0.1),
                outward: bool = False):
    """Camera poses and consistent IMU samples along a smooth analytic arc
    (the JAX package's `vi_sequence`, the same arithmetic, so the same
    rows). The world is not gravity-aligned: gravity points along
    R_tilt (0, 0, -g), so the IMU initialization has work to do. Body
    frame == camera frame (Tbc = I). With `outward`, the camera looks
    radially out from the arc's centre, as `circular_trajectory`'s outward
    ring does (a turn that revisits its start, for loop closing), instead
    of at `look_at`. Returns (poses, imu_rows (M,7), timestamps)."""
    from ..optim.imu import GRAVITY

    look = np.asarray(look_at, np.float64)
    T_total = n_frames / cam_hz

    def pose_at(t):
        a = arc * 2 * np.pi * t / T_total
        c = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), 0.2 * np.sin(3 * a)])
        fwd = np.array([np.sin(a), 0.0, np.cos(a)]) if outward else look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        return np.stack([right, down, fwd], axis=1), c

    # the JAX package takes these two maps in float32 (its so3_exp / so3_log
    # on float32 arrays); the port's on float32 CPU tensors give the same bits
    R_tilt = lie.so3_exp(torch.tensor([gravity_tilt[0], gravity_tilt[1], 0.0])).numpy()
    g_world = R_tilt @ np.array([0.0, 0.0, -GRAVITY])

    poses = []
    for i in range(n_frames):
        R_wc, c = pose_at(i / cam_hz)
        R_cw = R_wc.T
        poses.append((R_cw.astype(np.float32), (-R_cw @ c).astype(np.float32)))

    # IMU at imu_hz by central differences of the analytic pose
    h = 1e-4
    ts, f_bs, dRs = [], [], []
    for j in range(1, int(T_total * imu_hz)):
        t = j / imu_hz
        R0, c0 = pose_at(t - h)
        R1, c1 = pose_at(t)
        R2, c2 = pose_at(t + h)
        a_w = (c2 - 2 * c1 + c0) / (h * h)
        ts.append(t)
        f_bs.append(R1.T @ (a_w - g_world))
        dRs.append(R1.T @ R2)  # body-frame increment over h
    w_b = lie.so3_log(torch.from_numpy(np.asarray(dRs, np.float32))).numpy() / h
    rows = np.concatenate([np.asarray(ts)[:, None], np.asarray(f_bs), w_b], axis=1)
    return poses, rows, [i / cam_hz for i in range(n_frames)]


def gt_trajectory(poses) -> list:
    """(timestamp, 4x4 Tcw) per pose, at 20 Hz."""
    out = []
    for i, (R, t) in enumerate(poses):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        out.append((i * 0.05, T))
    return out


def write_tum_groundtruth(path: str, poses, timestamps) -> None:
    """The poses (R_cw, t_cw) as a TUM ground-truth file, `t x y z qx qy qz
    qw` of the camera in the world per line: what `io/run_slam.py --gt`
    reads."""
    with open(path, "w") as f:
        for ts, (R, t) in zip(timestamps, poses):
            R_wc = np.asarray(R, np.float32).T
            c = -R_wc @ np.asarray(t, np.float32)
            q = lie.mat_to_quat(torch.from_numpy(np.ascontiguousarray(R_wc))).numpy()
            f.write(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
