"""Synthetic worlds around a trajectory, for replaying it through the
pipeline (numpy only).

Copied from `orb_slam3_comments_ghr_tpu/utils/gt_replay.py`, so that the
port needs no JAX: EuRoC ground-truth loading (`load_euroc_gt`, from the
folder that `EUROC_GT_DIR` names or the caller passes; `euroc_gt_from_tum`
writes a stand-in file from a TUM trajectory), IMU samples
differentiated from the trajectory, a landmark hall, and a textured room box
rendered exactly per pixel (`make_room_scene`, `render_room`: the image-level
loop of `tests/test_image_loopclosing.py`). The same draws and arithmetic as
the JAX package, so the same images.

Ref: evaluation/evaluate_ate_scale.py:50-90 (scoring),
Ground_truth/EuRoC_left_cam/MH01_GT.txt (20 Hz T_WC poses, ns timestamps).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

GT_DIR = os.environ.get("EUROC_GT_DIR")
GRAVITY = 9.81


# ---------------------------------------------------------------- GT loading
def load_euroc_gt(seq: str = "MH01", gt_dir: str | None = None):
    """Parse {seq}_GT.txt: `t_ns, p_xyz, q_wxyz` rows of T_WC (left-camera
    pose in world). Returns (times_s (N,), R_cw (N,3,3), t_cw (N,3),
    p_wc (N,3), q_wc (N,4 wxyz)); times start at 0."""
    folder = gt_dir or GT_DIR
    if folder is None:
        raise FileNotFoundError("no EuRoC ground-truth folder: pass gt_dir or set EUROC_GT_DIR")
    rows = np.loadtxt(os.path.join(folder, f"{seq}_GT.txt"), delimiter=",", skiprows=1)
    t = rows[:, 0] / 1e9
    t = t - t[0]
    p = rows[:, 1:4]
    q = rows[:, 4:8]  # w x y z
    R_cw = np.transpose(_quat_to_mat(q), (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, p)
    return (t.astype(np.float64), R_cw.astype(np.float32), t_cw.astype(np.float32),
            p.astype(np.float64), q.astype(np.float64))


EUROC_GT_HEADER = ("timestamp [ns], p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], "
                   "q_RS_x [], q_RS_y [], q_RS_z []")


def euroc_gt_from_tum(tum_path: str, out_path: str) -> int:
    """Write a TUM trajectory (`t x y z qx qy qz qw` rows of T_WC, seconds)
    as a stand-in `{seq}_GT.txt` in EuRoC's layout (`t_ns, p_xyz, q_wxyz`
    of T_WC, one header row), the form `load_euroc_gt` reads. Returns the
    number of poses written."""
    rows = np.loadtxt(tum_path, comments="#", ndmin=2)
    out = np.concatenate([np.round(rows[:, :1] * 1e9), rows[:, 1:4], rows[:, 7:8],
                          rows[:, 4:7]], axis=1)
    np.savetxt(out_path, out, fmt=["%d"] + ["%.9f"] * 7, delimiter=",",
               header=EUROC_GT_HEADER, comments="#")
    return len(rows)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(N,4) wxyz -> (N,3,3), vectorized."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)


# ------------------------------------------------------------ IMU synthesis
def synthesize_imu(times, p_wc, q_wc, imu_hz: float = 200.0,
                   noise_g: float = 0.0, noise_a: float = 0.0, seed: int = 0):
    """IMU samples consistent with the trajectory: cubic-spline positions
    differentiated twice for the world acceleration, the gyro from SLERP
    orientation increments. Body frame = camera frame, world z up, gravity
    (0, 0, -9.81). Returns (M,7) rows [t, f_b(3), w_b(3)]."""
    from scipy.interpolate import CubicSpline
    from scipy.spatial.transform import Rotation, Slerp

    rng = np.random.default_rng(seed)
    acc_w = CubicSpline(times, p_wc, axis=0).derivative(2)
    # scipy's Rotation takes xyzw
    slerp = Slerp(times, Rotation.from_quat(np.concatenate([q_wc[:, 1:4], q_wc[:, :1]], 1)))
    g_w = np.array([0.0, 0.0, -GRAVITY])
    dt = 1.0 / imu_hz
    ts = np.arange(times[0] + dt, times[-1] - 1e-6, dt)
    R_wb = slerp(ts).as_matrix()
    f_b = np.einsum("nji,nj->ni", R_wb, acc_w(ts) - g_w)  # R_bw (a - g)
    h = dt * 0.5
    R0 = slerp(np.clip(ts - h, times[0], times[-1])).as_matrix()
    R1 = slerp(np.clip(ts + h, times[0], times[-1])).as_matrix()
    w_b = Rotation.from_matrix(np.einsum("nji,njk->nik", R0, R1)).as_rotvec() / (2 * h)
    if noise_a:
        f_b = f_b + rng.normal(0, noise_a, f_b.shape)
    if noise_g:
        w_b = w_b + rng.normal(0, noise_g, w_b.shape)
    return np.concatenate([ts[:, None], f_b, w_b], axis=1)


# ---------------------------------------------------------------- the world
def make_hall_world(seed: int, p_wc: np.ndarray, n_points: int = 12000, margin: float = 3.0):
    """Landmarks filling the hall volume swept by the trajectory, and on the
    walls of its bounding box."""
    from .synthetic import World

    rng = np.random.default_rng(seed)
    lo = p_wc.min(0) - margin
    hi = p_wc.max(0) + margin
    n_vol = n_points // 3
    pts_vol = rng.random((n_vol, 3)) * (hi - lo) + lo
    n_face = (n_points - n_vol) // 6
    faces = []
    for axis in range(3):
        for side in (0, 1):
            f = rng.random((n_face, 3)) * (hi - lo) + lo
            f[:, axis] = hi[axis] if side else lo[axis]
            faces.append(f)
    pts = np.concatenate([pts_vol] + faces, 0)
    desc = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    patches = rng.random((len(pts), 21, 21)).astype(np.float32) * 200.0 + 30.0
    priority = rng.random(len(pts)).astype(np.float32)
    return World(points=pts.astype(np.float32), desc=desc, patches=patches, priority=priority)


@dataclasses.dataclass
class RoomScene:
    """An axis-aligned textured box around the trajectory: exactly
    renderable and view-consistent, so the FAST/rBRIEF front end re-finds
    the same corners from any pose inside it."""

    lo: np.ndarray            # (3,) box min corner
    hi: np.ndarray            # (3,) box max corner
    textures: list            # 6 textures, order: -x +x -y +y -z +z
    scale: float              # texels per meter


def make_room_scene(seed: int, p_wc: np.ndarray, margin: float = 3.0,
                    tex_size: int = 2048, span: float = 24.0) -> RoomScene:
    rng = np.random.default_rng(seed)

    def multiscale():
        img = np.zeros((tex_size, tex_size), np.float32)
        amp = 1.0
        for cell in (4, 8, 16, 32):
            g = rng.random((tex_size // cell, tex_size // cell)).astype(np.float32)
            img += amp * np.kron(g, np.ones((cell, cell), np.float32))
            amp *= 0.6
        img -= img.min()
        return img / img.max() * 215.0 + 20.0

    return RoomScene(lo=(p_wc.min(0) - margin).astype(np.float64),
                     hi=(p_wc.max(0) + margin).astype(np.float64),
                     textures=[multiscale() for _ in range(6)], scale=tex_size / span)


def render_room(scene: RoomScene, cam, R_cw: np.ndarray, t_cw: np.ndarray,
                return_depth: bool = False):
    """Exact per-pixel ray against the room box (nearest positive face hit,
    nearest-texel sampling). With return_depth, also the exact per-pixel
    z-depth in the camera frame (the ideal RGB-D sensor). A KB8 camera's
    rays come from its exact inverse (`synthetic.fisheye_rays`); a pixel
    90 degrees or more from its axis is the 40-grey background."""
    from ..ops.cameras import PINHOLE

    h, w = cam.height, cam.width
    seen = True  # every pixel of a pinhole camera sees the room
    if cam.kind == PINHOLE:
        u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        rays_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], -1)
    else:
        from .synthetic import fisheye_rays

        rays_c, seen = fisheye_rays(cam)
    R_wc = R_cw.T.astype(np.float64)
    c = -R_wc @ t_cw.astype(np.float64)
    rays = rays_c @ R_wc.T                                  # (h,w,3)

    best_lam = np.full((h, w), np.inf)
    img = np.full((h, w), 40.0, np.float32)
    face = 0
    # a ray parallel to a face (a zero component: a pixel on an integer
    # principal point's row or column) gives inf and NaN there, which `hit` masks
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in range(3):
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            for plane in (scene.lo[axis], scene.hi[axis]):
                denom = rays[..., axis]
                lam = np.where(np.abs(denom) > 1e-9, (plane - c[axis]) / denom, np.inf)
                X_u = c[u_ax] + lam * rays[..., u_ax]
                X_v = c[v_ax] + lam * rays[..., v_ax]
                hit = ((lam > 1e-6) & (lam < best_lam) & seen
                       & (X_u >= scene.lo[u_ax]) & (X_u <= scene.hi[u_ax])
                       & (X_v >= scene.lo[v_ax]) & (X_v <= scene.hi[v_ax]))
                tex = scene.textures[face]
                ti = np.clip(((X_v - scene.lo[v_ax]) * scene.scale).astype(np.int64), 0,
                             tex.shape[0] - 1)
                tj = np.clip(((X_u - scene.lo[u_ax]) * scene.scale).astype(np.int64), 0,
                             tex.shape[1] - 1)
                img = np.where(hit, tex[ti, tj], img)
                best_lam = np.where(hit, lam, best_lam)
                face += 1
    if return_depth:
        depth = np.where(np.isfinite(best_lam), best_lam, 0.0)
        return img.astype(np.float32), depth.astype(np.float32)
    return img.astype(np.float32)


# ----------------------------------------------------------------- scoring
def gt_as_tum(times, R_cw, t_cw):
    """Ground truth as (timestamp, T_cw 4x4) pairs, the form
    `utils.evaluation` takes."""
    out = []
    for i in range(len(times)):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_cw[i]
        T[:3, 3] = t_cw[i]
        out.append((float(times[i]), T))
    return out
