"""The traffic generator: a stand-in EuRoC motion, a textured room around it
rendered on the card, and the IMU samples of the motion, all from the seed.

Frozen copies of the program's generator (its `utils/gt_replay.py`:
`make_room_scene`, `render_room`, `synthesize_imu`), so that a later change
to the program cannot move the yardstick. The renderer is a PyTorch port of
`render_room` (pinhole only) that runs in float64 wherever its tensors lie;
on the CPU its pixels equal the NumPy original's (slambench/tests).

A traffic file (`slambench/traffic/<name>.json`) names a motion in TUM
format (`t x y z qx qy qz qw` of T_WC) and how to replay it; see
`load_traffic`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
GRAVITY = 9.81
RENDER_BATCH = 32


@dataclasses.dataclass
class Motion:
    times: np.ndarray   # (N,) seconds
    R_cw: np.ndarray    # (N,3,3) float64
    t_cw: np.ndarray    # (N,3)
    p_wc: np.ndarray    # (N,3)
    q_wc: np.ndarray    # (N,4) wxyz


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(N,4) wxyz -> (N,3,3)."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def load_motion(path: Path) -> Motion:
    rows = np.loadtxt(path, comments="#", ndmin=2)
    p = rows[:, 1:4].astype(np.float64)
    q = np.concatenate([rows[:, 7:8], rows[:, 4:7]], axis=1)  # xyzw -> wxyz
    R_cw = np.transpose(quat_to_mat(q), (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, p)
    return Motion(rows[:, 0].astype(np.float64), R_cw, t_cw, p, q)


def load_traffic(name: str) -> dict:
    """The traffic file `traffic/<name>.json`: `motion` (a file under
    traffic/), `start_frame`, `warmup_frames` (fed during set-up, then more
    until a frame returns a pose, `warmup_max` frames in all), `fps_cap`
    (frames rendered per window second), `scene` (`margin`, `tex_size`,
    `span` of the room box), `scene_seed` (the room's textures drawn from
    it, not from the run's seed, where given), `pixel_noise` (the sigma of
    Gaussian sensor noise added to each pixel, drawn from the run's seed)
    and `samples` (how many
    window-match launches, frame-program calls, local BAs and
    preintegrations the output check draws from the window)."""
    spec = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    spec["motion_path"] = HERE / "traffic" / spec["motion"]
    return spec


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
    slerp = Slerp(times, Rotation.from_quat(np.concatenate([q_wc[:, 1:4], q_wc[:, :1]], 1)))
    g_w = np.array([0.0, 0.0, -GRAVITY])
    dt = 1.0 / imu_hz
    ts = np.arange(times[0] + dt, times[-1] - 1e-6, dt)
    R_wb = slerp(ts).as_matrix()
    f_b = np.einsum("nji,nj->ni", R_wb, acc_w(ts) - g_w)
    h = dt * 0.5
    R0 = slerp(np.clip(ts - h, times[0], times[-1])).as_matrix()
    R1 = slerp(np.clip(ts + h, times[0], times[-1])).as_matrix()
    w_b = Rotation.from_matrix(np.einsum("nji,njk->nik", R0, R1)).as_rotvec() / (2 * h)
    if noise_a:
        f_b = f_b + rng.normal(0, noise_a, f_b.shape)
    if noise_g:
        w_b = w_b + rng.normal(0, noise_g, w_b.shape)
    return np.concatenate([ts[:, None], f_b, w_b], axis=1)


# ---------------------------------------------------------------- the room
@dataclasses.dataclass
class RoomScene:
    lo: np.ndarray        # (3,) box min corner
    hi: np.ndarray        # (3,) box max corner
    textures: list        # 6 (T,T) float32 textures: -x +x -y +y -z +z
    scale: float          # texels per metre


def make_room_scene(seed: int, p_wc: np.ndarray, margin: float = 3.0,
                    tex_size: int = 2048, span: float = 24.0) -> RoomScene:
    """An axis-aligned box `margin` around the positions, each face a
    multi-scale random texture drawn from `seed`."""
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


def render_room_torch(scene: RoomScene, textures: torch.Tensor, cam: dict,
                      R_cw: torch.Tensor, t_cw: torch.Tensor) -> torch.Tensor:
    """`render_room` for a batch of poses: R_cw (B,3,3), t_cw (B,3) float64
    on the device of `textures` (6,T,T). Exact per-pixel rays of a pinhole
    camera (`cam`: fx, fy, cx, cy, width, height) against the box, nearest
    positive face hit, nearest-texel sampling. Returns (B,H,W) float32."""
    dev, f64 = textures.device, torch.float64
    h, w = int(cam["height"]), int(cam["width"])
    v, u = torch.meshgrid(torch.arange(h, dtype=f64, device=dev),
                          torch.arange(w, dtype=f64, device=dev), indexing="ij")
    rays_c = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                          torch.ones_like(u)], -1)                      # (H,W,3)
    R_wc = R_cw.transpose(1, 2)
    c = -(R_wc @ t_cw[:, :, None])[:, :, 0]                             # (B,3)
    rays = torch.einsum("hwj,bij->bhwi", rays_c, R_wc)                  # (B,H,W,3)
    lo = torch.as_tensor(scene.lo, dtype=f64, device=dev)
    hi = torch.as_tensor(scene.hi, dtype=f64, device=dev)
    B = R_cw.shape[0]
    best = torch.full((B, h, w), float("inf"), dtype=f64, device=dev)
    img = torch.full((B, h, w), 40.0, dtype=torch.float32, device=dev)
    T = textures.shape[1]
    face = 0
    for axis in range(3):
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        for plane in (lo[axis], hi[axis]):
            denom = rays[..., axis]
            ok = denom.abs() > 1e-9
            lam = torch.where(ok, (plane - c[:, axis, None, None]) / torch.where(ok, denom, 1.0),
                              float("inf"))
            X_u = c[:, u_ax, None, None] + lam * rays[..., u_ax]
            X_v = c[:, v_ax, None, None] + lam * rays[..., v_ax]
            hit = ((lam > 1e-6) & (lam < best) & (X_u >= lo[u_ax]) & (X_u <= hi[u_ax])
                   & (X_v >= lo[v_ax]) & (X_v <= hi[v_ax]))
            ti = torch.nan_to_num((X_v - lo[v_ax]) * scene.scale, nan=0.0, posinf=0.0,
                                  neginf=0.0).to(torch.int64).clamp(0, T - 1)
            tj = torch.nan_to_num((X_u - lo[u_ax]) * scene.scale, nan=0.0, posinf=0.0,
                                  neginf=0.0).to(torch.int64).clamp(0, T - 1)
            img = torch.where(hit, textures[face][ti, tj], img)
            best = torch.where(hit, lam, best)
            face += 1
    return img


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


@dataclasses.dataclass
class Frames:
    """What the replay feeds, frame by frame: host uint8 images (one or two
    views), timestamps, IMU rows since the previous frame (or None), and
    the ground-truth T_cw of each frame (float64)."""

    left: list
    right: list | None
    times: np.ndarray
    imu: list | None
    T_cw: np.ndarray   # (n,4,4)


def build_frames(spec: dict, cam: dict, seed: int, n_frames: int, stereo: bool,
                 imu: dict | None, device: torch.device) -> Frames:
    """Render `n_frames` frames of the traffic's motion from `start_frame`
    in batches on `device`, with the traffic's sensor noise, kept as host
    uint8. The right view sits the
    baseline bf/fx along the left camera's x axis. With `imu` (`rate_hz`,
    per-sample sigmas `noise_g`, `noise_a`), the samples of the motion with
    noise drawn from the seed, cut per frame."""
    mo = load_motion(spec["motion_path"])
    i0 = int(spec["start_frame"])
    if i0 + n_frames > len(mo.times):
        raise ValueError(f"traffic {spec['motion']} has {len(mo.times) - i0} frames from "
                         f"frame {i0}, {n_frames} asked")
    sl = slice(i0, i0 + n_frames)
    scene = make_room_scene(spec.get("scene_seed", seed), mo.p_wc, **spec.get("scene", {}))
    sigma = float(spec.get("pixel_noise", 0.0))
    noise = torch.Generator(device=device).manual_seed(seed)
    tex = torch.from_numpy(np.stack(scene.textures)).to(device)
    R = torch.from_numpy(mo.R_cw[sl]).to(device)
    t = torch.from_numpy(mo.t_cw[sl]).to(device)
    b = torch.tensor([cam["bf"] / cam["fx"], 0.0, 0.0], dtype=torch.float64, device=device)
    def shot(R_b, t_b):
        img = render_room_torch(scene, tex, cam, R_b, t_b)
        if sigma:
            img = img + sigma * torch.randn(img.shape, generator=noise, device=device)
        return to_uint8(img).cpu().numpy()

    left, right = [], ([] if stereo else None)
    for s in range(0, n_frames, RENDER_BATCH):
        e = min(s + RENDER_BATCH, n_frames)
        left.extend(shot(R[s:e], t[s:e]))
        if stereo:
            right.extend(shot(R[s:e], t[s:e] - b))
    del tex
    times = mo.times[sl]
    rows = None
    if imu is not None:
        samples = synthesize_imu(mo.times, mo.p_wc, mo.q_wc, imu_hz=imu["rate_hz"],
                                 noise_g=imu["noise_g"], noise_a=imu["noise_a"], seed=seed)
        edges = np.concatenate([[times[0] - 1.0 / imu["rate_hz"] * 0.5 - 0.05], times])
        cut = np.searchsorted(samples[:, 0], edges, side="right")
        rows = [samples[cut[k]:cut[k + 1]] for k in range(n_frames)]
    T = np.tile(np.eye(4), (n_frames, 1, 1))
    T[:, :3, :3] = mo.R_cw[sl]
    T[:, :3, 3] = mo.t_cw[sl]
    return Frames(left, right, times, rows, T)
