"""Dataset loaders: EuRoC MAV and TUM RGB-D directory layouts.

Replaces the reference's ROS-node drivers (Examples/ROS/ORB_SLAM3/src/*.cc)
with plain CLI-friendly iterators; the image/IMU pairing logic mirrors
ImageGrabber::SyncWithImu (ros_stereo_inertial.cc:49-70): each frame carries
the IMU samples with timestamps in (t_prev, t_frame].

Copied from `orb_slam3_comments_ghr_tpu/io/datasets.py` (numpy only; PIL is
imported only to decode an image file that is not .npy), so the port needs
no JAX. Frames come back as host numpy arrays; `SLAM` uploads them.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 (H, W). PNG/JPG via PIL; PGM/NPY natively."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"))
    return img.astype(np.float32)


@dataclass
class Frame:
    timestamp: float
    img: np.ndarray
    img_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    imu: Optional[np.ndarray] = None  # (M,7) [t, ax, ay, az, wx, wy, wz]


class EurocDataset:
    """EuRoC MAV layout: <root>/mav0/cam0/data.csv + data/, cam1/, imu0/.

    data.csv rows: timestamp_ns, filename. imu0 rows: t_ns, wx,wy,wz,
    ax,ay,az (gyro first in EuRoC!)."""

    def __init__(self, root: str, stereo: bool = False, imu: bool = False):
        self.root = root
        self.stereo = stereo
        self.use_imu = imu
        self.cam0 = self._read_cam_csv(os.path.join(root, "mav0", "cam0"))
        self.cam1 = (
            self._read_cam_csv(os.path.join(root, "mav0", "cam1")) if stereo else []
        )
        self.imu = (
            self._read_imu_csv(os.path.join(root, "mav0", "imu0", "data.csv"))
            if imu
            else np.zeros((0, 7))
        )

    @staticmethod
    def _read_cam_csv(cam_dir: str):
        rows = []
        with open(os.path.join(cam_dir, "data.csv")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split(",")[:2]
                rows.append((int(ts) * 1e-9, os.path.join(cam_dir, "data", name.strip())))
        return rows

    @staticmethod
    def _read_imu_csv(path: str) -> np.ndarray:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.split(",")]
                t = v[0] * 1e-9
                wx, wy, wz, ax, ay, az = v[1:7]
                out.append([t, ax, ay, az, wx, wy, wz])
        return np.asarray(out)

    def __len__(self):
        return len(self.cam0)

    def __iter__(self) -> Iterator[Frame]:
        # decode + prefetch on native worker threads (native/slamio.cpp ring
        # buffer) so image IO overlaps tracking — the reference gets this for
        # free from its ROS message queues (ros_stereo_inertial.cc:49-70);
        # falls back to the Python decoder when the .so can't be built
        from .native_loader import PrefetchLoader

        left = PrefetchLoader([p for _, p in self.cam0])
        right = (
            PrefetchLoader([p for _, p in self.cam1][: len(self.cam0)])
            if self.stereo and self.cam1 else None
        )
        try:
            prev_t = -np.inf
            for i, (t, _path) in enumerate(self.cam0):
                img = left.next()
                img_r = None
                if right is not None and i < len(self.cam1):
                    img_r = right.next()
                chunk = None
                if self.use_imu and len(self.imu):
                    sel = (self.imu[:, 0] > prev_t) & (self.imu[:, 0] <= t)
                    chunk = self.imu[sel]
                prev_t = t
                yield Frame(timestamp=t, img=img, img_right=img_r, imu=chunk)
        finally:
            left.close()
            if right is not None:
                right.close()


class TumRgbdDataset:
    """TUM RGB-D layout: rgb.txt / depth.txt with `t filename` rows;
    association by nearest timestamp (associate.py, 0.02 s tolerance)."""

    def __init__(self, root: str, depth_factor: float = 5000.0, max_dt: float = 0.02):
        self.root = root
        self.depth_factor = depth_factor
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        depth = self._read_list(os.path.join(root, "depth.txt"))
        t_d = np.array([t for t, _ in depth])
        self.pairs = []
        used = set()
        for t, p in rgb:
            if not len(t_d):
                break
            j = int(np.argmin(np.abs(t_d - t)))
            if abs(t_d[j] - t) <= max_dt and j not in used:
                self.pairs.append((t, p, depth[j][1]))
                used.add(j)

    @staticmethod
    def _read_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, name = line.split()[:2]
                out.append((float(t), os.path.join(os.path.dirname(path), name)))
        return out

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[Frame]:
        for t, rgb_path, depth_path in self.pairs:
            img = load_image(rgb_path)
            if depth_path.endswith(".npy"):
                d = np.load(depth_path).astype(np.float32)
            else:
                from PIL import Image

                d = np.asarray(Image.open(depth_path)).astype(np.float32)
                d = d / self.depth_factor
            yield Frame(timestamp=t, img=img, depth=d)


def write_synthetic_euroc(root: str, images, timestamps, imu_rows=None,
                          images_right=None):
    """Write a synthetic sequence in EuRoC layout (npy images) — the test/
    bench fixture for the loaders."""
    for cam, imgs in (("cam0", images), ("cam1", images_right or [])):
        if not imgs:
            continue
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            for t, img in zip(timestamps, imgs):
                name = f"{int(t*1e9)}.npy"
                np.save(os.path.join(d, name), np.asarray(img))
                f.write(f"{int(t*1e9)},{name}\n")
    if imu_rows is not None:
        d = os.path.join(root, "mav0", "imu0")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "data.csv"), "w") as f:
            for row in imu_rows:
                t, ax, ay, az, wx, wy, wz = row
                f.write(f"{int(t*1e9)},{wx},{wy},{wz},{ax},{ay},{az}\n")
