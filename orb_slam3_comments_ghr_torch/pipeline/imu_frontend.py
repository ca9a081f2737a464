"""IMU bookkeeping for the tracking front end.

Port of `orb_slam3_comments_ghr_tpu/pipeline/imu_frontend.py`: the sample
queue (Tracking::GrabImuData, Tracking.cc:1762), the dual preintegration,
from the last keyframe and from the last frame (PreintegrateIMU,
Tracking.cc:1771), and the reset at keyframe creation (CreateNewKeyFrame,
Tracking.cc:3935). The queue stays a host list of numpy rows; each chunk is
turned into its (acc, gyr, dt) rows on the host, as the JAX package does
(float64 timestamps, clamped and differenced, then float32), and
preintegrated on the front end's device. The JAX package pads each chunk to
a power of two for its jit cache; here only the live rows go up.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..optim import imu as imu_mod
from ..utils.device import resolve_device


class ImuFrontend:
    def __init__(self, calib: imu_mod.ImuCalib, device=None):
        self.calib = calib
        self.device = resolve_device(device)
        self.queue: list[np.ndarray] = []  # rows [t, ax, ay, az, wx, wy, wz]
        self.bias = np.zeros(6, np.float32)
        # raw samples since the last keyframe (for the full reintegration at
        # keyframe creation and the merge when a keyframe is culled)
        self._since_kf: list[np.ndarray] = []
        self.last_frame_time: Optional[float] = None
        # the incremental from-KF accumulator (mpImuPreintegratedFromLastKF):
        # each frame's chunk is integrated on top of it
        self._pre_kf: Optional[imu_mod.Preintegrated] = None
        self._pre_kf_bias: Optional[np.ndarray] = None

    def feed(self, samples: np.ndarray):
        """samples: (M, 7) [t, ax, ay, az, wx, wy, wz]."""
        for row in np.atleast_2d(np.asarray(samples, np.float64)):
            self.queue.append(row)

    def _take_until(self, t: float) -> list[np.ndarray]:
        n = 0
        while n < len(self.queue) and self.queue[n][0] <= t:
            n += 1
        out, self.queue = self.queue[:n], self.queue[n:]
        return out

    def preintegrate_frame(self, t_frame: float) -> Optional[imu_mod.Preintegrated]:
        """Consume the samples up to t_frame; returns the preintegration from
        the last frame (None on the first call). The same chunk is folded
        into the from-KF accumulator (dual preintegration, Tracking.cc:1883)."""
        rows = self._take_until(t_frame)
        self._since_kf.extend(rows)
        if self.last_frame_time is None:
            self.last_frame_time = t_frame
            return None
        acc, gyr, dts = self._chunk(rows, self.last_frame_time, t_frame)
        pre = imu_mod.preintegrate(acc, gyr, dts, self._bias_tensor(), self.calib)
        if self._pre_kf_bias is not None and np.array_equal(self._pre_kf_bias, self.bias):
            if self._pre_kf is None:
                # first chunk after on_new_keyframe: the keyframe was made at
                # the previous frame time, so this chunk is the from-KF
                # preintegration
                self._pre_kf = pre
            else:
                self._pre_kf = imu_mod.preintegrate_continue(self._pre_kf, acc, gyr, dts,
                                                             self.calib)
        else:
            self._pre_kf = None  # bias changed: rebuilt from the raw rows when asked
        self.last_frame_time = t_frame
        return pre

    def preintegrate_since_kf(self, t_kf_prev: float, t_frame: float, with_raw: bool = False):
        """Preintegration over [t_kf_prev, t_frame]: the incremental
        accumulator, or with_raw=True (keyframe creation) a reintegration
        from the stored rows, so the result carries every sample since the
        keyframe for a later merge."""
        at_frame = (self.last_frame_time is not None
                    and abs(self.last_frame_time - t_frame) < 1e-9)
        if (not with_raw and self._pre_kf is not None
                and np.array_equal(self._pre_kf_bias, self.bias) and at_frame):
            return self._pre_kf
        full = self._integrate(self._since_kf, t_kf_prev, t_frame)
        if at_frame:
            self._pre_kf = full
            self._pre_kf_bias = np.asarray(self.bias).copy()
        return full

    def on_new_keyframe(self, t_kf: float | None = None):
        """Reset the from-KF accumulator at keyframe creation. Rows newer
        than t_kf (a caller whose keyframe lags the IMU head) are kept and
        the accumulator is rebuilt over (t_kf, head]."""
        if (t_kf is None or self.last_frame_time is None
                or self.last_frame_time <= t_kf + 1e-12):
            self._since_kf = []
            self._pre_kf = None
            self._pre_kf_bias = np.asarray(self.bias).copy()
            return
        self._since_kf = [r for r in self._since_kf if r[0] > t_kf]
        self._pre_kf_bias = np.asarray(self.bias).copy()
        self._pre_kf = self._integrate(self._since_kf, t_kf, self.last_frame_time)

    def _bias_tensor(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.bias, np.float32), device=self.device)

    def _chunk(self, rows, t0: float, t1: float):
        """(acc, gyr, dts) tensors of the live samples over [t0, t1], with
        the last sample held to t1 (the JAX package's rows without their
        padding)."""
        acc, gyr, dts = [], [], []
        prev_t = t0
        for row in rows:
            t = min(max(row[0], t0), t1)
            dt = t - prev_t
            if dt <= 0:
                continue
            acc.append(row[1:4])
            gyr.append(row[4:7])
            dts.append(dt)
            prev_t = t
        # tail: hold the last sample to the frame time
        if acc and prev_t < t1:
            acc.append(acc[-1])
            gyr.append(gyr[-1])
            dts.append(t1 - prev_t)
        n = len(dts)
        packed = np.zeros((n, 7), np.float32)
        if n:
            packed[:, 0:3] = np.asarray(acc)
            packed[:, 3:6] = np.asarray(gyr)
            packed[:, 6] = np.asarray(dts)
        p = torch.as_tensor(packed, device=self.device)
        return p[:, 0:3], p[:, 3:6], p[:, 6]

    def _integrate(self, rows, t0: float, t1: float) -> imu_mod.Preintegrated:
        acc, gyr, dts = self._chunk(rows, t0, t1)
        return imu_mod.preintegrate(acc, gyr, dts, self._bias_tensor(), self.calib)
