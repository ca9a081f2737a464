"""Host tracking state machine.

Port of `orb_slam3_comments_ghr_tpu/pipeline/tracker.py`: the OK /
RECENTLY_LOST / LOST ladder
(Tracking.h:133-142, Tracking.cc:2009 Track()), two-view initialization
(monocular) or depth-seeded initialization (stereo and RGB-D), keyframe
decision, the reference-keyframe fallback and relocalization; with an IMU,
the per-frame preintegration, the IMU-predicted pose, the visual-inertial
pose refinement and dead reckoning while recently lost. The map stays host
numpy; extraction, matching, pose LM, preintegration, two-view RANSAC, PnP
and BA run on the tracker's device: the card unless the caller passes
`device="cpu"`. A tracked frame comes back to the host in one packed copy.

For the deep pipeline (`SLAM.track_*_pipelined`) `prepare_frame(steps=)`
predicts `steps` frames ahead of the bookkeeping, the frame context is
captured and restored around it, and `track` takes the frame's result and
features already on the host. With asynchronous mapping `queue_probe`
gives the mapper's queue length (KeyframesInQueue), which the keyframe
decision reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..frontend.types import Features
from ..map.state import MapState
from ..ops import cameras, matching
from ..optim import ba, imu as imu_mod, inertial, pnp, pose_opt, twoview
from ..utils.config import IMU_MONOCULAR, SlamConfig
from ..utils.device import resolve_device
from ..utils.profiling import GLOBAL_TIMER
from . import programs
from .imu_frontend import ImuFrontend

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4

STATE_NAMES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "OK",
               3: "RECENTLY_LOST", 4: "LOST"}

_FEATURE_FIELDS = ("xy", "level", "angle", "desc", "valid", "u_right", "depth")


def _np_feats(feats: Features) -> dict:
    """The features the map keeps, as numpy, in one device->host copy: every
    field is viewed as int32 words, concatenated, copied, and split."""
    f32, i32 = torch.float32, torch.int32
    cols = [getattr(feats, k) for k in _FEATURE_FIELDS]
    cols = [c.view(i32) if c.dtype == f32 else c.to(i32) for c in cols]
    n = feats.xy.shape[0]
    flat = torch.cat([c.reshape(n, -1) for c in cols], dim=1).cpu().numpy()
    out, at = {}, 0
    for k, c, src in zip(_FEATURE_FIELDS, cols, (getattr(feats, k) for k in _FEATURE_FIELDS)):
        w = c.reshape(n, -1).shape[1]
        a = flat[:, at:at + w].reshape(c.shape)
        at += w
        if src.dtype == f32:
            a = a.view(np.float32)
        elif k == "desc":
            a = a.view(np.uint32)
        elif src.dtype == torch.bool:
            a = a.astype(bool)
        out[k] = np.ascontiguousarray(a)
    return out


def _fetch_track(res: programs.TrackResult, close=None):
    """A device TrackResult as numpy, in one device->host copy (every value
    fits float32 exactly: indices < 2^24). `close` (stereo / RGB-D: which
    features have a close depth, (N,) bool) rides in the same copy. Returns
    (TrackResult, close as numpy or None). A result already on the host
    (the deep pipeline's) comes with its `close` on the host too."""
    if isinstance(res.R, np.ndarray):
        return _host_track(res), close
    L = res.match_feat.shape[0]
    f32 = torch.float32
    extra = [] if close is None else [close.to(f32)]
    with GLOBAL_TIMER.stage("fetch"):
        flat = torch.cat([
            res.R.reshape(9), res.t, res.n_inliers.reshape(1).to(f32),
            res.match_feat.to(f32), res.inlier.to(f32), res.visible.to(f32), *extra,
        ]).cpu().numpy()
    end = 13 + 3 * L
    return programs.TrackResult(
        R=flat[:9].reshape(3, 3), t=flat[9:12], n_inliers=int(flat[12]),
        match_feat=flat[13:13 + L].astype(np.int32),
        inlier=flat[13 + L:13 + 2 * L] > 0.5,
        visible=flat[13 + 2 * L:end] > 0.5,
    ), (None if close is None else flat[end:] > 0.5)


def host_features(feats: Features) -> dict:
    """The fields the map keeps of a Features tuple of numpy arrays (as
    `utils.fetch` brings them home), in `_np_feats`' form."""
    out = {k: np.ascontiguousarray(getattr(feats, k)) for k in _FEATURE_FIELDS}
    out["desc"] = out["desc"].view(np.uint32)
    out["valid"] = out["valid"].astype(bool)
    return out


def _host_track(res: programs.TrackResult) -> programs.TrackResult:
    """A TrackResult of numpy arrays in `_fetch_track`'s form."""
    return programs.TrackResult(
        R=np.asarray(res.R, np.float32), t=np.asarray(res.t, np.float32),
        n_inliers=int(res.n_inliers), match_feat=np.asarray(res.match_feat, np.int32),
        inlier=np.asarray(res.inlier, bool), visible=np.asarray(res.visible, bool))


def _seed(generator: torch.Generator, rng: np.random.Generator) -> torch.Generator:
    """Seed the generator from two draws of the numpy stream, the draws the
    JAX tracker turns into a PRNG key (tracker.py:358, :914)."""
    hi, lo = rng.integers(0, 2**31, 2)
    return generator.manual_seed(int(hi) << 31 | int(lo))


@dataclasses.dataclass
class FrameRecord:
    """Per-frame trajectory entry (mlRelativeFramePoses, Tracking.h:164-169):
    the pose relative to its reference KF, so later KF optimization improves
    the exported trajectory."""

    timestamp: float
    ref_kf: int
    T_cr: np.ndarray   # 4x4, cam-in-refKF
    lost: bool


class Tracker:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb=None, imu: Optional[ImuFrontend] = None, device=None):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb  # retrieval.database.KeyFrameDatabase (optional)
        self.imu = imu
        self.kf_preint: dict[int, imu_mod.Preintegrated] = {}  # kf -> from its previous KF
        self.last_kf_time: float = 0.0
        self.body_vel = np.zeros(3, np.float32)  # body velocity in world
        self._pre_frame: Optional[imu_mod.Preintegrated] = None  # from the last frame
        self._pose_inertial = inertial.PoseInertialGraph()  # the VI refinement
        self._pose_lm = pose_opt.PoseLMGraph()  # the frame program's pose LM
        self._last_prediction = None  # (R, t) predicted for the current frame
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.state = NO_IMAGES_YET
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, np.float32)
        self.velocity: Optional[np.ndarray] = None  # 4x4 Tcl (const-velocity)
        self.last_kf: int = -1
        self.frames_since_kf = 0
        self.frame_id = -1
        self.last_time = 0.0
        self.lost_since: float = 0.0
        self.last_feats = None  # the latest frame's features (for viewers)
        # mono init buffers
        self._init_feats = None
        self._init_time = None
        self.records: list[FrameRecord] = []
        self.pending_kf: Optional[int] = None  # set when a KF was created
        self.localization_only = False  # ActivateLocalizationMode (System.h:123)
        self._rng = np.random.default_rng(0)
        self.last_reloc_frame = -(10 ** 9)  # mnLastRelocFrameId
        self._prepared_th = 1.0  # search-window multiplier of the prepared frame
        self._prepared_ts = None
        self._prepared = None  # (lp, ids, R0, t0) of the prepared frame
        self._precomputed = None
        self._host = None  # the current frame's features on the host, when given
        self._lp_cache = None  # (key, lp, ids) of the last local-point view
        self._view_version = 0  # the map version of the last view taken
        # the mapping worker, when mapping runs on one (set by the system):
        # its queue's length (KeyframesInQueue, Tracking.cc:3904), whether
        # it is mapping a keyframe (!AcceptKeyFrames) and InterruptBA
        self.queue_probe = None
        self.mapper_busy = None
        self.interrupt_ba = None
        self.n_lost_resets = 0   # young or uninitialized maps reset when lost
        self.n_submap_spawns = 0  # new sub-maps opened when lost

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _upload_packed(self, *arrays) -> list[torch.Tensor]:
        """float32 arrays onto the device in one host->device copy, as
        tensors of their shapes."""
        arrays = [np.asarray(a, np.float32) for a in arrays]
        flat = self._tensor(np.concatenate([a.reshape(-1) for a in arrays]))
        out, at = [], 0
        for a in arrays:
            out.append(flat[at:at + a.size].reshape(a.shape))
            at += a.size
        return out

    # ---------------------------------------------------------------- public
    def prepare_frame(self, timestamp: float, steps: int = 1):
        """What the fused per-frame program needs: timestamp fault handling,
        pose prediction and the local point view. Returns (ready, lp, ids,
        R0, t0); ready=False means init / relocalization / wide search.
        `steps` is the horizon of the constant-velocity prediction: the deep
        pipeline prepares frame N while the bookkeeping has reached frame
        N - steps."""
        with GLOBAL_TIMER.stage("pose_prediction"):
            self._run_frame_prologue(timestamp)
            self._prepared_ts = timestamp
            if self.state != OK or self.last_kf < 0:
                return False, None, None, None, None
            R0, t0 = self._predict_pose(steps=steps)
            self._last_prediction = (R0.copy(), t0.copy())
            lp, ids = self._local_points_view()
            self._prepared = (lp, ids, R0, t0, self._view_version)
            self._prepared_th = self._search_th()
            return True, lp, ids, self._tensor(R0), self._tensor(t0)

    def _search_th(self) -> float:
        """Projection search-window multiplier: with no motion model yet
        (first frame after init / reloc) the prediction is a whole frame
        stale, so the single fused pass widens its window
        (the reference's TrackReferenceKeyFrame, Tracking.cc:2205-2212); the
        IMU prediction's error grows with the bias and velocity error, so
        it searches 4x wider."""
        if self.state != OK:
            return 6.0
        if self._imu_ready():
            return 4.0
        if self.velocity is None:
            return 6.0
        return 1.0

    def capture_frame_context(self):
        """The state prepare_frame leaves for its frame, so that the deep
        pipeline can prepare later frames before this one is tracked;
        restore_frame_context puts it back right before `track`."""
        return self._prepared_ts, self._prepared, self._pre_frame

    def restore_frame_context(self, ctx):
        self._prepared_ts, self._prepared, self._pre_frame = ctx

    def _run_frame_prologue(self, timestamp: float):
        self.pending_kf = None
        self._pre_frame = None
        # input faults (Tracking.cc:2039-2094): non-monotonic timestamps
        # flush the IMU queue and open a fresh sub-map; with an IMU a gap of
        # more than 1 s does the same
        if self.state not in (NO_IMAGES_YET, NOT_INITIALIZED):
            if timestamp < self.last_time:
                if self.imu is not None:
                    self.imu.queue.clear()
                self._handle_lost()
            elif timestamp - self.last_time > 1.0 and self.cfg.is_inertial:
                self._handle_lost()
        if self.imu is not None:
            self._pre_frame = self.imu.preintegrate_frame(timestamp)

    def track(self, feats: Features, timestamp: float, precomputed=None) -> Optional[np.ndarray]:
        """Process one frame's features; returns 4x4 Tcw or None if lost.
        `precomputed` is the (res,) of the fused program run against the
        arrays from prepare_frame; the deep pipeline passes (res, prepared,
        features), the result and the features on the host (`host_features`)
        and the frame's (lp, ids, R0, t0)."""
        self.frame_id += 1
        self.last_feats = feats
        if self._prepared_ts != timestamp:
            self._run_frame_prologue(timestamp)
        self._precomputed = precomputed
        if self.state == NO_IMAGES_YET:
            self.state = NOT_INITIALIZED

        if self.state == NOT_INITIALIZED:
            if self.cfg.is_mono:
                done = self._initialize_mono(feats, timestamp)
            else:
                done = self._initialize_stereo(feats, timestamp)
            if done:
                self.state = OK
            self.last_time = timestamp
            return self._current_pose() if done else None

        if self.state == RECENTLY_LOST and self.kfdb is not None and not self._imu_ready():
            # visual relocalization ladder (Tracking.cc:4444). An
            # IMU-initialized map does not relocalize while recently lost:
            # it dead-reckons on the IMU (Tracking.cc:2256-2294)
            if self._relocalize(feats):
                self.state = OK
                self.last_reloc_frame = self.frame_id
        ok = self._track_frame(feats, timestamp)
        dead_reckon = False
        if ok:
            self.state = OK
            self.lost_since = 0.0
        else:
            if self._imu_ready() and self._last_prediction is not None:
                # keep the IMU prediction, so visual tracking can latch again
                # (Tracking.cc:2256-2272)
                self.last_R, self.last_t = self._last_prediction
                dead_reckon = True
            if self.state == OK:
                self.state = RECENTLY_LOST
                self.lost_since = timestamp
            elif self.state == RECENTLY_LOST:
                if timestamp - self.lost_since > self.cfg.recently_lost_secs:
                    self.state = LOST
            if self.state == LOST:
                self._handle_lost()
        self.last_time = timestamp
        # while recently lost with an IMU, the predicted poses are published
        # (and recorded against the last reference KF) for up to
        # recently_lost_secs (Tracking.cc:2256-2272)
        published = ok or (dead_reckon and self.state == RECENTLY_LOST)
        self._record_frame(timestamp, lost=not published)
        return self._current_pose() if published else None

    # ------------------------------------------------------------- internals
    def _current_pose(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.last_R
        T[:3, 3] = self.last_t
        return T

    def _record_frame(self, timestamp: float, lost: bool):
        ref = self.last_kf
        T_cw = self._current_pose()
        T_rw = np.eye(4, dtype=np.float32)
        if ref >= 0:
            T_rw[:3, :3] = self.map.kf_R[ref]
            T_rw[:3, 3] = self.map.kf_t[ref]
        self.records.append(FrameRecord(timestamp, ref, T_cw @ np.linalg.inv(T_rw), lost))

    def apply_world_transform(self, s: float, R: np.ndarray, t: np.ndarray):
        """Carry the live pose through a map transform world' = s R world + t
        (the IMU initialization's gravity and scale alignment): the camera
        centre moves with the world, Rcw' = Rcw R^T. The motion model and the
        cached prediction belong to the old world and are dropped
        (UpdateFrameIMU, Tracking.cc:4887)."""
        c = -self.last_R.T @ self.last_t
        c2 = (s * (R @ c) + t).astype(np.float32)
        Rcw2 = (self.last_R @ R.T).astype(np.float32)
        self.last_R = Rcw2
        self.last_t = (-Rcw2 @ c2).astype(np.float32)
        self.body_vel = (s * (R @ self.body_vel)).astype(np.float32)
        self.velocity = None
        self._last_prediction = None

    def _register_kf(self, kf: int):
        if self.kfdb is not None:
            m = self.map
            self.kfdb.add(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf])

    def _initialize_stereo(self, feats: Features, timestamp: float) -> bool:
        """StereoInitialization (Tracking.cc:2755): a frame with more than 500
        keypoints seeds the map from its measured depths, every one of them
        (Tracking.cc:2775-2800; the 100-plus-close rule is CreateNewKeyFrame's)."""
        f = _np_feats(feats)
        if int(f["valid"].sum()) <= 500:
            return False
        kf = self.map.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), f,
                                   timestamp)
        self._spawn_depth_points(kf, f, close_rule=False)
        if self.imu is not None:
            self.imu.on_new_keyframe(timestamp)
            self.last_kf_time = timestamp
        self._register_kf(kf)
        self.last_kf = kf
        self.last_R = self.map.kf_R[kf].copy()
        self.last_t = self.map.kf_t[kf].copy()
        self.velocity = None
        self.frames_since_kf = 0
        self.pending_kf = kf
        return True

    def _spawn_depth_points(self, kf: int, f: dict, close_rule: bool = True):
        """Unproject the keyframe's features with measured depth and no map
        point into new map points, closest first (CreateNewKeyFrame, stereo
        path, Tracking.cc:3985-4070): with `close_rule`, stop after 100 once
        the depth passes ThDepth = baseline * depth_th_factor."""
        m = self.map
        th_depth = self.cam.baseline * self.cfg.depth_th_factor
        has_depth = (f["depth"] > 0) & f["valid"] & (m.kf_feat_mp[kf] < 0)
        order = np.argsort(np.where(has_depth, f["depth"], np.inf))
        batch_idx = []
        for fi in order:
            if not has_depth[fi] or (close_rule and len(batch_idx) >= 100
                                     and f["depth"][fi] > th_depth):
                break
            batch_idx.append(fi)
        if not batch_idx:
            return
        batch_idx = np.asarray(batch_idx)
        # on host tensors: the map is numpy, and this is float32 as on a device
        rays = cameras.unproject(self.cam, torch.from_numpy(f["xy"][batch_idx])).numpy()
        pc = rays * f["depth"][batch_idx][:, None]
        R, t = m.kf_R[kf], m.kf_t[kf]
        ids = m.add_map_points(((pc - t) @ R).astype(np.float32), f["desc"][batch_idx], kf,
                               batch_idx)
        m.update_point_geometry(ids[ids >= 0])

    def _initialize_mono(self, feats: Features, timestamp: float) -> bool:
        n_valid = int(feats.valid.sum())
        if self._init_feats is None:
            if n_valid > self.cfg.min_init_matches:
                self._init_feats = feats
                self._init_time = timestamp
            return False
        if n_valid <= self.cfg.min_init_matches:
            self._init_feats = None
            return False

        idx, dist, ok = matching.search_for_initialization(
            self._init_feats, feats, window=100.0, ratio=0.9
        )
        if int(ok.sum()) < self.cfg.min_init_matches:
            # keep the newer frame as the init candidate (ref does the same)
            self._init_feats = feats
            self._init_time = timestamp
            return False

        # a match whose keypoint lies more than an image size outside the
        # (virtual pinhole) image is left out of the reconstruction: a fisheye
        # keypoint near 90 degrees off the axis undistorts to 1e5-5e6 px and
        # would dominate the Hartley normalization (ROADMAP C11); raw pinhole
        # keypoints are always inside
        x1, x2 = self._init_feats.xy, feats.xy[idx.long()]
        span = -float(max(self.cam.width, self.cam.height))
        near = cameras.in_image(self.cam, x1, span) & cameras.in_image(self.cam, x2, span)
        res = twoview.reconstruct(self.cam, x1, x2, ok & near, _seed(self.generator, self._rng))
        if not bool(res.success):
            return False
        self._create_initial_map_mono(self._init_feats, feats, idx, res, self._init_time, timestamp)
        self._init_feats = None
        return True

    def _create_initial_map_mono(self, f1, f2, match_idx, res, t1, t2):
        """CreateInitialMapMonocular (Tracking.cc:3001): two KFs, the
        triangulated points, a 20-iteration BA, then median-depth
        normalization to 1."""
        m = self.map
        f1n, f2n = _np_feats(f1), _np_feats(f2)
        kf1 = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), f1n, t1)
        kf2 = m.add_keyframe(res.R.cpu().numpy(), res.t.cpu().numpy(), f2n, t2,
                             parent=kf1, prev=kf1)
        gi = np.nonzero(res.good.cpu().numpy())[0]
        feat2 = match_idx.cpu().numpy()[gi]
        ids = m.add_map_points(res.points.cpu().numpy()[gi], f1n["desc"][gi], kf1, gi)
        for j, mp in enumerate(ids):
            if mp >= 0:
                m.add_observation(int(mp), kf2, int(feat2[j]))

        self._initial_ba(kf1, kf2)

        # median-depth normalization (Tracking.cc:3076-3085)
        mp_ids = m.mp_ids()
        depths = (m.mp_pos[mp_ids] @ m.kf_R[kf1].T + m.kf_t[kf1])[:, 2]
        med = float(np.median(depths))
        if med < 0:
            med = 1.0
        s = 1.0 / med
        m.mp_pos[mp_ids] *= s
        m.kf_t[kf1] *= s
        m.kf_t[kf2] *= s
        # normals/distance bands must reflect the final (scaled) geometry
        m.update_point_geometry(mp_ids)
        if self.imu is not None:
            self.kf_preint[kf2] = self.imu.preintegrate_since_kf(t1, t2, with_raw=True)
            self.imu.on_new_keyframe(t2)
            self.last_kf_time = t2
        self._register_kf(kf1)
        self._register_kf(kf2)

        self.last_kf = kf2
        self.last_R = m.kf_R[kf2].copy()
        self.last_t = m.kf_t[kf2].copy()
        self.velocity = None
        self.frames_since_kf = 0
        self.pending_kf = kf2

    def _initial_ba(self, kf1: int, kf2: int):
        prob = self._build_two_kf_problem(kf1, kf2)
        Rn, tn, pn, _, _ = ba.bundle_adjust(self.cam, prob, iters=20)
        m = self.map
        m.kf_R[kf2] = Rn[1].cpu().numpy()
        m.kf_t[kf2] = tn[1].cpu().numpy()
        ids = self._last_prob_ids
        m.mp_pos[ids] = pn.cpu().numpy()[: len(ids)]

    def _build_two_kf_problem(self, kf1: int, kf2: int) -> ba.BAProblem:
        m = self.map
        ids = m.mp_ids()
        self._last_prob_ids = ids
        P, D = len(ids), 2
        obs_cam = np.zeros((P, D), np.int32)
        obs_uv = np.zeros((P, D, 2), np.float32)
        obs_level = np.zeros((P, D), np.int32)
        obs_valid = np.zeros((P, D), bool)
        for j, mp in enumerate(ids):
            for s in range(m.cfg.obs_cap):
                kf = m.mp_obs_kf[mp, s]
                if kf < 0:
                    continue
                d = 0 if kf == kf1 else 1
                fi = m.mp_obs_idx[mp, s]
                obs_cam[j, d] = d
                obs_uv[j, d] = m.kf_feat_xy[kf, fi]
                obs_level[j, d] = m.kf_feat_level[kf, fi]
                obs_valid[j, d] = True
        return convert.ba_problem_from_numpy(dict(
            cam_R=np.stack([m.kf_R[kf1], m.kf_R[kf2]]),
            cam_t=np.stack([m.kf_t[kf1], m.kf_t[kf2]]),
            cam_fixed=np.array([True, False]),
            p=m.mp_pos[ids], p_valid=np.ones((P,), bool),
            obs_cam=obs_cam, obs_uv=obs_uv, obs_ur=np.full((P, D), -1.0, np.float32),
            obs_level=obs_level, obs_valid=obs_valid,
        ), device=self.device)

    # ------------------------------------------------------------- main track
    def _local_points_view(self) -> tuple[programs.LocalPoints, np.ndarray]:
        """Candidate map points: those seen by the reference KF's
        covisibility neighbourhood and its 3 temporal predecessors
        (UpdateLocalKeyFrames/Points, Tracking.cc:4250,4206), padded to the
        static cap. The view depends only on (map version, reference KF),
        so frames between keyframes reuse the uploaded tensors. It is taken
        under the map's lock, against a mapping worker's write-backs (torn
        views otherwise); `_view_version` is the map version it was taken
        at, which `_create_new_kf` checks its ids against."""
        m = self.map
        cap = self.cfg.local_points_cap
        with m.lock:
            key = (m.version, self.last_kf, cap)
            self._view_version = m.version
            if self._lp_cache is not None and self._lp_cache[0] == key:
                return self._lp_cache[1], self._lp_cache[2]
            kfs = [self.last_kf] + m.covisible_kfs(self.last_kf, k=10, min_weight=5)
            k = self.last_kf
            for _ in range(3):
                k = m.kf_prev[k] if k >= 0 else -1
                if k >= 0:
                    kfs.append(int(k))
            ids = m.local_point_ids(np.unique(kfs), cap)
            lp = convert.local_points_from_map(m, ids, cap, self.device)
        self._lp_cache = (key, lp, ids)
        return lp, ids

    def _track_again(self, feats):
        """A keyframe is wanted from a frame tracked on a local view that a
        mapping worker has changed since (taken before the frame's features
        were extracted, or, in the deep pipeline, frames earlier): the frame
        is tracked again from its pose against the local map of now, as
        TrackLocalMap searches the local map of the moment (Tracking.cc:3571),
        so that the keyframe decision and the new keyframe's points come
        from the map the worker has built. On a stale view a keyframe made
        right after the worker mapped its predecessor missed the
        predecessor's new points, and with its few points none came after it
        (ROADMAP C16; inline the view is never stale). Returns (res, ids,
        view version), or None when the new tracking holds too few
        inliers."""
        lp, ids = self._local_points_view()
        res, _ = _fetch_track(programs.track_against_points(
            self.cam, feats, lp, self._tensor(self.last_R), self._tensor(self.last_t),
            th=self._search_th(), n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            lm_graph=self._pose_lm))
        if res.n_inliers < self.cfg.min_track_matches:
            return None
        return res, ids, self._view_version

    def _imu_ready(self) -> bool:
        return (self.imu is not None and self.map.map_imu_init.get(self.map.active_map, False)
                and self._pre_frame is not None)

    def _predict_pose(self, steps: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """The pose predicted for the frame `steps` frames after the last
        tracked one: the IMU prediction (whose preintegration already spans
        up to the frame), else `steps` constant-velocity steps, else the
        last pose."""
        if self._imu_ready():
            # dead-reckon the body state from the last frame (PredictStateIMU);
            # the body frame is the camera's here, as in the JAX package
            Rwb = self.last_R.T
            pwb = -Rwb @ self.last_t
            Rwb, pwb, vel, bias = self._upload_packed(Rwb, pwb, self.body_vel, self.imu.bias)
            Rp, pp, vp = imu_mod.predict_state(Rwb, pwb, vel, bias, self._pre_frame)
            flat = torch.cat([Rp.reshape(9), pp, vp]).cpu().numpy()
            Rp, pp = flat[:9].reshape(3, 3), flat[9:12]
            self.body_vel = flat[12:15].copy()
            Rcw = Rp.T
            return Rcw.copy(), (-Rcw @ pp).copy()
        if self.velocity is not None:
            T = self._current_pose()
            for _ in range(max(1, steps)):
                T = self.velocity @ T
            return T[:3, :3].copy(), T[:3, 3].copy()
        return self.last_R.copy(), self.last_t.copy()

    def _track_frame(self, feats: Features, timestamp: float) -> bool:
        cfg = self.cfg
        self._host = None
        if self._precomputed is not None and self.state == OK and len(self._precomputed) > 1:
            self._host = self._precomputed[2]
        close = None if cfg.is_mono else self._close_features(feats)
        # the previous frame's pose, read before the reference-keyframe
        # fallback can overwrite last_R / last_t: the velocities below are
        # taken against it (mVelocity = Tcw_cur * Twc_last, Tracking.cc).
        # The JAX package reads it after the fallback (ROADMAP C9)
        prev_pose = self._current_pose()
        prev_R, prev_t = self.last_R.copy(), self.last_t.copy()
        if self._precomputed is not None and self.state == OK:
            res = self._precomputed[0]
            lp, ids, R0, t0, view_v = (self._precomputed[1] if len(self._precomputed) > 1
                                       else self._prepared)
            self._precomputed = None
        else:
            with GLOBAL_TIMER.stage("pose_prediction"):
                R0, t0 = self._predict_pose()
                self._last_prediction = (R0.copy(), t0.copy())
                lp, ids = self._local_points_view()
                view_v = self._view_version
            res = programs.track_against_points(
                self.cam, feats, lp, self._tensor(R0), self._tensor(t0),
                th=self._search_th(), n_levels=cfg.n_levels, scale=cfg.scale_factor,
                lm_graph=self._pose_lm,
            )
        res, close = _fetch_track(res, close)
        n_inl = res.n_inliers
        if n_inl < cfg.min_track_matches:
            # TrackReferenceKeyFrame fallback (Tracking.cc:3254): BoW-node
            # matching against the reference KF + pose LM, then a wide
            # local-map re-track from the recovered pose. An IMU-initialized
            # map trusts the IMU prediction and never falls back
            # (Tracking.cc:2216-2220): a bad inertial init must fail through
            # to LOST, where the map reset can repair it
            if self._imu_ready():
                return False
            if not self._track_reference_kf(feats):
                return False
            lp, ids = self._local_points_view()
            view_v = self._view_version
            res, _ = _fetch_track(programs.track_against_points(
                self.cam, feats, lp, self._tensor(self.last_R), self._tensor(self.last_t),
                th=3.0, n_levels=cfg.n_levels, scale=cfg.scale_factor, lm_graph=self._pose_lm,
            ))
            n_inl = res.n_inliers
            if n_inl < cfg.min_track_matches:
                return False

        self.last_R = res.R
        self.last_t = res.t
        if self._imu_ready() and self.last_kf >= 0:
            self._vi_refine(feats, res, lp, timestamp)
        # body velocity (world frame) from the camera-centre motion
        dt = max(timestamp - self.last_time, 1e-6)
        c_prev = -prev_R.T @ prev_t
        c_new = -self.last_R.T @ self.last_t
        self.body_vel = ((c_new - c_prev) / dt).astype(np.float32)
        # constant-velocity model: Tcl = Tcw_new @ inv(Tcw_prev)
        self.velocity = self._current_pose() @ np.linalg.inv(prev_pose)

        # found/visible stats (MapPoint::IncreaseFound/Visible)
        m = self.map
        m.mp_visible[ids[res.visible[: len(ids)]]] += 1
        m.mp_found[ids[res.inlier[: len(ids)]]] += 1

        self.frames_since_kf += 1
        n_ct = n_cu = 0
        if not cfg.is_mono:
            n_ct, n_cu = self._close_point_counts(close, res, ids)
        ok_state = n_inl >= (cfg.min_local_inliers if self.state == OK else cfg.min_track_matches)
        # only frames that pass the OK gate may insert a keyframe
        # (`bNeedKF && bOK`, Tracking.cc:2644-2658); inertial modes also
        # while recently lost (mInsertKFsLost), when the map must grow back
        insert_ok = ok_state or (cfg.is_inertial and self.state == RECENTLY_LOST
                                 and n_inl >= cfg.min_track_matches)
        with GLOBAL_TIMER.stage("new_kf"):
            want_kf = (not self.localization_only and insert_ok
                       and self._need_new_kf(n_inl, timestamp, n_ct, n_cu))
            if want_kf and self.queue_probe is not None and view_v != m.version:
                again = self._track_again(feats)
                if again is not None:
                    res, ids, view_v = again
                    if not cfg.is_mono:
                        n_ct, n_cu = self._close_point_counts(close, res, ids)
                    want_kf = self._need_new_kf(res.n_inliers, timestamp, n_ct, n_cu)
            if want_kf:
                self._create_new_kf(feats, timestamp, res, ids, view_v)
        return ok_state

    def _vi_refine(self, feats: Features, res, lp: programs.LocalPoints, timestamp: float):
        """Visual-inertial pose refinement of the current frame
        (PoseInertialOptimizationLastKeyFrame, Optimizer.cc:435): the tracked
        matches as monocular reprojections, the preintegration from the last
        keyframe (the prologue already advanced it to this frame) and the
        bias random walk, on the 15-dof body state, replayed from a CUDA
        graph on the card (`inertial.PoseInertialGraph`). The result comes
        home in one packed copy.

        No marginalization prior is chained from frame to frame, where the
        JAX package chains one (ROADMAP C1, repaired in the port): the
        reference's prior (PoseInertialOptimizationLastFrame, :1002) sits on
        the previous frame's state, tied to the current one by the
        frame-to-frame preintegration. Here the inertial factor runs from the
        last keyframe, so that prior would pull the current frame toward the
        previous frame's pose with the information of all its matches."""
        with GLOBAL_TIMER.stage("vi_refine"):
            m = self.map
            kf = self.last_kf
            pre = self.imu.preintegrate_since_kf(self.last_kf_time, timestamp)
            if float(pre.dT) <= 1e-6:
                return
            Rbc = np.asarray(self.imu.calib.Rbc, np.float32)
            tbc = np.asarray(self.imu.calib.tbc, np.float32)
            Rcb = Rbc.T
            tcb = -Rcb @ tbc
            # the last keyframe's body state, and the current one from the visual
            # solution; the inlier matches as padded rows of the local map (its
            # positions are the view's, the map's positions of `ids`): one upload
            Rwc_k = m.kf_R[kf].T
            cw_k = -Rwc_k @ m.kf_t[kf]
            Rwc = self.last_R.T
            cw = -Rwc @ self.last_t
            Rwb = Rwc @ Rbc.T
            sel = res.inlier & (res.match_feat >= 0)
            (pR, pp, pv, pb, sR, sp, sv, sb, Rcb_t, tcb_t, idx, ok) = self._upload_packed(
                Rwc_k @ Rbc.T, cw_k - (Rwc_k @ Rbc.T) @ tbc, m.kf_vel[kf], m.kf_bias[kf],
                Rwb, cw - Rwb @ tbc, self.body_vel, self.imu.bias, Rcb, tcb,
                np.where(sel, res.match_feat, 0), sel)
            prev = inertial.VIState(Rwb=pR, pwb=pp, vel=pv, bias=pb)
            state0 = inertial.VIState(Rwb=sR, pwb=sp, vel=sv, bias=sb)
            idx, ok = idx.long(), ok > 0.5
            obs = pose_opt.PoseObs(
                p_world=lp.pos, uv=torch.where(ok[:, None], feats.xy[idx], 0.0),
                u_right=torch.full((sel.shape[0],), -1.0, device=self.device),
                level=torch.where(ok, feats.level[idx], 0), valid=ok,
            )
            st, _, n2, _ = self._pose_inertial(self.cam, state0, prev, pre, obs, (Rcb_t, tcb_t))
            flat = torch.cat([n2.reshape(1).to(torch.float32), st.Rwb.reshape(9), st.pwb, st.vel,
                              st.bias]).cpu().numpy()
            if int(flat[0]) >= self.cfg.min_track_matches:
                Rwb_n, pwb_n = flat[1:10].reshape(3, 3), flat[10:13]
                Rwc_n = Rwb_n @ Rbc
                cw_n = pwb_n + Rwb_n @ tbc
                self.last_R = Rwc_n.T
                self.last_t = -Rwc_n.T @ cw_n
                self.body_vel = flat[13:16].copy()
                self.imu.bias = flat[16:22].copy()

    def _bow_match(self, feats: Features, node: np.ndarray, kf: int, ratio: float):
        """SearchByBoW (ORBmatcher.cc:262): the frame's features (BoW nodes
        `node`) against keyframe kf's features that carry map points, inside
        shared nodes, TH_LOW + ratio + rotation histogram. Returns (X, point
        valid): per frame feature, the matched map point's position and
        whether it is a match, as device tensors; or None with fewer than
        15 candidates or matches."""
        m = self.map
        kf_node = self.kfdb.kf_node.get(kf)
        if kf_node is None:
            return None
        valid = node >= 0
        mask = ((node[:, None] == kf_node[None, :]) & valid[:, None]
                & (m.kf_feat_mp[kf] >= 0)[None, :])
        if mask.sum() < 15:
            return None
        idx, _, ok = matching.search_by_window(
            feats.desc, convert.desc_tensor(m.kf_feat_desc[kf], self.device),
            self._tensor(mask), th=matching.TH_LOW, ratio=ratio,
        )
        ok = matching.rotation_consistency(feats.angle, self._tensor(m.kf_feat_angle[kf]), idx, ok)
        idx_np, ok_np = idx.cpu().numpy(), ok.cpu().numpy()
        if ok_np.sum() < 15:
            return None
        mp = m.kf_feat_mp[kf, idx_np]
        pv = ok_np & (mp >= 0) & m.mp_valid[np.maximum(mp, 0)]
        return self._tensor(m.mp_pos[np.maximum(mp, 0)]), self._tensor(pv)

    def _track_reference_kf(self, feats: Features) -> bool:
        """TrackReferenceKeyFrame (Tracking.cc:3254): BoW-node matching
        against the reference KF (ratio 0.7), then the pose LM from the last
        pose. True, with last_R/t updated, on >= 10 inliers."""
        kf = self.last_kf
        if kf < 0 or self.kfdb is None or not self.map.kf_valid[kf]:
            return False
        _, node = self.kfdb.voc.transform_on_device(feats.desc, feats.valid)
        found = self._bow_match(feats, node, kf, ratio=0.7)
        if found is None:
            return False
        X, pv = found
        obs = pose_opt.PoseObs(p_world=X, uv=feats.xy, u_right=feats.u_right,
                               level=feats.level, valid=pv)
        R, t, _, n = pose_opt.optimize_pose(self.cam, self._tensor(self.last_R),
                                            self._tensor(self.last_t), obs)
        if int(n) < 10:
            return False
        self.last_R = R.cpu().numpy()
        self.last_t = t.cpu().numpy()
        return True

    def _close_features(self, feats: Features):
        """(N,) bool: valid features with a measured depth below ThDepth (no
        limit when the camera has no baseline); on the device, or on the
        host when the frame's features came home already."""
        th_d = self.cam.baseline * self.cfg.depth_th_factor
        if th_d <= 0:
            th_d = np.inf
        if self._host is not None:
            f = self._host
            return f["valid"] & (f["depth"] > 0) & (f["depth"] < th_d)
        return feats.valid & (feats.depth > 0) & (feats.depth < th_d)

    def _close_point_counts(self, close: np.ndarray, res, ids) -> tuple[int, int]:
        """Stereo / RGB-D close-point census for NeedNewKeyFrame's c1c
        (Tracking.cc:3774-3821): close features tracked to an inlier map
        point, and close features not tracked."""
        matched = np.zeros(close.shape[0], bool)
        mf = res.match_feat[: len(ids)]
        matched[mf[res.inlier[: len(ids)] & (mf >= 0)]] = True
        return int((close & matched).sum()), int((close & ~matched).sum())

    def _need_new_kf(self, n_inl: int, timestamp: float, n_close_tracked: int = 0,
                     n_close_untracked: int = 0) -> bool:
        """NeedNewKeyFrame (Tracking.cc:3726-3924): c1a (max frames) or c1b
        (min frames, mapper idle) or, stereo / RGB-D, c1c (few tracked
        points, or too few close points tracked while many are not); and c2
        (tracked ratio against the reference KF's well-observed points,
        0.75 for stereo / RGB-D, or the close-point deficit). With an IMU,
        one keyframe every 0.25 s before the IMU is initialized, and after
        it c3 (0.5 s since the last KF) and, monocular, c4 (15 < inliers <
        75, or recently lost). c1b needs an idle mapper: none waits in its
        queue (`queue_probe`, asynchronous mapping) and none is being
        mapped (`mapper_busy`). When a keyframe is wanted from a busy
        mapper, its local BA is interrupted (`interrupt_ba`), and monocular
        inserts none, stereo / RGB-D one while fewer than 3 wait
        (Tracking.cc:3896-3910). A mapper that runs inline is always
        idle."""
        cfg = self.cfg
        m = self.map
        nkfs = len(m.kf_ids())
        # don't insert right after a relocalization (Tracking.cc:3742)
        if (self.frame_id < self.last_reloc_frame + cfg.max_frames_between_kf
                and nkfs > cfg.max_frames_between_kf):
            return False
        if cfg.is_inertial and not m.map_imu_init.get(m.active_map, False):
            return (timestamp - self.last_kf_time) >= 0.25  # Tracking.cc:3733-3736
        queue_len = self.queue_probe() if self.queue_probe is not None else 0
        mapper_idle = queue_len == 0 and not (self.mapper_busy is not None
                                              and self.mapper_busy())
        mids = m.kf_feat_mp[self.last_kf]
        mids = mids[mids >= 0]
        n_obs = m.mp_n_obs[mids] if cfg.is_mono else self._stereo_weighted_obs(mids)
        ref_matches = int((n_obs >= (3 if nkfs > 2 else 2)).sum())
        th_ref = (cfg.kf_ref_ratio if cfg.is_mono else 0.75) if nkfs >= 2 else 0.4
        need_close = n_close_tracked < 100 and n_close_untracked > 70
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.min_frames_between_kf and mapper_idle
        c1c = not cfg.is_mono and (n_inl < ref_matches * 0.25 or need_close)
        c2 = (n_inl < ref_matches * th_ref or need_close) and n_inl > 15
        c3 = cfg.is_inertial and (timestamp - self.last_kf_time) >= 0.5
        c4 = cfg.sensor == IMU_MONOCULAR and ((15 < n_inl < 75) or self.state == RECENTLY_LOST)
        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if mapper_idle:
            return True
        if self.interrupt_ba is not None:
            self.interrupt_ba()
        # a busy mapper: stereo / RGB-D may still queue up to 3 keyframes
        return not cfg.is_mono and queue_len < 3

    def _stereo_weighted_obs(self, mps: np.ndarray) -> np.ndarray:
        """MapPoint::Observations() of each point as the reference counts it
        (MapPoint::AddObservation): an observation with a right coordinate
        counts 2, a monocular one 1. The map's `mp_n_obs` counts each once,
        as the JAX package's does; with that count no point of a first
        stereo keyframe reaches 2, and a map whose points all lie beyond
        ThDepth never inserts a second keyframe."""
        m = self.map
        kf, fi = m.mp_obs_kf[mps], m.mp_obs_idx[mps]
        stereo = (kf >= 0) & (fi >= 0) & (m.kf_feat_ur[np.maximum(kf, 0), np.maximum(fi, 0)] >= 0)
        return m.mp_n_obs[mps] + stereo.sum(axis=1)

    def _create_new_kf(self, feats, timestamp, res, ids, view_version: int):
        """CreateNewKeyFrame: a keyframe from the tracked frame, associated
        with the points it tracked. `ids` are the local view's, taken at map
        version `view_version`: a mapping worker may since have culled some
        of them and reused their slots, so under the map's lock only points
        still in the map and made no later than the view are associated
        (inline all are; ROADMAP C15)."""
        m = self.map
        f = _np_feats(feats) if self._host is None else self._host
        ids = np.asarray(ids, np.int64)
        match_feat = res.match_feat[: len(ids)]
        with m.lock:
            kf = m.add_keyframe(self.last_R, self.last_t, f, timestamp,
                                parent=self.last_kf, prev=self.last_kf)
            same = m.mp_valid[ids] & (m.mp_born[ids] <= view_version)
            j = np.nonzero(res.inlier[: len(ids)] & (match_feat >= 0) & same)[0]
            m.add_observations(ids[j], kf, match_feat[j])
        if not self.cfg.is_mono:
            # stereo / RGB-D: new points from the measured depths
            self._spawn_depth_points(kf, f)
        if self.imu is not None:
            m.kf_vel[kf] = self.body_vel
            m.kf_bias[kf] = self.imu.bias
            self.kf_preint[kf] = self.imu.preintegrate_since_kf(self.last_kf_time, timestamp,
                                                                with_raw=True)
            self.imu.on_new_keyframe(timestamp)
            self.last_kf_time = timestamp
        self._register_kf(kf)
        self.last_kf = kf
        self.frames_since_kf = 0
        self.pending_kf = kf

    def _relocalize(self, feats: Features) -> bool:
        """BoW candidates -> BoW-guided matching -> batched PnP RANSAC ->
        guided growth through the candidate's local map; success with >= 20
        inliers (Relocalization, Tracking.cc:4444-4666)."""
        m = self.map
        word, node = self.kfdb.voc.transform_on_device(feats.desc, feats.valid)
        cands = self.kfdb.detect_relocalization_candidates(self.kfdb.voc.bow_vector(word), m)
        for kf in cands:
            if not m.kf_valid[kf]:
                continue
            found = self._bow_match(feats, node, kf, ratio=0.75)
            if found is None:
                continue
            X, pv = found
            R, t, _, n_inl = pnp.pnp_ransac(self.cam, X, feats.xy, pv,
                                            _seed(self.generator, self._rng))
            n_inl = int(n_inl)
            if n_inl < 10:
                continue
            # guided growth (Tracking.cc:4560-4640): project the candidate's
            # local map through the PnP pose with a wide window
            lp, _ = self._candidate_local_view(kf)
            res = programs.track_against_points(
                self.cam, feats, lp, R, t, th=2.5,
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor, lm_graph=self._pose_lm,
            )
            if int(res.n_inliers) >= max(20, n_inl):
                R, t, n_inl = res.R, res.t, int(res.n_inliers)
            if n_inl >= 20:
                self.last_R = R.cpu().numpy()
                self.last_t = t.cpu().numpy()
                self.velocity = None
                self.last_kf = kf
                # relocalized into another sub-map: make it the active map
                target_map = int(m.kf_map_id[kf])
                if target_map != m.active_map:
                    m.active_map = target_map
                    m.version += 1
                return True
        return False

    def _candidate_local_view(self, kf: int):
        """LocalPoints view around a relocalization candidate keyframe."""
        m = self.map
        cap = self.cfg.local_points_cap
        with m.lock:
            ids = m.local_point_ids(np.unique([kf] + m.covisible_kfs(kf, k=10, min_weight=5)),
                                    cap)
            return convert.local_points_from_map(m, ids, cap, self.device), ids

    def _handle_lost(self):
        """Recovery ladder tail (Tracking.cc:2299-2322): a young map (< 10
        KFs), or an inertial map whose IMU never initialized (no metric
        scale, no gravity), is reset with its inertial staging, so the
        inertial init starts again; an established one is kept and a fresh
        sub-map started."""
        m = self.map
        imu_uninit = self.cfg.is_inertial and not m.map_imu_init.get(int(m.active_map), False)
        if len(m.kf_ids(m.active_map)) < 10 or imu_uninit:
            self.n_lost_resets += 1
            for mp in m.mp_ids(m.active_map):
                m.remove_point(int(mp))
            for kf in m.kf_ids(m.active_map):
                m.kf_valid[kf] = False
                if self.kfdb is not None:
                    self.kfdb.erase(int(kf))
            m.map_imu_init[m.active_map] = False
            m.map_viba1[m.active_map] = False
            m.map_viba2[m.active_map] = False
        else:
            self.n_submap_spawns += 1
            m.create_new_map()
        self.state = NOT_INITIALIZED
        self._init_feats = None
        self.velocity = None
        self.last_kf = -1
