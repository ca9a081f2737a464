"""Public SLAM system facade.

Port of `orb_slam3_comments_ghr_tpu/system.py` (ORB_SLAM3::System,
reference include/System.h:104-195): construct with a camera + config (and,
for the IMU_* sensors, an `imu_calib`), feed frames with `track_monocular`,
`track_stereo` (a rectified pair), `track_stereo_fisheye` (a non-rectified
fisheye pair and its extrinsics) or `track_rgbd` (an image and its depth
map), or features with `track_features`, each with the IMU rows since the
last frame as `imu_samples` (or fed ahead with `feed_imu`); query the state,
export trajectories. Tracking runs inline per frame, local mapping and then
loop closing (`enable_loop_closing`, on by default) inline per keyframe.
A Kannala-Brandt (KB8) camera extracts on the raw image and runs its
geometry on undistorted keypoints under the virtual pinhole with the same
intrinsics (`cameras.pinhole_equivalent`).

The system runs on one device: the card (`torch.device("cuda")`) unless the
caller passes `device="cpu"`. The per-frame and per-keyframe programs run
there; the map and the IMU sample queue stay on the host. `save_atlas` /
`load_atlas` write and read the whole multi-map state (`map/persistence.py`,
the JAX package's file format); with `SlamConfig(dba_devices != 0)` in a
world of several processes (`parallel/distributed.initialize`) the whole-map
BA is sharded over the ranks (`parallel/dba.py`). Asynchronous mapping is not
ported yet and is refused with NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .frontend import stereo
from .map import persistence
from .map.state import MapConfig, MapState
from .ops import cameras, lie
from .optim import imu as imu_mod
from .pipeline import programs
from .pipeline.imu_frontend import ImuFrontend
from .pipeline.loopcloser import LoopCloser
from .pipeline.mapper import LocalMapper
from .pipeline.tracker import NOT_INITIALIZED, STATE_NAMES, Tracker
from .retrieval.database import KeyFrameDatabase
from .retrieval.vocabulary import Vocabulary
from .utils.config import SlamConfig
from .utils.device import resolve_device
from .utils.profiling import GLOBAL_TIMER


def _check_supported(cfg: SlamConfig):
    if cfg.async_mapping:
        raise NotImplementedError("asynchronous mapping is not ported yet: set async_mapping=False")


class SLAM:
    def __init__(self, cam: cameras.Camera, cfg: Optional[SlamConfig] = None,
                 imu_calib: Optional[imu_mod.ImuCalib] = None, device=None):
        self.cfg = cfg or SlamConfig()
        _check_supported(self.cfg)
        self.device = resolve_device(device)
        self.cam = cam
        self.geom_cam = cameras.pinhole_equivalent(cam)
        voc_path = self.cfg.voc_path or os.path.join(
            os.path.dirname(__file__), "retrieval", "default_voc.npz")
        self.voc = (Vocabulary.load(voc_path, device=self.device) if os.path.exists(voc_path)
                    else Vocabulary.random(device=self.device))
        self._imu_calib = imu_calib or imu_mod.default_calib()
        self._new_session()

    def _new_session(self, map_state: Optional[MapState] = None):
        """A keyframe database, IMU front end, tracker, mapper and loop
        closer, all new (the vocabulary is kept), around `map_state` or a
        fresh map; the database holds the valid keyframes of every sub-map
        (Atlas::PostLoad)."""
        self.map = map_state or MapState(MapConfig(
            max_kf=self.cfg.max_kf, max_mp=self.cfg.max_mp, n_feat=self.cfg.n_features,
            obs_cap=self.cfg.obs_cap, scale_factor=self.cfg.scale_factor,
            n_levels=self.cfg.n_levels,
        ))
        self.kfdb = KeyFrameDatabase(self.voc, self.cfg.max_kf)
        for kf in np.nonzero(self.map.kf_valid)[0]:
            self.kfdb.add(int(kf), self.map.kf_feat_desc[kf], self.map.kf_feat_valid[kf])
        self.imu = None
        if self.cfg.is_inertial:
            self.imu = ImuFrontend(self._imu_calib, device=self.device)
        self.tracker = Tracker(self.geom_cam, self.cfg, self.map, kfdb=self.kfdb, imu=self.imu,
                               device=self.device)
        self.mapper = LocalMapper(self.geom_cam, self.cfg, self.map, kfdb=self.kfdb,
                                  device=self.device)
        self.mapper.imu = self.imu
        self.mapper.kf_preint = self.tracker.kf_preint
        self.loopcloser = LoopCloser(self.geom_cam, self.cfg, self.map, self.kfdb, self.mapper,
                                     device=self.device)
        self._empty_lp = None

    # --------------------------------------------------------------- per-frame
    def feed_imu(self, samples) -> None:
        """samples: (M, 7) rows [t, ax, ay, az, wx, wy, wz] (the vImuMeas of
        System::TrackMonocular / GrabImuData)."""
        if self.imu is None:
            raise RuntimeError("feed_imu requires an IMU_* sensor config")
        self.imu.feed(samples)

    def _dummy_local_points(self) -> programs.LocalPoints:
        """Empty local-point view, so init / relocalization frames run the
        same fused program (its track half then finds nothing)."""
        if self._empty_lp is None:
            L = self.cfg.local_points_cap
            z = dict(device=self.device)
            self._empty_lp = programs.LocalPoints(
                pos=torch.zeros((L, 3), **z), desc=torch.zeros((L, 8), dtype=torch.int32, **z),
                normal=torch.zeros((L, 3), **z), min_dist=torch.ones((L,), **z),
                max_dist=torch.ones((L,), **z), valid=torch.zeros((L,), dtype=torch.bool, **z),
                angle=torch.zeros((L,), **z),
            )
        return self._empty_lp

    def track_monocular(self, img, timestamp: float, imu_samples=None) -> Optional[np.ndarray]:
        """img: (H,W) grayscale array or tensor (uint8 or float). Returns
        4x4 Tcw or None (System::TrackMonocular, System.h:120)."""
        if imu_samples is not None:
            self.feed_imu(imu_samples)
        ready, lp, R0, t0, th = self._prepare(timestamp)
        feats, res = programs.extract_and_track(
            self.cam, self.geom_cam, self._upload(img), lp, R0, t0,
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale=self.cfg.scale_factor, ini_th=self.cfg.ini_th_fast,
            min_th=self.cfg.min_th_fast, th=th, undistort=self._fisheye,
        )
        return self.track_features(feats, timestamp, precomputed=(res,) if ready else None)

    def track_stereo(self, img_left, img_right, timestamp: float,
                     imu_samples=None) -> Optional[np.ndarray]:
        """A rectified stereo pair of (H,W) grayscale arrays or tensors.
        Returns 4x4 Tcw or None (System::TrackStereo, System.h:109)."""
        if imu_samples is not None:
            self.feed_imu(imu_samples)
        ready, lp, R0, t0, th = self._prepare(timestamp)
        feats, res = programs.extract_and_track_stereo(
            self.cam, self.geom_cam, self._upload(img_left), self._upload(img_right), lp, R0, t0,
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale=self.cfg.scale_factor, ini_th=self.cfg.ini_th_fast,
            min_th=self.cfg.min_th_fast, th=th, undistort=self._fisheye,
        )
        return self.track_features(feats, timestamp, precomputed=(res,) if ready else None)

    def track_stereo_fisheye(self, img_left, img_right, cam_right: cameras.Camera, R_lr, t_lr,
                             timestamp: float, imu_samples=None,
                             features=None) -> Optional[np.ndarray]:
        """A non-rectified (e.g. KB8 fisheye) stereo pair with the
        extrinsics x_l = R_lr x_r + t_lr (KannalaBrandt8::matchAndtriangulate
        and the Frame fisheye constructor). Each view's keypoints are
        undistorted with its own camera, matched under the pair's epipolar
        geometry and triangulated (`programs.fisheye_stereo_depth`); the
        depths seed metric map points. The rig is registered with the map
        on the first call. When the frame becomes a keyframe, its matched
        right-view pixels, re-expressed in the left virtual pinhole's
        intrinsics, become right-camera observations of its points
        (`MapState.set_right_observations`), which both BAs constrain
        through the rig (`obs_rig`). `features=(fl, fr)` passes features
        extracted elsewhere (raw pixels, on the system's device) instead
        of the images. Returns 4x4 Tcw or None."""
        if imu_samples is not None:
            self.feed_imu(imu_samples)
        if features is None:
            kw = dict(n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
                      scale=self.cfg.scale_factor, ini_th=self.cfg.ini_th_fast,
                      min_th=self.cfg.min_th_fast)
            features = (programs.extract_only(self.cam, self._upload(img_left), **kw),
                        programs.extract_only(cam_right, self._upload(img_right), **kw))
        fl, fr = features
        R_lr = np.asarray(R_lr, np.float32)
        t_lr = np.asarray(t_lr, np.float32)
        xy1 = cameras.undistort_points(self.cam, fl.xy)
        xy2 = cameras.undistort_points(cam_right, fr.xy)
        geom_r = cameras.pinhole_equivalent(cam_right)
        depth, ridx, matched = programs.fisheye_stereo_depth(
            self.geom_cam, geom_r, xy1, fl.level, fl.desc, fl.valid,
            xy2, fr.level, fr.desc, fr.valid, self._upload(R_lr), self._upload(t_lr))
        if self.map.rig is None:  # x_r = R_rl x_l + t_rl
            self.map.rig = (R_lr.T.copy(), -R_lr.T @ t_lr)
        n_kf_before = self.map.n_kf
        pose = self.track_features(fl._replace(xy=xy1, depth=depth), timestamp)
        if self.map.n_kf > n_kf_before:
            self._attach_right_observations(self.map.n_kf - 1, geom_r, matched, xy2, fr.level,
                                            ridx)
        return pose

    def _attach_right_observations(self, kf: int, geom_r: cameras.Camera, matched, xy2, level2,
                                   ridx):
        """The new keyframe's matched right-view keypoints as right-camera
        observations of its points: one packed copy to the host (matched,
        uv, level per left keypoint), uv mapped from the right virtual
        pinhole to the left one's intrinsics, so that BA projects every row
        with one camera."""
        sel = ridx.long()
        packed = torch.cat([matched.to(torch.float32)[:, None], xy2[sel],
                            level2[sel].to(torch.float32)[:, None]], dim=1).cpu().numpy()
        mp_row = self.map.kf_feat_mp[kf]
        n = len(mp_row)
        take = (mp_row >= 0) & (packed[:n, 0] > 0.5)
        if not take.any():
            return
        g = self.geom_cam
        norm = (packed[:n][take, 1:3] - np.array([geom_r.cx, geom_r.cy])) / np.array(
            [geom_r.fx, geom_r.fy])
        uv = norm * np.array([g.fx, g.fy]) + np.array([g.cx, g.cy])
        self.map.set_right_observations(kf, mp_row[take], uv.astype(np.float32),
                                        packed[:n][take, 3].astype(np.int32))

    def track_rgbd(self, img, depth_map, timestamp: float,
                   imu_samples=None) -> Optional[np.ndarray]:
        """An (H,W) grayscale image and its (H,W) metric depth map (0 where
        unknown). Returns 4x4 Tcw or None (System::TrackRGBD, System.h:114).
        Extraction with the virtual right coordinates is one dispatch,
        tracking (in `track_features`) the second."""
        if imu_samples is not None:
            self.feed_imu(imu_samples)
        feats = programs.extract_only(
            self.cam, self._upload(img), n_features=self.cfg.n_features,
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
        )
        u_right, depth = stereo.depth_to_stereo(self.cam, feats, self._upload(depth_map))
        feats = feats._replace(u_right=u_right, depth=depth)
        if self._fisheye:
            feats = feats._replace(xy=cameras.undistort_points(self.cam, feats.xy))
        return self.track_features(feats, timestamp)

    @property
    def _fisheye(self) -> bool:
        """Keypoints need undistorting to the virtual pinhole."""
        return self.cam.kind != cameras.PINHOLE

    def _prepare(self, timestamp: float):
        """(ready, local points, R0, t0, search-window multiplier) for the
        fused per-frame program; on init and relocalization frames (not
        ready) the empty view and the identity, so that its track half finds
        nothing."""
        ready, lp, _, R0, t0 = self.tracker.prepare_frame(timestamp)
        if ready:
            return True, lp, R0, t0, self.tracker._prepared_th
        eye, zero = torch.eye(3, device=self.device), torch.zeros(3, device=self.device)
        return False, self._dummy_local_points(), eye, zero, 1.0

    def _upload(self, a) -> torch.Tensor:
        return (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(self.device)

    def track_features(self, feats, timestamp: float, precomputed=None):
        """Entry point for features produced elsewhere (tests, other front
        ends): a Features tuple of tensors on the system's device."""
        # IMU watchdog: mbBadImu resets the active map from the tracking
        # side (LocalMapping.cc:191-198, Tracking.cc:2023-2028)
        if self.mapper.bad_imu:
            self.mapper.bad_imu = False
            self.mapper._imu_init_failures = 0
            self.reset_active_map()
        with GLOBAL_TIMER.stage("track_map"):
            pose = self.tracker.track(feats, timestamp, precomputed=precomputed)
        kf = self.tracker.pending_kf
        if kf is not None and self.n_keyframes() >= 2:
            self.mapper.process_keyframe(kf)
            if self.mapper.map_transformed:
                # the IMU init rotated and rescaled the world
                self.mapper.map_transformed = False
                self._reseat_tracker(kf)
            if self.cfg.enable_loop_closing and self.loopcloser.process_keyframe(kf):
                self._reseat_tracker(kf)  # a loop or merge correction moved it
        return pose

    def _reseat_tracker(self, kf: int):
        """The tracker goes on from keyframe kf's new pose and velocity."""
        t = self.tracker
        t.last_R = self.map.kf_R[kf].copy()
        t.last_t = self.map.kf_t[kf].copy()
        t.body_vel = self.map.kf_vel[kf].copy()
        t.velocity = t._last_prediction = None

    # --------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        return STATE_NAMES[self.tracker.state]

    def n_keyframes(self) -> int:
        return len(self.map.kf_ids())

    def n_map_points(self) -> int:
        return len(self.map.mp_ids())

    # ------------------------------------------------------------ mode/reset
    def activate_localization_mode(self):
        """Tracking-only: no new keyframes/map growth (System.h:123)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """Full reset (System::Reset): every map, the keyframe database,
        the IMU queue and bias, and the tracker's, mapper's and loop
        closer's state start again as in a new SLAM. The JAX package keeps
        the database and the inertial clocks (ROADMAP C3); localization
        mode stays as it was."""
        localization_only = self.tracker.localization_only
        self._new_session()
        self.tracker.localization_only = localization_only

    def reset_active_map(self):
        """Drop only the active sub-map (System::ResetActiveMap), with its
        inertial staging, so that a new IMU init starts clean."""
        m = self.map
        for mp in m.mp_ids(m.active_map):
            m.remove_point(int(mp))
        for kf in m.kf_ids(m.active_map):
            m.kf_valid[kf] = False
            self.kfdb.erase(int(kf))
        m.map_imu_init[m.active_map] = False
        m.map_viba1[m.active_map] = False
        m.map_viba2[m.active_map] = False
        self.mapper.viba1_done = self.mapper.viba2_done = False
        self.mapper.t_imu_init = None
        self.mapper.t_init_accum = 0.0
        self.mapper.recent_mps.clear()
        self.tracker.state = NOT_INITIALIZED
        self.tracker.last_kf = -1
        self.tracker._init_feats = None
        self.tracker.velocity = None
        self.tracker.kf_preint.clear()
        if self.imu is not None:
            self.imu.queue.clear()

    def shutdown(self, atlas_path: Optional[str] = None):
        """System::Shutdown (System.cc:573): mapping and loop closing run
        inline, so nothing is left to drain; the atlas is written to
        `atlas_path` when one is given."""
        if atlas_path:
            self.save_atlas(atlas_path)

    def print_time_stats(self):
        """Tracking::PrintTimeStats: the stages of `GLOBAL_TIMER`."""
        GLOBAL_TIMER.print_time_stats()

    # ----------------------------------------------------------- persistence
    def save_atlas(self, path: str):
        """Write every map with its counters (System::SaveAtlas)."""
        persistence.save_atlas(self.map, path, voc=self.voc)

    def load_atlas(self, path: str, new_session: bool = True):
        """Load a previous session's atlas (System.cc:194-207). The
        session starts again around it, as `reset()` does: a new keyframe
        database filled from the loaded keyframes, and a new tracker,
        mapper, loop closer and IMU front end; the JAX package keeps its
        components and their state (ROADMAP C12). With `new_session` a new
        active sub-map is opened, so that tracking starts clean and can
        later merge into the loaded maps (multi-session SLAM). The file
        holds no preintegrations: an inertial map loads IMU-initialized,
        and its links carry no inertial factor (ROADMAP C13)."""
        m = persistence.load_atlas(path, voc=self.voc)
        if new_session:
            m.create_new_map()
        localization_only = self.tracker.localization_only
        self._new_session(m)
        self.tracker.localization_only = localization_only

    # --------------------------------------------------------------- export
    def trajectory(self) -> list[tuple[float, np.ndarray]]:
        """Full-frame trajectory rebuilt against the (BA-refined) reference
        KFs (SaveTrajectoryTUM pattern, System.cc:635): Tcw = Tcr @ Trw(ref),
        walking culled KFs through their frozen Tcp to a live ancestor
        (System.cc:760-847)."""
        out = []
        m = self.map
        for rec in self.tracker.records:
            if rec.lost or rec.ref_kf < 0:
                continue
            ref = rec.ref_kf
            T_chain = np.eye(4, dtype=np.float32)
            while ref >= 0 and not m.kf_valid[ref]:
                T_chain = T_chain @ m.kf_Tcp[ref]
                ref = int(m.kf_parent[ref])
            if ref < 0:
                continue
            T_rw = np.eye(4, dtype=np.float32)
            T_rw[:3, :3] = m.kf_R[ref]
            T_rw[:3, 3] = m.kf_t[ref]
            out.append((rec.timestamp, rec.T_cr @ T_chain @ T_rw))
        return out

    @staticmethod
    def _quat(R_wc: np.ndarray) -> np.ndarray:
        return lie.mat_to_quat(torch.from_numpy(np.asarray(R_wc, np.float32))).numpy()

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only trajectory (System::SaveKeyFrameTrajectoryTUM)."""
        with open(path, "w") as f:
            for kf in self.map.kf_ids():
                R_wc = self.map.kf_R[kf].T
                t = -R_wc @ self.map.kf_t[kf]
                q = self._quat(R_wc)
                f.write(f"{self.map.kf_time[kf]:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_euroc(self, path: str):
        """EuRoC format: TUM fields with nanosecond timestamps
        (System::SaveTrajectoryEuRoC, System.cc:730)."""
        with open(path, "w") as f:
            for ts, T_cw in self.trajectory():
                T_wc = np.linalg.inv(T_cw)
                q, t = self._quat(T_wc[:3, :3]), T_wc[:3, 3]
                f.write(f"{int(ts * 1e9)} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 3x4 row-major T_wc per line
        (System::SaveTrajectoryKITTI, System.cc:1275)."""
        with open(path, "w") as f:
            for _, T_cw in self.trajectory():
                f.write(" ".join(f"{v:.7e}" for v in np.linalg.inv(T_cw)[:3, :4].reshape(-1)) + "\n")

    def save_trajectory_tum(self, path: str):
        """TUM format: `t x y z qx qy qz qw` of the camera in world
        (System::SaveTrajectoryTUM, System.cc:635)."""
        with open(path, "w") as f:
            for ts, T_cw in self.trajectory():
                T_wc = np.linalg.inv(T_cw)
                q, t = self._quat(T_wc[:3, :3]), T_wc[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
