"""Loop closing and map merging.

Port of `orb_slam3_comments_ghr_tpu/pipeline/loopcloser.py` (the
LoopClosing thread, reference src/LoopClosing.cc Run() :103): per new
keyframe, detect a common region through the keyframe database
(NewDetectCommonRegions :386), verify it with Sim(3) RANSAC, guided matching
and Sim(3) refinement (DetectCommonRegionsFromBoW :790), then either correct
a loop inside the active map (CorrectLoop :1377 and the essential graph) or
merge two sub-maps (MergeLocal :1697). A global BA follows a loop
correction (RunGlobalBundleAdjustment :3067).

The map arithmetic stays on the host in numpy float64, as in the JAX
package; tensors go to the device only at the calls of `search_by_window`,
`sim3_ransac` / `optimize_sim3`, `programs.fuse_project` (the window-match
kernel on the card) and the pose graph. The global BA (visual, or the
mapper's `full_inertial_ba` in an IMU-initialized map) runs inline, or with
`async_mapping` on a thread of its own (`_launch_gba`), racing tracking and
mapping as the reference's GBA thread does; the next verified loop or merge
stops it at a bite boundary and waits for its write-back (`abort_gba`). The
corrections write the map under its lock. An inertial weld ends in the
mapper's `merge_inertial_ba`.
"""

from __future__ import annotations

import contextlib
import math
import threading
import traceback

import numpy as np
import torch

from .. import convert
from ..map.state import MapState
from ..ops import cameras, lie, matching
from ..optim import posegraph
from ..optim import sim3 as sim3_mod
from ..utils.config import SlamConfig
from ..utils.device import resolve_device
from ..utils.profiling import GLOBAL_TIMER
from . import programs

class LoopCloser:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb, mapper, device=None):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb
        self.mapper = mapper
        self.device = resolve_device(device)
        # the RANSAC draws (the JAX package seeds its numpy generator with 11)
        self.generator = torch.Generator(device=self.device).manual_seed(11)
        self.n_loops = 0
        self.n_merges = 0
        # 3 confirmations before correcting (LoopClosing.cc:455-523): the
        # first Sim(3) verification, spatial hits from covisible keyframes
        # and temporal hits on the next keyframes all count
        self.required_hits = 3
        # parallel pending hypotheses, each with its own counters
        # (mvConsistentGroups, LoopClosing.cc:455-523)
        self._pendings: list[dict] = []
        # the whole-map BA's thread with asynchronous mapping
        # (LoopClosing.cc:1669-1681), the CUDA stream it runs on, and what
        # is called with the exception that ends it (the system counts it)
        self._gba_thread = None
        self.gba_stream = None
        self.on_gba_error = None

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int) -> bool:
        """True if a loop or merge correction was applied. A hypothesis
        needs 3 confirmations before it is applied (LoopClosing.cc:455-523,
        <= 2 misses tolerated)."""
        m = self.map
        mid = int(m.kf_map_id[kf])
        # detection gates (NewDetectCommonRegions, LoopClosing.cc:413-436):
        # inertial maps wait for VIBA2 (or at least the IMU init); young
        # maps are skipped
        if self.cfg.is_inertial:
            if self.cfg.loop_requires_viba2 and not m.map_viba2.get(mid, False):
                return False
            if not m.map_imu_init.get(mid, False):
                return False
        if len(m.kf_ids(mid)) < self.cfg.loop_min_kfs:
            return False
        # the strongest pending hypothesis is re-verified against the new
        # keyframe first (DetectAndReffineSim3FromLastKF, LoopClosing.cc:716)
        cand_info = None
        with GLOBAL_TIMER.stage("place_recognition"):
            if self._pendings:
                cand_info = self._refine_pending(kf, max(self._pendings,
                                                         key=lambda q: q["hits"]))
            if cand_info is None:
                cand_info = self._detect(kf)
        if cand_info is None:
            for q in self._pendings:
                q["misses"] += 1
            self._pendings = [q for q in self._pendings if q["misses"] <= 2]
            return False
        cand, s12, R12, t12, _ = cand_info
        region = set([cand] + m.covisible_kfs(cand, k=10, min_weight=15))
        matched = next((q for q in self._pendings if q["region"] & region), None)
        if matched is not None:
            matched["hits"] += 1
            matched["misses"] = 0
            matched["region"] |= region
            matched.update(sim3=(s12, R12, t12), kf=kf, cand=cand)
        else:
            # spatial verification from the current keyframe's covisible
            # keyframes (LoopClosing.cc:1168-1250): each success confirms
            with GLOBAL_TIMER.stage("place_recognition"):
                hits = 1 + self._spatial_verification(kf, cand, s12, R12, t12)
            matched = {"region": region, "hits": hits, "misses": 0,
                       "sim3": (s12, R12, t12), "kf": kf, "cand": cand}
            self._pendings.append(matched)
        for q in self._pendings:
            if q is not matched:
                q["misses"] += 1
        # the [-8:] cap can evict the group that just matched (ROADMAP C5,
        # kept as in the JAX package)
        self._pendings = [q for q in self._pendings if q["misses"] <= 2][-8:]
        if matched["hits"] < self.required_hits:
            return False
        cand = matched["cand"]
        s12, R12, t12 = matched["sim3"]
        self._pendings = []
        same_map = m.kf_map_id[cand] == m.kf_map_id[kf]
        # inertial acceptance gates (LoopClosing.cc:171-198, :287-311): a
        # merge changes scale by <= 10 %; a loop keeps gravity, the world
        # correction R_cur_w^T R12 R_cand_w within 0.008 rad of roll / pitch
        if self.cfg.is_inertial and m.map_imu_init.get(int(m.kf_map_id[kf]), False):
            if not same_map and not (0.9 <= s12 <= 1.1):
                return False
            if same_map:
                R_corr = (m.kf_R[kf].T.astype(np.float64) @ np.asarray(R12, np.float64)
                          @ m.kf_R[cand].astype(np.float64))
                rot = lie.so3_log(torch.from_numpy(R_corr.astype(np.float32))).numpy()
                if abs(rot[0]) > 0.008 or abs(rot[1]) > 0.008:
                    return False
        # a verified loop or merge supersedes a whole-map BA still refining
        # the uncorrected map: it stops at its next bite and writes back
        # first (mbStopGBA, LoopClosing.cc:1383-1407)
        self.abort_gba()
        if same_map:
            with GLOBAL_TIMER.stage("loop_correct"):
                self._correct_loop(kf, cand, s12, R12, t12)
            self.n_loops += 1
        else:
            with GLOBAL_TIMER.stage("merge"):
                self._merge_maps(kf, cand, s12, R12, t12)
            self.n_merges += 1
        return True

    # ------------------------------------------------------- background GBA
    def abort_gba(self):
        """Stop a running whole-map BA at its next bite and wait for its
        write-back (Optimizer.cc:1891 ForceStop)."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            self.mapper.request_abort_gba()
            t.join()
        self._gba_thread = None

    def join_gba(self):
        """Wait for a running whole-map BA without stopping it."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            t.join()
        self._gba_thread = None

    @property
    def gba_running(self) -> bool:
        t = self._gba_thread
        return t is not None and t.is_alive()

    def _launch_gba(self, fn, **kw):
        """A whole-map BA (visual or inertial): inline, or with
        `async_mapping` on a thread of its own, one at a time, on
        `gba_stream` (RunGlobalBundleAdjustment, LoopClosing.cc:1669-1681).
        It takes its problem from the map and writes back under the map's
        lock, in bites that `abort_gba` can stop; the whole-map visual BA
        also carries its correction to keyframes and points made while it
        ran. It is a `global_ba` span, on its thread with the frame id of
        the keyframe that launched it."""
        if not self.cfg.async_mapping:
            with GLOBAL_TIMER.stage("global_ba"):
                fn(**kw)
            return
        self.join_gba()
        frame = GLOBAL_TIMER.frame()

        def run():
            try:
                with (torch.cuda.stream(self.gba_stream) if self.gba_stream is not None
                      else contextlib.nullcontext()), GLOBAL_TIMER.stage("global_ba", frame=frame):
                    fn(**kw)
            except Exception:
                traceback.print_exc()
                if self.on_gba_error is not None:
                    self.on_gba_error()

        self._gba_thread = threading.Thread(target=run, name="gba", daemon=True)
        self._gba_thread.start()

    # ----------------------------------------------------------- detection
    def _detect(self, kf: int):
        """BoW candidates, then Sim(3) verification. Returns (candidate,
        s12, R12, t12, n_inliers), S12 mapping candidate-camera points into
        the current keyframe's camera, or None."""
        m = self.map
        # exclude the connected set: covisibility weight >= 15
        # (KeyFrameDatabase.cc:128,284 with KeyFrame.cc:499's threshold);
        # weakly covisible keyframes stay candidates
        exclude = set([kf]) | {c for c, w in m.covisibility(kf).items() if w >= 15}
        cands = self.kfdb.detect_candidates(self.kfdb.query_vector(kf), exclude, m, n_best=3)
        for cand in cands:
            if not m.kf_valid[cand]:
                continue
            # the candidate must not be too recent in the same map
            if m.kf_map_id[cand] == m.kf_map_id[kf] and abs(cand - kf) < 10:
                continue
            hit = self._verify_sim3(kf, cand)
            if hit is not None:
                return (cand,) + hit
        return None

    def _refine_pending(self, kf: int, p: dict):
        """DetectAndReffineSim3FromLastKF (LoopClosing.cc:716): carry a
        pending hypothesis' Sim(3) to the new keyframe through the relative
        motion since the hypothesis' keyframe, and demand >= 40 projection
        matches. Returns (cand, s12, R12, t12, n_proj) or None."""
        m = self.map
        cand, k0 = p["cand"], p["kf"]
        if not (m.kf_valid[cand] and m.kf_valid[k0]):
            return None
        s0, R0, t0 = p["sim3"]
        R_rel = m.kf_R[kf].astype(np.float64) @ m.kf_R[k0].astype(np.float64).T
        t_rel = m.kf_t[kf].astype(np.float64) - R_rel @ m.kf_t[k0].astype(np.float64)
        s1, R1, t1 = _np_sim3_mul(1.0, R_rel, t_rel, s0, np.asarray(R0, np.float64),
                                  np.asarray(t0, np.float64))
        n_proj = self._count_projection_matches(kf, cand, float(s1), R1, t1)
        if n_proj < 40:
            return None
        return cand, float(s1), R1, t1, int(n_proj)

    def _verify_sim3(self, kf: int, cand: int):
        """BoW-constrained matching of the two keyframes' map points, Sim(3)
        RANSAC, guided refinement (DetectCommonRegionsFromBoW: >= 20 BoW
        matches, >= 15 RANSAC inliers, >= 20 refined inliers,
        LoopClosing.cc:795-814), then >= 40 projection matches."""
        m = self.map
        node_q = self.kfdb.kf_node.get(kf)
        node_c = self.kfdb.kf_node.get(cand)
        if node_q is None or node_c is None:
            return None
        mp_q, mp_c = m.kf_feat_mp[kf], m.kf_feat_mp[cand]
        mask = ((node_q[:, None] == node_c[None, :]) & (node_q[:, None] >= 0)
                & (mp_q >= 0)[:, None] & (mp_c >= 0)[None, :])
        if mask.sum() < 10:
            return None
        T = self._t
        idx, _, ok = matching.search_by_window(
            convert.desc_tensor(m.kf_feat_desc[kf], self.device),
            convert.desc_tensor(m.kf_feat_desc[cand], self.device), T(mask),
            th=matching.TH_LOW, ratio=0.9)
        # rotation-histogram check (matcherBoW(0.9, true), LoopClosing.cc:816)
        ok = matching.rotation_consistency(T(m.kf_feat_angle[kf]), T(m.kf_feat_angle[cand]),
                                           idx, ok)
        idx_np = idx.cpu().numpy().astype(np.int64)
        ok_np = ok.cpu().numpy()
        if ok_np.sum() < 20:
            return None
        # the matched 3D points in each camera frame
        c_mp = mp_c[idx_np]
        pair_ok = ok_np & (mp_q >= 0) & (c_mp >= 0)
        pair_ok &= m.mp_valid[np.maximum(mp_q, 0)] & m.mp_valid[np.maximum(c_mp, 0)]
        Xq = m.mp_pos[np.maximum(mp_q, 0)] @ m.kf_R[kf].T + m.kf_t[kf]
        Xc = m.mp_pos[np.maximum(c_mp, 0)] @ m.kf_R[cand].T + m.kf_t[cand]
        lv_q, lv_c = m.kf_feat_level[kf], m.kf_feat_level[cand, idx_np]

        # bFixedScale (LoopClosing.cc:798-801): fixed except for pure mono;
        # mono-inertial fixes it once VIBA2 has made the map metric
        fix_scale = not self.cfg.is_mono
        if self.cfg.is_mono and self.cfg.is_inertial:
            fix_scale = bool(m.map_viba2.get(int(m.kf_map_id[kf]), False))
        Xq_t, Xc_t = T(Xq, torch.float32), T(Xc, torch.float32)
        lv_q_t, lv_c_t, ok_t = T(lv_q), T(lv_c), T(pair_ok)
        hyp = sim3_mod.draw_minimal_sets(ok_t, self.generator)
        s, R, t, _, n = sim3_mod.sim3_ransac(self.cam, Xq_t, Xc_t, lv_q_t, lv_c_t, ok_t, hyp,
                                             fix_scale=fix_scale)
        if int(n) < 15:
            return None
        s, R, t, _, n2 = sim3_mod.optimize_sim3(
            self.cam, s, R, t, Xq_t, T(m.kf_feat_xy[kf]), lv_q_t,
            Xc_t, T(m.kf_feat_xy[cand, idx_np]), lv_c_t, ok_t, fix_scale=fix_scale)
        fetched = torch.cat([s.reshape(1), R.reshape(-1), t, n2.reshape(1).to(s.dtype)]).cpu()
        s_np, R_np, t_np = float(fetched[0]), fetched[1:10].numpy().reshape(3, 3), fetched[10:13].numpy()
        if int(fetched[13]) < 20:
            return None
        # guided projection over the candidate's covisible window
        # (SearchByProjection / SearchBySim3, LoopClosing.cc:1062-1091)
        n_proj = self._count_projection_matches(kf, cand, s_np, R_np, t_np)
        if n_proj < 40:
            return None
        return s_np, R_np, t_np, int(fetched[13])

    def _spatial_verification(self, kf: int, cand: int, s12, R12, t12,
                              max_checks: int = 4, th: int = 40) -> int:
        """The number of the current keyframe's best covisible keyframes
        from which the composed Sim(3) still projects >= th points of the
        candidate window (LoopClosing.cc:1168-1250)."""
        m = self.map
        n_ok = 0
        for ki in m.covisible_kfs(kf, k=max_checks, min_weight=15):
            if not m.kf_valid[ki]:
                continue
            R_rel = m.kf_R[ki].astype(np.float64) @ m.kf_R[kf].astype(np.float64).T
            t_rel = m.kf_t[ki].astype(np.float64) - R_rel @ m.kf_t[kf].astype(np.float64)
            s1, R1, t1 = _np_sim3_mul(1.0, R_rel, t_rel, s12, np.asarray(R12, np.float64),
                                      np.asarray(t12, np.float64))
            if self._count_projection_matches(int(ki), cand, float(s1), R1, t1) >= th:
                n_ok += 1
        return n_ok

    def _fuse_project(self, kf: int, lp: programs.LocalPoints, R, t):
        """programs.fuse_project of the points `lp` seen from pose (R, t)
        into keyframe kf's features."""
        m, T = self.map, self._t
        return programs.fuse_project(
            self.cam, T(R, torch.float32), T(t, torch.float32), lp, T(m.kf_feat_xy[kf]),
            T(m.kf_feat_level[kf]), convert.desc_tensor(m.kf_feat_desc[kf], self.device),
            T(m.kf_feat_valid[kf]), T(m.kf_feat_mp[kf]),
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor)

    def _count_projection_matches(self, kf: int, cand: int, s12, R12, t12) -> int:
        """Project the candidate window's map points through S12 into the
        current keyframe's camera and count the window matches."""
        m = self.map
        window = [cand] + m.covisible_kfs(cand, k=10, min_weight=15)
        pts = m.local_point_ids(window, cap=self.cfg.local_points_cap)
        if len(pts) == 0:
            return 0
        # candidate-camera points into the current camera by S12, then into
        # a world for the current keyframe's pose (R^T (x - t))
        Xc_cam = m.mp_pos[pts] @ m.kf_R[cand].T + m.kf_t[cand]
        Xq_cam = s12 * (Xc_cam @ R12.T) + t12
        Rq, tq = m.kf_R[kf], m.kf_t[kf]
        R_comb = Rq.T @ R12 @ m.kf_R[cand]
        lp = self._local_points(pts, pos=(Xq_cam - tq) @ Rq, normal=m.mp_normal[pts] @ R_comb.T,
                                min_dist=m.mp_min_dist[pts] * s12,
                                max_dist=m.mp_max_dist[pts] * s12)
        _, ok, _ = self._fuse_project(kf, lp, Rq, tq)
        return int(ok[: len(pts)].sum())

    def _local_points(self, ids, **fields) -> programs.LocalPoints:
        """The map points `ids` as a LocalPoints view padded to
        local_points_cap, with `fields` in place of the map's values."""
        m = self.map
        cap = self.cfg.local_points_cap
        arrays = dict(pos=m.mp_pos[ids], desc=m.mp_desc[ids], normal=m.mp_normal[ids],
                      min_dist=m.mp_min_dist[ids], max_dist=m.mp_max_dist[ids],
                      valid=np.ones(len(ids), bool), angle=m.mp_angle[ids])
        arrays.update(fields)
        return convert.local_points_from_numpy({k: _pad(np.asarray(a), cap)
                                                for k, a in arrays.items()}, self.device)

    # ----------------------------------------------------------- correction
    def _correct_loop(self, kf: int, cand: int, s12, R12, t12):
        """CorrectLoop (LoopClosing.cc:1377): carry the Sim(3) correction to
        the current keyframe's covisible window, fuse duplicate points,
        optimize the essential graph, then a global BA."""
        m = self.map
        # corrected pose of the current keyframe: S12 S_cand_cw
        R_corr = R12 @ m.kf_R[cand].astype(np.float64)
        t_corr = s12 * (R12 @ m.kf_t[cand].astype(np.float64)) + t12
        # the world correction x_w' = dSw(x_w), dSw = S_corr^-1 S_old
        R_old, t_old = m.kf_R[kf].astype(np.float64), m.kf_t[kf].astype(np.float64)
        sw, Rw, tw = _np_sim3_mul(*_np_sim3_inv(s12, R_corr, t_corr), 1.0, R_old, t_old)

        window = [kf] + m.covisible_kfs(kf, k=30, min_weight=15)
        pts = m.local_point_ids(window, cap=10**9)
        # every pose and the strong covisibility links before the window
        # correction: the essential graph measures the spanning-tree and
        # earlier covisibility edges from uncorrected poses
        # (Optimizer.cc:4527 NonCorrectedSim3)
        with m.lock:  # the window's correction is atomic for the tracker
            pre_R, pre_t = m.kf_R.copy(), m.kf_t.copy()
            pre_pairs, _ = m.covisibility_edges(min_weight=100)
            pre_keys = pre_pairs[:, 0] * m.kf_R.shape[0] + pre_pairs[:, 1]

            # window keyframes S_i' = S_i dSw^-1, points p' = dSw(p)
            swi, Rwi, twi = _np_sim3_inv(sw, Rw, tw)
            for k in window:
                R_before = m.kf_R[k].astype(np.float64)
                sk, Rk, tk = _np_sim3_mul(1.0, R_before, m.kf_t[k].astype(np.float64), swi, Rwi,
                                          twi)
                m.kf_R[k] = Rk.astype(np.float32)
                m.kf_t[k] = (tk / sk).astype(np.float32)  # the scale into the translation
                # the world-frame velocity follows the correction (Rcor,
                # LoopClosing.cc:1552), scaled by sw = 1/sk
                m.kf_vel[k] = ((Rk.T @ R_before @ m.kf_vel[k].astype(np.float64)) / float(sk)
                               ).astype(np.float32)
            m.mp_pos[pts] = (sw * (m.mp_pos[pts].astype(np.float64) @ Rw.T) + tw
                             ).astype(np.float32)

        # fuse: the loop side's points into the corrected window
        loop_window = [cand] + m.covisible_kfs(cand, k=20, min_weight=15)
        self._fuse_points_into(window, m.local_point_ids(loop_window, cap=self.cfg.local_points_cap))
        self._optimize_essential_graph(kf, cand, pre_R, pre_t, pre_keys)
        # whole-map BA (RunGlobalBundleAdjustment, LoopClosing.cc:3067);
        # inertial maps take FullInertialBA (:1669)
        mid = int(m.kf_map_id[kf])
        if self.cfg.is_inertial and m.map_imu_init.get(mid, False):
            if len(m.kf_ids(mid)) < 200:
                self._launch_gba(self.mapper.full_inertial_ba, iters=7)
        else:
            self._launch_gba(self.mapper.global_ba, iters=10)
        m.version += 1

    def _merge_maps(self, kf: int, cand: int, s12, R12, t12):
        """MergeLocal (LoopClosing.cc:1697): move the active map into the
        candidate's (older) map frame, relabel it, fuse the weld window,
        then a welding BA and the merge variant of the essential graph."""
        m = self.map
        active = int(m.kf_map_id[kf])
        target = int(m.kf_map_id[cand])
        # dSw maps active-map world coordinates into the target's world
        R_old, t_old = m.kf_R[kf].astype(np.float64), m.kf_t[kf].astype(np.float64)
        R_corr = R12 @ m.kf_R[cand].astype(np.float64)
        t_corr = s12 * (R12 @ m.kf_t[cand].astype(np.float64)) + t12
        sw, Rw, tw = _np_sim3_mul(*_np_sim3_inv(s12, R_corr, t_corr), 1.0, R_old, t_old)

        inertial = self.cfg.is_inertial and m.map_imu_init.get(active, False)
        # MergeLocal2 (the inertial weld, LoopClosing.cc:2451) needs both
        # maps IMU-initialized
        both_inertial = inertial and m.map_imu_init.get(target, False)
        if both_inertial:
            # both worlds are gravity-aligned: a rotation about gravity only,
            # unit scale once both are metric, and the translation re-anchored
            # so that the current keyframe lands on its verified pose
            c_old = -(R_old.T @ t_old)
            c_target = sw * (Rw @ c_old) + tw
            yaw = math.atan2(Rw[1, 0], Rw[0, 0])
            cy, sy = math.cos(yaw), math.sin(yaw)
            Rw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]], np.float64)
            if m.map_viba1.get(active, False) and m.map_viba1.get(target, False):
                sw = 1.0
            tw = c_target - sw * (Rw @ c_old)

        # the weld transform on the whole map (Map::ApplyScaledRotation)
        m.apply_transform(active, float(sw), Rw.astype(np.float32), tw.astype(np.float32))
        with m.lock:  # the relabel is atomic for the tracker
            kfs = m.kf_ids(active)
            m.kf_map_id[kfs] = target
            m.mp_map_id[m.mp_ids(active)] = target
            m.active_map = int(target)
            if both_inertial:
                # MergeLocal2 sets ImuInitialized / BA1 / BA2 on the merged
                # map (LoopClosing.cc:2560-2574)
                m.map_imu_init[target] = m.map_viba1[target] = m.map_viba2[target] = True

        # poses and links after the weld transform, before the weld BA
        # (NonCorrectedSim3 of Optimizer.cc:5683)
        absorbed = {int(k) for k in kfs}
        with m.lock:
            pre_R, pre_t = m.kf_R.copy(), m.kf_t.copy()
            pre_pairs, _ = m.covisibility_edges(min_weight=100)
            pre_keys = pre_pairs[:, 0] * m.kf_R.shape[0] + pre_pairs[:, 1]

        window = [kf] + m.covisible_kfs(kf, k=15, min_weight=15)
        loop_window = [cand] + m.covisible_kfs(cand, k=15, min_weight=15)
        self._fuse_points_into(window, m.local_point_ids(loop_window, cap=self.cfg.local_points_cap))
        if both_inertial:
            self.mapper.merge_inertial_ba(kf, cand)
        else:
            self.mapper.local_ba(kf)
        # the merge variant of the essential graph (Optimizer.cc:5683): the
        # target map's keyframes and the weld window stay fixed; the rest of
        # the absorbed map follows through the graph
        fixed_ids = ({int(k) for k in m.kf_ids(target)} - absorbed) | {int(w) for w in window}
        self._optimize_essential_graph(kf, cand, pre_R, pre_t, pre_keys, fixed_ids=fixed_ids)
        m.version += 1

    def _fuse_points_into(self, kf_window, point_ids):
        """SearchAndFuse (LoopClosing.cc:2895): project `point_ids` into each
        window keyframe and merge the duplicates, the loop side's point
        winning."""
        m = self.map
        if len(point_ids) == 0:
            return
        ids = np.asarray(point_ids)[: self.cfg.local_points_cap]
        lp = self._local_points(ids)
        for nb in kf_window:
            fidx, ok, ex = self._fuse_project(nb, lp, m.kf_R[nb], m.kf_t[nb])
            fetched = torch.stack([fidx.to(torch.int64), ok.to(torch.int64),
                                   ex.to(torch.int64)]).cpu().numpy()[:, : len(ids)]
            fidx, ok_np, ex = fetched
            for j in np.nonzero(ok_np)[0]:
                mp = int(ids[j])
                if not m.mp_valid[mp]:
                    continue
                if ex[j] >= 0 and ex[j] != mp and m.mp_valid[ex[j]]:
                    m.replace_point(int(ex[j]), mp)
                elif ex[j] < 0:
                    m.add_observation(mp, int(nb), int(fidx[j]))

    def _optimize_essential_graph(self, kf: int, cand: int, pre_R=None, pre_t=None,
                                  pre_keys=None, fixed_ids=None):
        """The essential graph: spanning tree, strong covisibility (weight
        >= 100), the links born in the loop fusion, and the loop edge
        (Optimizer.cc:4527 loop variant; :5683 merge variant through
        fixed_ids). Spanning-tree and earlier covisibility edges are
        measured from the uncorrected poses, new links and the loop edge
        from the current ones; the vertices start at the current poses, the
        gauge anchors are fixed_ids (default: the loop-side keyframe)."""
        m = self.map
        kfs = m.kf_ids()
        if len(kfs) < 4:
            return
        if pre_R is None:
            pre_R, pre_t = m.kf_R, m.kf_t
        if pre_keys is None:
            pre_keys = np.empty(0, np.int64)
        if fixed_ids is None:
            fixed_ids = {int(cand)}
        N = m.kf_R.shape[0]
        K = len(kfs)
        slot_arr = np.full(N, -1, np.int64)
        slot_arr[np.asarray(kfs)] = np.arange(K)

        # spanning-tree edges (measured before the correction)
        kfs_np = np.asarray(kfs, np.int64)
        par = m.kf_parent[kfs_np].astype(np.int64)
        tree_ok = (par >= 0) & (slot_arr[np.maximum(par, 0)] >= 0)
        ta_, tb_ = kfs_np[tree_ok], par[tree_ok]
        tree_keys = np.minimum(ta_, tb_) * N + np.maximum(ta_, tb_)

        # strong covisibility edges, less those of the tree
        pairs, _ = m.covisibility_edges(min_weight=100)
        pairs = pairs[(slot_arr[pairs[:, 0]] >= 0) & (slot_arr[pairs[:, 1]] >= 0)]
        ckeys = pairs[:, 0] * N + pairs[:, 1]
        pairs, ckeys = pairs[~np.isin(ckeys, tree_keys)], ckeys[~np.isin(ckeys, tree_keys)]
        born_new = ~np.isin(ckeys, pre_keys)  # links born in the loop fusion

        ea = np.concatenate([ta_, pairs[:, 0], [int(kf)]]).astype(np.int64)
        eb = np.concatenate([tb_, pairs[:, 1], [int(cand)]]).astype(np.int64)
        use_corr = np.concatenate([np.zeros(len(ta_), bool), born_new, np.ones(1, bool)])
        ew = np.concatenate([np.ones(len(ta_) + len(pairs), np.float32),
                             np.asarray([10.0], np.float32)])  # the loop / merge edge

        # relative measurements S_ab = S_a S_b^-1 (unit scale)
        pick = lambda cur, pre, e: np.where(use_corr.reshape((-1,) + (1,) * (cur.ndim - 1)),
                                            cur[e], pre[e]).astype(np.float64)
        Ra, Rb = pick(m.kf_R, pre_R, ea), pick(m.kf_R, pre_R, eb)
        ta, tb = pick(m.kf_t, pre_t, ea), pick(m.kf_t, pre_t, eb)
        R_rel = np.einsum("kij,klj->kil", Ra, Rb)
        t_rel = ta - np.einsum("kij,kj->ki", R_rel, tb)

        E = len(ea)
        prob = convert.pose_graph_from_numpy(dict(
            s=np.ones(K, np.float32), R=m.kf_R[kfs], t=m.kf_t[kfs],
            fixed=np.array([int(k) in fixed_ids for k in kfs]),
            e_i=slot_arr[ea], e_j=slot_arr[eb], e_s=np.ones(E, np.float32),
            e_R=R_rel, e_t=t_rel, e_valid=np.ones(E, bool), e_weight=ew,
        ), self.device)
        s, R, t, _ = posegraph.solve_pose_graph(
            prob, iters=15, dof4=self.cfg.is_inertial and m.map_viba2.get(m.active_map, False))
        flat = torch.cat([s, R.reshape(-1), t.reshape(-1)]).cpu().numpy()
        s, R, t = flat[:K], flat[K:10 * K].reshape(K, 3, 3), flat[10 * K:].reshape(K, 3)
        with m.lock:  # the pose-graph write-back is atomic for the tracker
            # write back Tcw = [R | t/s]; the velocity follows the
            # correction, scaled by 1/s (LoopClosing.cc:1552)
            old_R, old_t = m.kf_R[kfs].copy(), m.kf_t[kfs].copy()
            m.kf_vel[kfs] = ((R.transpose(0, 2, 1) @ old_R @ m.kf_vel[kfs][..., None])[..., 0]
                             / s[:, None]).astype(np.float32)
            m.kf_R[kfs] = R
            m.kf_t[kfs] = t / s[:, None]
            # points through their first observing keyframe's correction:
            # p' = Snew^-1 Told p (Optimizer.cc:4836-4870)
            pts = m.mp_ids()
            i = slot_arr[m.mp_first_kf[pts]]
            pts, i = pts[i >= 0], i[i >= 0]
            pc = (np.einsum("kij,kj->ki", old_R[i].astype(np.float64),
                            m.mp_pos[pts].astype(np.float64)) + old_t[i].astype(np.float64))
            m.mp_pos[pts] = np.einsum("kji,kj->ki", R[i].astype(np.float64),
                                      (pc - t[i]) / s[i][:, None]).astype(np.float32)
            m.update_point_geometry(pts)


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a[:n]
    return out


def _np_sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _np_sim3_inv(s, R, t):
    si = 1.0 / s
    return si, R.T, -si * (R.T @ t)
