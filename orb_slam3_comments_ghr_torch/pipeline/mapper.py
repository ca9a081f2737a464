"""Local mapping: per-keyframe map building, visual path.

Port of `orb_slam3_comments_ghr_tpu/pipeline/mapper.py` without its
inertial, merge and full-map branches (LocalMapping Run(), reference
src/LocalMapping.cc:92): point culling, triangulation of new points against
the covisible neighbours, projection fuse into them, windowed local BA and
keyframe culling. The map stays host numpy; the programs (epipolar match and
triangulation, fuse, BA) run on the mapper's device (the card unless the
caller passes `device="cpu"`), and each comes back to the host in one copy
per result.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..map.state import MapState
from ..ops import cameras
from ..optim import ba
from ..utils.config import SlamConfig
from ..utils.device import resolve_device
from . import programs


def _pad_pow2(n: int, lo: int, hi: int) -> int:
    """Round up to a power-of-two bucket (bounded problem shapes)."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


class LocalMapper:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb=None, device=None):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb
        self.device = resolve_device(device)
        self.recent_mps: list[tuple[int, int]] = []  # (mp_id, birth_kf)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int):
        self.cull_map_points(kf)
        self.create_new_points(kf)
        self.fuse_neighbors(kf)
        if len(self.map.kf_ids()) > 2:
            self.local_ba(kf)
        self.cull_keyframes(kf)

    # ------------------------------------------------------------- cull MPs
    def cull_map_points(self, current_kf: int):
        """MapPointCulling (LocalMapping.cc:471): kill low found-ratio or
        under-observed young points; graduate survivors after 3 KFs."""
        m = self.map
        keep = []
        for mp, birth in self.recent_mps:
            if not m.mp_valid[mp]:
                continue
            age = current_kf - birth
            ratio = m.mp_found[mp] / max(m.mp_visible[mp], 1.0)
            if ratio < self.cfg.mp_cull_found_ratio:
                m.remove_point(mp)
            elif age >= 2 and m.mp_n_obs[mp] <= 2:
                m.remove_point(mp)
            elif age >= 3:
                continue  # graduated
            else:
                keep.append((mp, birth))
        self.recent_mps = keep

    # ------------------------------------------------------ new points (tri)
    def create_new_points(self, kf: int):
        """CreateNewMapPoints (LocalMapping.cc:526): for each covisible
        neighbour, epipolar-match unassociated features and triangulate."""
        m = self.map
        cfg = self.cfg
        neighbors = m.covisible_kfs(kf, k=cfg.triangulation_neighbors, min_weight=5)
        if not neighbors:
            return
        R1, t1 = m.kf_R[kf], m.kf_t[kf]
        c1 = -R1.T @ t1

        # baseline gate per neighbour (mono: baseline/medianDepth > 0.01)
        usable = []
        for nb in neighbors:
            R2, t2 = m.kf_R[nb], m.kf_t[nb]
            mids = m.kf_feat_mp[nb]
            mp_ids = mids[mids >= 0]
            if len(mp_ids) == 0:
                continue
            depths = (m.mp_pos[mp_ids] @ R2.T + t2)[:, 2]
            med_depth = float(np.median(depths)) if len(depths) else 1.0
            if np.linalg.norm(c1 + R2.T @ t2) / max(med_depth, 1e-6) >= 0.01:
                usable.append(nb)
        if not usable:
            return

        usable = usable[: cfg.triangulation_neighbors]
        nbs = np.asarray(usable)
        free1 = m.kf_feat_valid[kf] & (m.kf_feat_mp[kf] < 0)
        free2s = m.kf_feat_valid[nbs] & (m.kf_feat_mp[nbs] < 0)
        T, D = self._tensor, lambda a: convert.desc_tensor(a, self.device)
        idxs, Xs, goods = programs.map_new_points_multi(
            self.cam,
            D(m.kf_feat_desc[kf]), T(m.kf_feat_xy[kf]), T(m.kf_feat_level[kf]),
            T(m.kf_feat_ur[kf]), T(free1), T(R1), T(t1),
            D(m.kf_feat_desc[nbs]), T(m.kf_feat_xy[nbs]), T(m.kf_feat_level[nbs]),
            T(m.kf_feat_ur[nbs]), T(free2s), T(m.kf_R[nbs]), T(m.kf_t[nbs]),
            scale=cfg.scale_factor,
        )
        idxs, Xs, goods = idxs.cpu().numpy(), Xs.cpu().numpy(), goods.cpu().numpy()
        claimed = np.zeros(m.cfg.n_feat, bool)  # one new point per feature
        all_new = []
        for b, nb in enumerate(usable):
            gi = np.nonzero(goods[b] & ~claimed)[0]
            if len(gi) == 0:
                continue
            claimed[gi] = True
            ids = m.add_map_points(Xs[b][gi], m.kf_feat_desc[kf][gi], kf, gi)
            got = np.nonzero(ids >= 0)[0]
            m.add_observations(ids[got], int(nb), idxs[b][gi[got]])
            self.recent_mps.extend((int(mp), kf) for mp in ids[got])
            all_new.extend(int(x) for x in ids[got])
        if all_new:
            m.update_point_geometry(np.asarray(all_new))

    # ----------------------------------------------------------------- fuse
    def fuse_neighbors(self, kf: int):
        """SearchInNeighbors (LocalMapping.cc:939): project the current KF's
        points into its neighbours and fuse duplicates."""
        m = self.map
        neighbors = m.covisible_kfs(kf, k=self.cfg.triangulation_neighbors, min_weight=5)
        mids = m.kf_feat_mp[kf]
        ids = mids[mids >= 0]
        if len(ids) == 0 or not neighbors:
            return
        cap = self.cfg.local_points_cap
        ids = ids[:cap]
        lp = convert.local_points_from_map(m, ids, cap, self.device)
        nbs = np.asarray(neighbors[: self.cfg.triangulation_neighbors])
        T = self._tensor
        fidxs, oks, exs = programs.fuse_project_multi(
            self.cam, T(m.kf_R[nbs]), T(m.kf_t[nbs]), lp,
            T(m.kf_feat_xy[nbs]), T(m.kf_feat_level[nbs]),
            convert.desc_tensor(m.kf_feat_desc[nbs], self.device),
            T(m.kf_feat_valid[nbs]), T(m.kf_feat_mp[nbs]),
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
        )
        fidxs, oks, exs = (torch.stack([fidxs, oks.to(fidxs.dtype), exs.to(fidxs.dtype)])
                           .cpu().numpy())
        oks = oks.astype(bool)
        idv = np.asarray(ids)
        for b, nb in enumerate(nbs):
            fidx = fidxs[b]
            ok_np = oks[b][: len(ids)]
            ex = exs[b][: len(ids)]
            # duplicates first (rare): keep the point with more observations
            for j in np.nonzero(ok_np & (ex >= 0) & (ex != idv))[0]:
                mp, e = int(idv[j]), int(ex[j])
                if m.mp_valid[mp] and m.mp_valid[e]:
                    if m.mp_n_obs[mp] >= m.mp_n_obs[e]:
                        m.replace_point(e, mp)
                    else:
                        m.replace_point(mp, e)
            # then batch the plain extensions into the neighbour
            add = np.nonzero(ok_np & (ex < 0) & m.mp_valid[idv])[0]
            m.add_observations(idv[add], int(nb), fidx[add])
        m.update_point_geometry(ids)

    # ------------------------------------------------------------- local BA
    def local_ba(self, kf: int):
        """LocalBundleAdjustment (Optimizer.cc:1758): the KF and its
        covisible KFs optimized, their other observers fixed."""
        m = self.map
        cfg = self.cfg
        opt_kfs = [kf] + m.covisible_kfs(kf, k=cfg.local_ba_kfs - 1, min_weight=5)
        pts = m.local_point_ids(opt_kfs, cfg.local_ba_points)
        self._run_ba(opt_kfs, pts, cfg.local_ba_iters)

    def _run_ba(self, opt_kfs, pts, iters: int):
        m = self.map
        cfg = self.cfg
        opt_kfs = list(dict.fromkeys(int(k) for k in opt_kfs))
        opt_set = set(opt_kfs)
        if len(pts) < 8:
            return
        # fixed observers
        fixed = [int(k) for k in np.unique(m.mp_obs_kf[pts]) if k >= 0 and int(k) not in opt_set]
        fixed = fixed[: cfg.local_ba_fixed_cap]
        # gauge-fix: pin the oldest KF when nothing else anchors the window
        if not fixed:
            anchor = min(opt_kfs)
            fixed = [anchor] + fixed
            opt_kfs = [k for k in opt_kfs if k != anchor]
        cam_ids = opt_kfs + fixed
        cam_slot = {c: i for i, c in enumerate(cam_ids)}
        K = _pad_pow2(len(cam_ids), 8, 256)
        P = _pad_pow2(len(pts), 256, cfg.local_ba_points)
        D = m.cfg.obs_cap

        cam_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        cam_t = np.zeros((K, 3), np.float32)
        cam_fixed = np.ones((K,), bool)
        p = np.zeros((P, 3), np.float32)
        p_valid = np.zeros((P,), bool)
        for c, i in cam_slot.items():
            cam_R[i] = m.kf_R[c]
            cam_t[i] = m.kf_t[c]
        cam_fixed[: len(opt_kfs)] = False
        p[: len(pts)] = m.mp_pos[pts]
        p_valid[: len(pts)] = True
        obs_cam, obs_uv, obs_ur, obs_level, obs_valid = _build_obs_tables(m, pts, cam_slot, P)
        prob = convert.ba_problem_from_numpy(dict(
            cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed, p=p, p_valid=p_valid,
            obs_cam=obs_cam, obs_uv=obs_uv, obs_ur=obs_ur, obs_level=obs_level,
            obs_valid=obs_valid,
        ), device=self.device)
        Rn, tn, pn, inlier, _ = ba.bundle_adjust(self.cam, prob, iters=iters)
        Rn, tn, pn, inlier = (x.cpu().numpy() for x in (Rn, tn, pn, inlier))
        for c in opt_kfs:
            i = cam_slot[c]
            m.kf_R[c] = Rn[i]
            m.kf_t[c] = tn[i]
        m.mp_pos[pts] = pn[: len(pts)]
        # erase outlier observations (Optimizer.cc:2100-2160 post-pass)
        for j, srow in np.argwhere(obs_valid[: len(pts)] & ~inlier[: len(pts)]):
            c = m.mp_obs_kf[pts[j], srow]
            if c >= 0:
                m.remove_observation(int(pts[j]), int(c))
        m.version += 1

    # ------------------------------------------------------------- cull KFs
    def cull_keyframes(self, kf: int):
        """KeyFrameCulling (LocalMapping.cc:1197): a covisible KF is redundant
        if > 90 % of its points are seen by >= 3 other KFs at the same or a
        finer octave (+1)."""
        m = self.map
        for cand in m.covisible_kfs(kf, k=10, min_weight=5):
            if cand == kf or not m.kf_valid[cand]:
                continue
            if m.kf_parent[cand] < 0:
                continue  # never cull the map-origin KF (GetInitKFid guard)
            mids = m.kf_feat_mp[cand]
            slots = np.nonzero(mids >= 0)[0]
            if len(slots) < 20:
                continue
            redundant = 0
            for fi in slots:
                mp = mids[fi]
                lvl = m.kf_feat_level[cand, fi]
                n_better = 0
                for s in range(m.cfg.obs_cap):
                    okf = m.mp_obs_kf[mp, s]
                    if okf < 0 or okf == cand:
                        continue
                    if m.kf_feat_level[okf, m.mp_obs_idx[mp, s]] <= lvl + 1:
                        n_better += 1
                if n_better >= 3:
                    redundant += 1
            if redundant > self.cfg.kf_cull_redundancy * len(slots):
                m.remove_keyframe(cand)
                if self.kfdb is not None:
                    self.kfdb.erase(cand)


def _build_obs_tables(m: MapState, pts, cam_slot, P):
    """The padded (P, D) observation tables of a visual BA problem over the
    points `pts`, observations of cameras outside `cam_slot` masked out.
    Returns (obs_cam, obs_uv, obs_ur, obs_level, obs_valid)."""
    D = m.cfg.obs_cap
    obs_cam = np.zeros((P, D), np.int32)
    obs_uv = np.zeros((P, D, 2), np.float32)
    obs_ur = np.full((P, D), -1.0, np.float32)
    obs_level = np.zeros((P, D), np.int32)
    obs_valid = np.zeros((P, D), bool)
    _fill_obs_table(m, pts, cam_slot, obs_cam, obs_uv, obs_ur, obs_level, obs_valid)
    return obs_cam, obs_uv, obs_ur, obs_level, obs_valid


def _fill_obs_table(m, pts, cam_slot, obs_cam, obs_uv, obs_ur, obs_level, obs_valid):
    """Vectorized observation-table fill: the observation table indexes
    straight into the problem arrays, no per-(point, slot) Python loop."""
    p = len(pts)
    if p == 0:
        return obs_cam, obs_uv, obs_ur, obs_level, obs_valid
    lookup = np.full(m.cfg.max_kf, -1, np.int32)
    for c, i in cam_slot.items():
        lookup[c] = i
    kf_tab = m.mp_obs_kf[pts]            # (p, D)
    idx_tab = m.mp_obs_idx[pts]
    valid_tab = kf_tab >= 0
    kf_safe = np.maximum(kf_tab, 0)
    idx_safe = np.maximum(idx_tab, 0)
    slots = np.where(valid_tab, lookup[kf_safe], -1)
    use = valid_tab & (slots >= 0)
    obs_cam[:p] = np.where(use, slots, 0)
    obs_uv[:p] = np.where(use[..., None], m.kf_feat_xy[kf_safe, idx_safe], 0.0)
    obs_ur[:p] = np.where(use, m.kf_feat_ur[kf_safe, idx_safe], -1.0)
    obs_level[:p] = np.where(use, m.kf_feat_level[kf_safe, idx_safe], 0)
    obs_valid[:p] = use
    return obs_cam, obs_uv, obs_ur, obs_level, obs_valid
