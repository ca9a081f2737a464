"""Map data model: fixed-capacity structure-of-arrays store.

Replaces the reference's pointer-graph map (KeyFrame/MapPoint objects with
per-object mutexes, src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc) with flat
numpy SoA pools owned by a single host writer (SURVEY.md §2.3 P4: versioned
snapshots instead of locks). Device programs receive compact views (local
point blocks, BA windows) and return updates; all bookkeeping lives here.

Capacities are fixed at construction; `alive` masks replace deletion
(SetBadFlag). The observation table mp_obs (M, OBS_CAP) is the single source
of truth for point<->keyframe incidence; covisibility weights are derived
from it on demand (KeyFrame::UpdateConnections computes the same counts from
MapPoint::GetObservations, KeyFrame.h:222).

Copied from `orb_slam3_comments_ghr_tpu/map/state.py` (numpy
only), so the port needs no JAX. One deliberate divergence (ROADMAP C6):
`replace_point` carries the old point's right-camera rows into the slots the
new point gains, where the JAX package drops them; maps without a rig are
unchanged by it.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional

import numpy as np


def _locked(fn):
    """Serialize a mutating MapState method against concurrent access.

    The async mapping worker (SURVEY §2.3 P1) mutates the SoA pools while
    the tracking thread reads multi-array slices; every mutator runs under
    the store's RLock, and readers that need a CONSISTENT multi-array view
    take the same lock around their (short, numpy-only) slicing. Device
    compute never runs under the lock, so pipeline overlap is preserved —
    this is the reference's mMutexMapUpdate discipline (Map.h:139) scoped
    down to host bookkeeping."""

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self.lock:
            return fn(self, *a, **kw)

    return wrapper


@dataclasses.dataclass
class MapConfig:
    max_kf: int = 512
    max_mp: int = 40000
    n_feat: int = 1024
    obs_cap: int = 16          # max keyframes observing one point
    scale_factor: float = 1.2
    n_levels: int = 8


class MapState:
    """One Atlas worth of SLAM state. `map_id` partitions sub-maps; the active
    map is selected by id (Atlas semantics, src/Atlas.cc)."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.lock = threading.RLock()  # see _locked
        K, M, N, D = cfg.max_kf, cfg.max_mp, cfg.n_feat, cfg.obs_cap

        # --- keyframes ---
        self.kf_R = np.zeros((K, 3, 3), np.float32)     # world->cam
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_vel = np.zeros((K, 3), np.float32)      # body velocity (world)
        self.kf_bias = np.zeros((K, 6), np.float32)     # [bg, ba]
        self.kf_time = np.zeros((K,), np.float64)
        self.kf_valid = np.zeros((K,), bool)
        self.kf_map_id = np.full((K,), -1, np.int32)
        self.kf_parent = np.full((K,), -1, np.int32)    # spanning tree
        self.kf_prev = np.full((K,), -1, np.int32)      # temporal chain (IMU)
        self.kf_next = np.full((K,), -1, np.int32)
        # relative pose to the parent, frozen at cull time (mTcp,
        # KeyFrame.h:392) — used by trajectory export to walk bad-KF chains
        self.kf_Tcp = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))

        # per-KF features (copied from the Frame at insertion)
        self.kf_feat_xy = np.zeros((K, N, 2), np.float32)
        self.kf_feat_level = np.zeros((K, N), np.int32)
        self.kf_feat_angle = np.zeros((K, N), np.float32)
        self.kf_feat_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_feat_ur = np.full((K, N), -1.0, np.float32)
        self.kf_feat_depth = np.full((K, N), -1.0, np.float32)
        self.kf_feat_mp = np.full((K, N), -1, np.int32)  # feature -> map point

        # --- map points ---
        self.mp_pos = np.zeros((M, 3), np.float32)
        self.mp_desc = np.zeros((M, 8), np.uint32)
        # keypoint angle of the distinctive descriptor's observation — used
        # for the rotation-histogram consistency check when tracking against
        # local map points (the analog of comparing against the last frame's
        # keypoint angles, ORBmatcher.cc:2077)
        self.mp_angle = np.zeros((M,), np.float32)
        self.mp_normal = np.zeros((M, 3), np.float32)
        self.mp_min_dist = np.zeros((M,), np.float32)
        self.mp_max_dist = np.zeros((M,), np.float32)
        self.mp_valid = np.zeros((M,), bool)
        self.mp_map_id = np.full((M,), -1, np.int32)
        self.mp_first_kf = np.full((M,), -1, np.int32)
        # the map version at which the point now in the slot was made: a
        # reader holding ids from version v keeps only slots born <= v
        # (a slot freed by remove_point is reused by a later point)
        self.mp_born = np.zeros((M,), np.int64)
        self.mp_n_obs = np.zeros((M,), np.int32)
        self.mp_found = np.zeros((M,), np.float32)      # found/visible stats
        self.mp_visible = np.zeros((M,), np.float32)
        self.mp_obs_kf = np.full((M, D), -1, np.int32)
        self.mp_obs_idx = np.full((M, D), -1, np.int32)
        # second-camera (fisheye-stereo right view) observation per slot —
        # the reference stores observations as (leftIndex, rightIndex)
        # tuples (KeyFrame.h mObservations, Frame.cc:1546) and constrains
        # right views with dedicated body-frame edges
        # (OptimizableTypes.h:96-160). Here the right obs rides the SAME
        # slot as its left sibling: uv in LEFT-pinhole-equivalent pixels,
        # level = right keypoint octave, -1 = no right observation.
        self.mp_obs_r_uv = np.zeros((M, D, 2), np.float32)
        self.mp_obs_r_level = np.full((M, D), -1, np.int32)
        # cam0->right-camera extrinsics (R_rl, t_rl): x_r = R_rl x_l + t_rl;
        # set by the fisheye-stereo entry point, None for single-camera rigs
        self.rig = None

        self.n_kf = 0            # next keyframe slot (monotonic)
        self.n_mp = 0            # high-water mark for map points
        self._mp_free: list[int] = []
        self.active_map = 0
        self.n_maps = 1
        self.version = 0         # bumped on every structural mutation
        self.n_kf_removed = 0    # diagnostics: total keyframes invalidated
        # per-map inertial flags (Map::IsInertial / IniertialBA1/2)
        self.map_imu_init: dict[int, bool] = {0: False}
        self.map_viba1: dict[int, bool] = {0: False}
        self.map_viba2: dict[int, bool] = {0: False}

    # ------------------------------------------------------------------ kfs
    def _grow_kf_pool(self):
        """Double every keyframe-indexed array. The pools are host numpy —
        device programs receive fixed-size *views*, so growth never re-jits;
        it replaces the reference's unbounded heap allocation."""
        old = self.cfg.max_kf
        new = old * 2
        for name, arr in list(self.__dict__.items()):
            if name.startswith("kf_") and isinstance(arr, np.ndarray) and arr.shape[:1] == (old,):
                ext = np.zeros((new,) + arr.shape[1:], arr.dtype)
                if name in ("kf_parent", "kf_prev", "kf_next", "kf_map_id"):
                    ext.fill(-1)
                elif name == "kf_feat_mp":
                    ext.fill(-1)
                elif name in ("kf_feat_ur", "kf_feat_depth"):
                    ext.fill(-1.0)
                elif name == "kf_Tcp":
                    ext[:] = np.eye(4, dtype=np.float32)
                ext[:old] = arr
                setattr(self, name, ext)
        self.cfg.max_kf = new

    def _grow_mp_pool(self):
        old = self.cfg.max_mp
        new = old * 2
        for name, arr in list(self.__dict__.items()):
            if name.startswith("mp_") and isinstance(arr, np.ndarray) and arr.shape[:1] == (old,):
                ext = np.zeros((new,) + arr.shape[1:], arr.dtype)
                if name in ("mp_map_id", "mp_first_kf", "mp_obs_kf", "mp_obs_idx"):
                    ext.fill(-1)
                ext[:old] = arr
                setattr(self, name, ext)
        self.cfg.max_mp = new

    @_locked
    def add_keyframe(self, R, t, feats, timestamp, vel=None, bias=None,
                     parent=-1, prev=-1) -> int:
        """feats: dict-like with numpy arrays xy, level, angle, desc, valid,
        u_right, depth (Frame features)."""
        k = self.n_kf
        if k >= self.cfg.max_kf:
            self._grow_kf_pool()
        self.kf_R[k] = R
        self.kf_t[k] = t
        if vel is not None:
            self.kf_vel[k] = vel
        if bias is not None:
            self.kf_bias[k] = bias
        self.kf_time[k] = timestamp
        self.kf_valid[k] = True
        self.kf_map_id[k] = self.active_map
        self.kf_parent[k] = parent
        self.kf_prev[k] = prev
        if prev >= 0:
            self.kf_next[prev] = k
        n = feats["xy"].shape[0]
        self.kf_feat_xy[k, :n] = feats["xy"]
        self.kf_feat_level[k, :n] = feats["level"]
        self.kf_feat_angle[k, :n] = feats["angle"]
        self.kf_feat_desc[k, :n] = feats["desc"]
        self.kf_feat_valid[k, :n] = feats["valid"]
        self.kf_feat_ur[k, :n] = feats["u_right"]
        self.kf_feat_depth[k, :n] = feats["depth"]
        self.n_kf = k + 1
        self.version += 1
        return k

    @_locked
    def remove_keyframe(self, kf: int):
        """SetBadFlag for keyframes (KeyFrame.cc): drop its observations,
        reconnect the temporal chain, and freeze the relative-to-parent
        transform mTcp so trajectory export can walk through culled KFs
        (KeyFrame.cc SetBadFlag: mTcp = Tcw * parent->GetPoseInverse())."""
        for slot in np.nonzero(self.kf_feat_mp[kf] >= 0)[0]:
            self.remove_observation(int(self.kf_feat_mp[kf, slot]), kf)
        self.kf_feat_mp[kf] = -1
        self.kf_valid[kf] = False
        self.n_kf_removed += 1
        p = int(self.kf_parent[kf])
        if p >= 0:
            T_c = np.eye(4, dtype=np.float32)
            T_c[:3, :3] = self.kf_R[kf]
            T_c[:3, 3] = self.kf_t[kf]
            T_p_inv = np.eye(4, dtype=np.float32)
            T_p_inv[:3, :3] = self.kf_R[p].T
            T_p_inv[:3, 3] = -self.kf_R[p].T @ self.kf_t[p]
            self.kf_Tcp[kf] = T_c @ T_p_inv
        pv, nx = self.kf_prev[kf], self.kf_next[kf]
        if pv >= 0:
            self.kf_next[pv] = nx
        if nx >= 0:
            self.kf_prev[nx] = pv
        # re-parent only LIVE children; already-culled KFs keep their frozen
        # parent pointer so the Tcp chain stays consistent
        child_mask = (self.kf_parent == kf) & self.kf_valid
        self.kf_parent[child_mask] = self.kf_parent[kf]
        self.version += 1

    # ------------------------------------------------------------------ mps
    @_locked
    def add_map_points(self, pos, desc, first_kf, feat_idx) -> np.ndarray:
        """Batch-allocate points; associates (first_kf, feat_idx[i]) as the
        first observation. Returns allocated ids (-1 where pool full)."""
        n = pos.shape[0]
        ids = np.full((n,), -1, np.int64)
        for i in range(n):
            if self._mp_free:
                m = self._mp_free.pop()
            else:
                if self.n_mp >= self.cfg.max_mp:
                    self._grow_mp_pool()
                m = self.n_mp
                self.n_mp += 1
            ids[i] = m
        ok = ids >= 0
        idx = ids[ok]
        self.mp_pos[idx] = pos[ok]
        self.mp_desc[idx] = desc[ok]
        self.mp_angle[idx] = self.kf_feat_angle[
            first_kf, np.asarray(feat_idx)[np.nonzero(ok)[0]]
        ]
        self.mp_valid[idx] = True
        self.mp_born[idx] = self.version + 1  # the bump below
        self.mp_map_id[idx] = self.active_map
        self.mp_first_kf[idx] = first_kf
        self.mp_n_obs[idx] = 0
        self.mp_found[idx] = 1.0
        self.mp_visible[idx] = 1.0
        self.mp_obs_kf[idx] = -1
        self.mp_obs_idx[idx] = -1
        self.mp_obs_r_level[idx] = -1
        sel = np.nonzero(ok)[0]
        self.add_observations(ids[sel], int(first_kf), np.asarray(feat_idx)[sel])
        self.version += 1
        return ids

    @_locked
    def add_observations(self, mps: np.ndarray, kf: int,
                         feat_idxs: np.ndarray) -> np.ndarray:
        """Vectorized add_observation for a batch of DISTINCT map points
        observed by one keyframe. Returns the mask of points actually added
        (skips points already observing kf or with a full slot table)."""
        mps = np.asarray(mps, np.int64)
        feat_idxs = np.asarray(feat_idxs, np.int64)
        if len(mps) == 0:
            return np.zeros(0, bool)
        slots = self.mp_obs_kf[mps]                    # (n, D)
        sel = ~(slots == kf).any(1) & (slots < 0).any(1)
        rows = mps[sel]
        s = np.argmax(self.mp_obs_kf[rows] < 0, axis=1)
        self.mp_obs_kf[rows, s] = kf
        self.mp_obs_idx[rows, s] = feat_idxs[sel]
        self.mp_n_obs[rows] += 1
        self.kf_feat_mp[kf, feat_idxs[sel]] = rows
        if len(rows):
            self.version += 1
        return sel

    @_locked
    def add_observation(self, mp: int, kf: int, feat_idx: int) -> bool:
        slots = self.mp_obs_kf[mp]
        if kf in slots:
            return True
        free = np.nonzero(slots < 0)[0]
        if len(free) == 0:
            return False
        s = free[0]
        self.mp_obs_kf[mp, s] = kf
        self.mp_obs_idx[mp, s] = feat_idx
        self.mp_n_obs[mp] += 1
        self.kf_feat_mp[kf, feat_idx] = mp
        self.version += 1
        return True

    @_locked
    def set_right_observations(self, kf: int, mps: np.ndarray,
                               uv: np.ndarray, level: np.ndarray) -> int:
        """Attach RIGHT-camera observations to existing (mp, kf) slots — the
        fisheye-stereo second-view measurements the reference constrains with
        EdgeSE3ProjectXYZToBody (OptimizableTypes.h:96-160; observations
        created in Frame.cc:1546-1607). uv must be in LEFT pinhole-equivalent
        pixels; points without an existing left observation of kf are
        skipped. Returns the number attached."""
        mps = np.asarray(mps, np.int64)
        if len(mps) == 0:
            return 0
        slots = self.mp_obs_kf[mps]                 # (n, D)
        hit = slots == kf
        has = hit.any(1)
        rows = mps[has]
        s = np.argmax(hit[has], axis=1)
        self.mp_obs_r_uv[rows, s] = np.asarray(uv, np.float32)[has]
        self.mp_obs_r_level[rows, s] = np.asarray(level, np.int32)[has]
        if len(rows):
            self.version += 1
        return int(len(rows))

    @_locked
    def remove_observation(self, mp: int, kf: int):
        slots = np.nonzero(self.mp_obs_kf[mp] == kf)[0]
        for s in slots:
            fi = self.mp_obs_idx[mp, s]
            if fi >= 0 and self.kf_feat_mp[kf, fi] == mp:
                self.kf_feat_mp[kf, fi] = -1
            self.mp_obs_kf[mp, s] = -1
            self.mp_obs_idx[mp, s] = -1
            self.mp_obs_r_level[mp, s] = -1
            self.mp_n_obs[mp] -= 1
        if self.mp_n_obs[mp] <= (1 if self.kf_feat_ur[kf, 0] < 0 else 1):
            pass  # culling decisions live in LocalMapping

    @_locked
    def remove_point(self, mp: int):
        for s in range(self.cfg.obs_cap):
            kf = self.mp_obs_kf[mp, s]
            if kf >= 0:
                fi = self.mp_obs_idx[mp, s]
                if fi >= 0 and self.kf_feat_mp[kf, fi] == mp:
                    self.kf_feat_mp[kf, fi] = -1
        self.mp_obs_kf[mp] = -1
        self.mp_obs_idx[mp] = -1
        self.mp_obs_r_level[mp] = -1
        self.mp_n_obs[mp] = 0
        self.mp_valid[mp] = False
        self.mp_map_id[mp] = -1
        self._mp_free.append(mp)
        self.version += 1

    @_locked
    def replace_point(self, old: int, new: int):
        """MapPoint::Replace — move observations of `old` into `new`, each
        with its right-camera row (fisheye rig) where it has one."""
        for s in range(self.cfg.obs_cap):
            kf = self.mp_obs_kf[old, s]
            if kf < 0:
                continue
            fi = int(self.mp_obs_idx[old, s])
            if int(self.kf_feat_mp[kf, fi]) == old:
                self.kf_feat_mp[kf, fi] = -1
            if not (kf in self.mp_obs_kf[new]):
                if self.add_observation(new, int(kf), fi) and self.mp_obs_r_level[old, s] >= 0:
                    ns = np.nonzero(self.mp_obs_kf[new] == kf)[0][0]
                    self.mp_obs_r_uv[new, ns] = self.mp_obs_r_uv[old, s]
                    self.mp_obs_r_level[new, ns] = self.mp_obs_r_level[old, s]
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_obs_kf[old] = -1
        self.mp_obs_idx[old] = -1
        self.mp_obs_r_level[old] = -1
        self.mp_n_obs[old] = 0
        self.mp_valid[old] = False
        self._mp_free.append(old)
        self.version += 1

    # --------------------------------------------------------- derived views
    def kf_ids(self, map_id: Optional[int] = None) -> np.ndarray:
        mid = self.active_map if map_id is None else map_id
        return np.nonzero(self.kf_valid & (self.kf_map_id == mid))[0]

    def mp_ids(self, map_id: Optional[int] = None) -> np.ndarray:
        mid = self.active_map if map_id is None else map_id
        return np.nonzero(self.mp_valid & (self.mp_map_id == mid))[0]

    def covisibility(self, kf: int) -> dict[int, int]:
        """weight(kf, other) = #shared map points (UpdateConnections)."""
        mps = self.kf_feat_mp[kf]
        mps = mps[mps >= 0]
        obs = self.mp_obs_kf[mps].reshape(-1)
        obs = obs[(obs >= 0) & (obs != kf)]
        uniq, cnt = np.unique(obs, return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, cnt)}

    def covisibility_edges(self, map_id: Optional[int] = None,
                           min_weight: int = 100):
        """ALL covisibility edges (lo, hi) with weight >= min_weight, in one
        vectorized pass over the observation table (no per-KF Python dicts —
        the essential graph's edge set for Optimizer.cc:4527/:5683 at any map
        size). Returns (pairs (E,2) int64 with lo<hi, weights (E,))."""
        pts = self.mp_ids(map_id)
        if len(pts) == 0:
            return np.empty((0, 2), np.int64), np.empty(0, np.int64)
        obs = self.mp_obs_kf[pts]  # (M, D)
        D = obs.shape[1]
        iu, ju = np.triu_indices(D, 1)
        a = obs[:, iu].reshape(-1).astype(np.int64)
        b = obs[:, ju].reshape(-1).astype(np.int64)
        ok = (a >= 0) & (b >= 0)
        a, b = a[ok], b[ok]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        N = self.kf_R.shape[0]
        key = lo * N + hi
        uniq, cnt = np.unique(key, return_counts=True)
        sel = cnt >= min_weight
        uniq, cnt = uniq[sel], cnt[sel]
        return np.stack([uniq // N, uniq % N], 1), cnt

    def covisible_kfs(self, kf: int, k: int = 10, min_weight: int = 15) -> list[int]:
        counts = self.covisibility(kf)
        # explicit tie-break: equal weight -> newer keyframe first (temporal
        # neighbors carry the freshest geometry for local windows)
        ordered = sorted(counts.items(), key=lambda kv: (-kv[1], -kv[0]))
        out = [c for c, w in ordered if w >= min_weight][:k]
        if not out and ordered:
            out = [ordered[0][0]]  # keep best edge (KeyFrame.cc:499 fallback)
        return out

    def local_point_ids(self, kf_ids, cap: int | None) -> np.ndarray:
        """Points observed by any of kf_ids (TrackLocalMap's local set).
        cap=None returns ALL such points (whole-map BA paths)."""
        mps = self.kf_feat_mp[np.asarray(kf_ids, np.int64)]
        mps = np.unique(mps[mps >= 0])
        mps = mps[self.mp_valid[mps]]
        return mps if cap is None else mps[:cap]

    @_locked
    def update_point_geometry(self, ids: np.ndarray):
        """Recompute normal + scale-invariance distance band + distinctive
        descriptor (MapPoint::UpdateNormalAndDepth :146, ComputeDistinctive-
        Descriptors :142) for the given points — fully vectorized over the
        padded observation table (no per-point Python loop)."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        cfg = self.cfg
        D = cfg.obs_cap
        obs_kf = self.mp_obs_kf[ids]            # (P, D)
        obs_idx = self.mp_obs_idx[ids]
        mask = obs_kf >= 0
        any_obs = mask.any(axis=1)
        ids = ids[any_obs]
        if len(ids) == 0:
            return
        obs_kf = obs_kf[any_obs]
        obs_idx = obs_idx[any_obs]
        mask = mask[any_obs]
        kf_safe = np.maximum(obs_kf, 0)
        idx_safe = np.maximum(obs_idx, 0)

        # normals: mean unit vector from observing camera centers
        R = self.kf_R[kf_safe]                  # (P, D, 3, 3)
        t = self.kf_t[kf_safe]
        centers = -np.einsum("pdji,pdj->pdi", R, t)
        d = self.mp_pos[ids][:, None, :] - centers            # (P, D, 3)
        n = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        n = np.where(mask[..., None], n, 0.0)
        mean_n = n.sum(1) / np.maximum(mask.sum(1, keepdims=True), 1)
        self.mp_normal[ids] = mean_n / np.maximum(
            np.linalg.norm(mean_n, axis=-1, keepdims=True), 1e-9
        )

        # distance band from the FIRST observation slot
        first = mask.argmax(axis=1)
        ar = np.arange(len(ids))
        ref_kf = obs_kf[ar, first]
        ref_idx = obs_idx[ar, first]
        dist = np.linalg.norm(d[ar, first], axis=-1)
        level = self.kf_feat_level[ref_kf, ref_idx]
        sf = cfg.scale_factor
        self.mp_max_dist[ids] = dist * (sf ** level)
        self.mp_min_dist[ids] = self.mp_max_dist[ids] / (sf ** (cfg.n_levels - 1))

        # distinctive descriptor: min median Hamming among observations,
        # the pairs' distances counted 64 bits at a time and each row's
        # median read from its sorted valid entries (the even count's two
        # middle values averaged, as np.median does)
        descs = self.kf_feat_desc[kf_safe, idx_safe]          # (P, D, 8) u32
        words = np.ascontiguousarray(descs).view(np.uint64)   # (P, D, 4)
        bits = np.bitwise_count(words[:, :, None, :] ^ words[:, None, :, :])  # (P, D, D, 4)
        dmat = bits[..., 0].astype(np.float32) + bits[..., 1] + bits[..., 2] + bits[..., 3]
        srt = np.sort(np.where(mask[:, None, :], dmat, np.inf), axis=2)
        cnt = mask.sum(1)
        big = np.float32(1e9)
        mid = (srt[ar, :, (np.maximum(cnt, 1) - 1) // 2] + srt[ar, :, cnt // 2]) / np.float32(2)
        med = np.where(mask, mid, big)
        best = med.argmin(axis=1)
        self.mp_desc[ids] = descs[ar, best]
        self.mp_angle[ids] = self.kf_feat_angle[kf_safe[ar, best],
                                                idx_safe[ar, best]]
        self.version += 1

    def predict_scale_level(self, dist, map_ids) -> np.ndarray:
        """Octave prediction from viewing distance (MapPoint::PredictScale)."""
        cfg = self.cfg
        ratio = self.mp_max_dist[map_ids] / np.maximum(dist, 1e-9)
        lvl = np.ceil(np.log(np.maximum(ratio, 1e-9)) / np.log(cfg.scale_factor))
        return np.clip(lvl, 0, cfg.n_levels - 1).astype(np.int32)

    # ----------------------------------------------------------------- atlas
    @_locked
    def create_new_map(self) -> int:
        """CreateMapInAtlas (Tracking.cc:3174): start a fresh sub-map; old one
        is kept for later merging."""
        self.active_map = self.n_maps
        self.n_maps += 1
        self.map_imu_init[self.active_map] = False
        self.map_viba1[self.active_map] = False
        self.map_viba2[self.active_map] = False
        self.version += 1
        return self.active_map

    @_locked
    def apply_transform(self, map_id: int, s: float, R: np.ndarray, t: np.ndarray,
                        rescale_vel: bool = True):
        """Map::ApplyScaledRotation — gravity-align and rescale a whole map:
        points p' = s R p + t; poses Tcw' so that camera centers transform the
        same way; velocities v' = s R v."""
        kfs = self.kf_ids(map_id)
        mps = self.mp_ids(map_id)
        self.mp_pos[mps] = s * (self.mp_pos[mps] @ R.T) + t
        # scale-dependent derived quantities must follow the map scale
        self.mp_min_dist[mps] *= s
        self.mp_max_dist[mps] *= s
        self.mp_normal[mps] = self.mp_normal[mps] @ R.T
        for k in kfs:
            Rcw, tcw = self.kf_R[k], self.kf_t[k]
            # x_c = Rcw x_w + tcw ; new world x_w' = s R x_w + t =>
            # x_w = R^T (x_w' - t)/s => Rcw' = Rcw R^T, tcw' = tcw - Rcw' t/s...
            # keep camera centers consistent under scaling:
            # center c = -Rcw^T tcw ; c' = s R c + t ; Rcw' = Rcw R^T
            c = -Rcw.T @ tcw
            c2 = s * (R @ c) + t
            Rcw2 = Rcw @ R.T
            self.kf_R[k] = Rcw2
            self.kf_t[k] = -Rcw2 @ c2
            if rescale_vel:
                self.kf_vel[k] = s * (R @ self.kf_vel[k])
        self.version += 1
