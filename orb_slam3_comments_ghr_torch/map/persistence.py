"""Atlas checkpoint/resume.

Replaces the reference's Boost-serialization Atlas persistence
(System::SaveAtlas/LoadAtlas, System.cc:1474-1632, and the per-type
serialize() members): because the map is already flat SoA arrays, a
checkpoint is a single compressed npz of the pytree + counters — the
reference's pointer-flattening PreSave/PostLoad machinery (KeyFrame.h:299)
disappears by construction. A vocabulary checksum guards mismatched
vocabularies like the reference's MD5 check (System.cc:1594).

Copied from `orb_slam3_comments_ghr_tpu/map/persistence.py` (numpy only),
so the port needs no JAX. The file format is the same: an atlas written by
either package loads in the other, bit for bit."""

from __future__ import annotations

import hashlib
import json

import numpy as np

from .state import MapState, MapConfig

_ARRAYS = [
    "kf_R", "kf_t", "kf_vel", "kf_bias", "kf_time", "kf_valid", "kf_map_id",
    "kf_parent", "kf_prev", "kf_next", "kf_Tcp",
    "kf_feat_xy", "kf_feat_level", "kf_feat_angle", "kf_feat_desc",
    "kf_feat_valid", "kf_feat_ur", "kf_feat_depth", "kf_feat_mp",
    "mp_pos", "mp_desc", "mp_angle", "mp_normal", "mp_min_dist", "mp_max_dist",
    "mp_valid", "mp_map_id", "mp_first_kf", "mp_n_obs", "mp_found",
    "mp_visible", "mp_obs_kf", "mp_obs_idx",
    "mp_obs_r_uv", "mp_obs_r_level",
]


def vocabulary_checksum(voc) -> str:
    h = hashlib.sha256()
    for lv in voc.levels:
        h.update(np.ascontiguousarray(lv).tobytes())
    return h.hexdigest()[:16]


def save_atlas(m: MapState, path: str, voc=None):
    meta = {
        "n_kf": m.n_kf, "n_mp": m.n_mp, "active_map": m.active_map,
        "n_maps": m.n_maps, "version": m.version,
        "mp_free": list(map(int, m._mp_free)),
        "map_imu_init": {str(k): v for k, v in m.map_imu_init.items()},
        "map_viba1": {str(k): v for k, v in m.map_viba1.items()},
        "map_viba2": {str(k): v for k, v in m.map_viba2.items()},
        "cfg": {
            "max_kf": m.cfg.max_kf, "max_mp": m.cfg.max_mp,
            "n_feat": m.cfg.n_feat, "obs_cap": m.cfg.obs_cap,
            "scale_factor": m.cfg.scale_factor, "n_levels": m.cfg.n_levels,
        },
        "voc_checksum": vocabulary_checksum(voc) if voc is not None else "",
        "rig": (None if m.rig is None else
                [np.asarray(m.rig[0]).tolist(), np.asarray(m.rig[1]).tolist()]),
    }
    arrays = {k: getattr(m, k) for k in _ARRAYS}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_atlas(path: str, voc=None) -> MapState:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    if voc is not None and meta.get("voc_checksum"):
        if vocabulary_checksum(voc) != meta["voc_checksum"]:
            raise ValueError(
                "vocabulary checksum mismatch: the atlas was built with a "
                "different vocabulary (System.cc:1594 semantics)"
            )
    cfg = MapConfig(**meta["cfg"])
    m = MapState(cfg)
    for k in _ARRAYS:
        if k in z:  # older checkpoints may miss newer fields (kf_Tcp)
            getattr(m, k)[...] = z[k]
    m.n_kf = int(meta["n_kf"])
    m.n_mp = int(meta["n_mp"])
    m.active_map = int(meta["active_map"])
    m.n_maps = int(meta["n_maps"])
    m.version = int(meta["version"])
    m._mp_free = list(meta["mp_free"])
    m.map_imu_init = {int(k): v for k, v in meta["map_imu_init"].items()}
    m.map_viba1 = {int(k): v for k, v in meta["map_viba1"].items()}
    m.map_viba2 = {int(k): v for k, v in meta["map_viba2"].items()}
    rig = meta.get("rig")
    if rig is not None:
        m.rig = (np.asarray(rig[0], np.float32), np.asarray(rig[1], np.float32))
    return m
