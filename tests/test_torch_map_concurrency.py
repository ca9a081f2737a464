"""Concurrent map access in the port, on the CPU: the two cases of
`tests/test_map_concurrency.py` against the port's mapper on
`test_torch_global_ba.py`'s noisy map (16 keyframes, 300 points). The
mapper's BA write-backs, made on another thread as the mapping worker and
the whole-map BA make them, must be atomic against readers that take the
map's lock: observed data changes only together with a version bump, and a
locked view of the points is always one committed version. Then the port's
own tracker races the mapper: its local-point view and its keyframe
creation against BA write-backs and a point cull whose freed slots new
points reuse. Exact: the views are compared bit for bit."""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from test_global_ba import _build_noisy_map
from test_torch_global_ba import TCAM
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper
from orb_slam3_comments_ghr_torch.pipeline.tracker import Tracker
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

torch.set_num_threads(1)


def _port_map(seed: int):
    m, mapper, kfs, _ = _build_noisy_map(seed=seed, n_kf=16, n_pts=300)
    tm = convert.map_state_from_numpy(convert.map_state_to_numpy(m))
    return tm, tmapper.LocalMapper(TCAM, convert.config_from_jax(mapper.cfg), tm, device="cpu"), kfs


def test_ba_writeback_is_atomic_with_version():
    m, mapper, kfs = _port_map(9)
    pts = m.local_point_ids(kfs, cap=10 ** 9)
    stop = threading.Event()
    errors: list[str] = []
    kf_arr = np.asarray(kfs)

    def writer():
        try:
            for _ in range(12):
                mapper._run_ba(kfs, pts, iters=2, gauge_fix_first=True)
        finally:
            stop.set()

    def reader():
        while not stop.is_set():
            with m.lock:
                v1 = m.version
                R1, t1, p1 = m.kf_R[kf_arr].copy(), m.kf_t[kf_arr].copy(), m.mp_pos[pts].copy()
            # deliberately unlocked gap: the writer may commit here
            with m.lock:
                if m.version == v1 and not (np.array_equal(R1, m.kf_R[kf_arr])
                                            and np.array_equal(t1, m.kf_t[kf_arr])
                                            and np.array_equal(p1, m.mp_pos[pts])):
                    errors.append("data changed without version bump")
                    return

    w = threading.Thread(target=writer)
    rs = [threading.Thread(target=reader) for _ in range(2)]
    w.start()
    [r.start() for r in rs]
    w.join(timeout=300)
    [r.join(timeout=30) for r in rs]
    assert not w.is_alive()
    assert not errors, errors
    assert m.version >= 12


def test_full_speed_track_vs_map_no_torn_views():
    """Tracker-style slicing races the whole-map BA: the positions read for
    `pts` under the lock all belong to one committed version (checked
    against a per-version snapshot)."""
    m, mapper, kfs = _port_map(11)
    pts = m.local_point_ids(kfs, cap=10 ** 9)
    stop = threading.Event()
    with m.lock:
        snap_by_version = {m.version: m.mp_pos[pts].copy()}
    errors: list[str] = []
    seen = set()

    def writer():
        try:
            for _ in range(6):
                mapper.run_full_map_ba(list(kfs), pts, iters=2)
                with m.lock:
                    snap_by_version[m.version] = m.mp_pos[pts].copy()
        finally:
            stop.set()

    def reader():
        while not stop.is_set():
            with m.lock:
                v = m.version
                view = m.mp_pos[pts].copy()
            ref = snap_by_version.get(v)
            if ref is not None:
                seen.add(v)
                if not np.array_equal(view, ref):
                    errors.append(f"torn view at version {v}")
                    return

    w = threading.Thread(target=writer)
    r = threading.Thread(target=reader)
    w.start()
    r.start()
    w.join(timeout=300)
    r.join(timeout=30)
    assert not w.is_alive()
    assert not errors, errors
    assert len(snap_by_version) == 7 and seen


def _as_ref_kf(tr, m, kf: int):
    """Put the tracker on keyframe kf's pose and features, so that a
    keyframe it makes repeats kf's observations. Returns {point: feature}
    of kf."""
    tr.last_kf = kf
    tr.last_R, tr.last_t = m.kf_R[kf].copy(), m.kf_t[kf].copy()
    tr._host = {"xy": m.kf_feat_xy[kf], "level": m.kf_feat_level[kf],
                "angle": m.kf_feat_angle[kf], "desc": m.kf_feat_desc[kf],
                "valid": m.kf_feat_valid[kf], "u_right": m.kf_feat_ur[kf],
                "depth": m.kf_feat_depth[kf]}
    return {int(p): fi for fi, p in enumerate(m.kf_feat_mp[kf]) if p >= 0}


def _matched(ids, feat_of: dict):
    """A tracking result in which each point of the view is matched to the
    feature that observed it in the reference keyframe, when one did."""
    match = np.array([feat_of.get(int(p), -1) for p in ids], np.int64)
    return SimpleNamespace(match_feat=match, inlier=np.ones(len(ids), bool))


def _cull_and_refill(m, kfs, rng, n: int = 12):
    """A point cull and a triangulation after it: n live points removed,
    then n new points whose slots are the freed ones (the pool reuses them)."""
    live = m.local_point_ids(kfs, cap=10 ** 9)
    gone = rng.choice(live, n, replace=False)
    pos, desc = m.mp_pos[gone].copy(), m.mp_desc[gone].copy()
    for x in gone:
        m.remove_point(int(x))
    k = int(rng.choice(kfs))
    free = np.nonzero((m.kf_feat_mp[k] < 0) & m.kf_feat_valid[k])[0][:n]
    new = m.add_map_points(pos[:len(free)] + 0.01, desc[:len(free)], k, free)
    assert set(new.tolist()) <= set(gone.tolist())  # the freed slots, reused
    return gone


def test_tracker_view_and_new_keyframe_race_mapping():
    """The tracker's `_local_points_view` and `_create_new_kf` on one thread,
    the mapper's `_run_ba` and a cull that frees point slots (reused by new
    points at once) on another. Every view holds the positions of the map
    version it reports, and a new keyframe is associated only with points of
    its view: none made after the view took its ids. Each new keyframe
    repeats the last keyframe's observations and is removed once checked."""
    m, mapper, kfs = _port_map(13)
    tr = Tracker(TCAM, SlamConfig(n_features=256, local_points_cap=512), m, device="cpu")
    ref_kf = int(kfs[-1])
    with m.lock:
        snaps = {m.version: m.mp_pos.copy()}
    stop = threading.Event()
    errors: list[str] = []
    made = [0, 0]  # keyframes made, points associated with them

    def writer():
        rng = np.random.default_rng(5)
        try:
            for i in range(150):
                # local BAs around the tracker's reference keyframe, whose
                # points are in its view, and every 5th round a cull
                win = kfs[-6:]
                mapper._run_ba(win, m.local_point_ids(win, cap=10 ** 9), iters=1)
                with m.lock:
                    snaps[m.version] = m.mp_pos.copy()
                if i % 5 == 4:
                    _cull_and_refill(m, kfs, rng, n=6)
                    with m.lock:
                        snaps[m.version] = m.mp_pos.copy()
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(f"writer: {e!r}")
        finally:
            stop.set()

    def tracker():
        while not stop.is_set():
            with m.lock:
                feat_of = _as_ref_kf(tr, m, ref_kf)
            lp, ids = tr._local_points_view()
            v = tr._view_version
            ref = snaps.get(v)
            if ref is not None and not np.array_equal(lp.pos[:len(ids)].numpy(), ref[ids]):
                errors.append(f"torn view at version {v}")
                return
            time.sleep(0.0002)  # the frame's tracking, while the mapper goes on
            tr._create_new_kf(None, 100.0, _matched(ids, feat_of), ids, v)
            with m.lock:
                assoc = m.kf_feat_mp[tr.last_kf]
                assoc = assoc[assoc >= 0]
                if not (np.isin(assoc, ids).all() and (m.mp_born[assoc] <= v).all()):
                    errors.append(f"keyframe {tr.last_kf} took a point made after its view")
                    return
                made[0] += 1
                made[1] += len(assoc)
                m.remove_keyframe(tr.last_kf)
                snaps[m.version] = m.mp_pos.copy()  # the next view's version

    w = threading.Thread(target=writer)
    r = threading.Thread(target=tracker)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: interleavings show
    try:
        w.start()
        r.start()
        w.join(timeout=300)
        r.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not w.is_alive() and not r.is_alive()
    assert not errors, errors
    assert made[0] > 10 and made[1] > 10 * made[0] and len(snaps) > 10


def test_new_keyframe_skips_a_reused_slot():
    """The interleaving the race above can hit, made deterministic: a view
    is taken, the mapper culls points of it and new points reuse their
    slots, then the keyframe is made from the view. The new points are not
    associated with it; the view's other matched points are."""
    m, _, kfs = _port_map(17)
    tr = Tracker(TCAM, SlamConfig(n_features=256, local_points_cap=512), m, device="cpu")
    feat_of = _as_ref_kf(tr, m, int(kfs[-1]))
    lp, ids = tr._local_points_view()
    v = tr._view_version
    gone = _cull_and_refill(m, kfs, np.random.default_rng(3))
    matched = set(feat_of) & set(ids.tolist())
    assert matched & set(gone.tolist())
    tr._create_new_kf(None, 100.0, _matched(ids, feat_of), ids, v)
    assoc = m.kf_feat_mp[tr.last_kf]
    assoc = set(assoc[assoc >= 0].tolist())
    assert assoc == matched - set(gone.tolist())
