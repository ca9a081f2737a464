"""Counters that two threads share (asynchronous mapping runs the mapper
beside the tracker), and the tracker's loss counters, on the CPU.

- `ops/window_match.count_launch` (what the wrapper calls where it launches
  the kernel) and `utils/profiling.StageTimer.stage` (`GLOBAL_TIMER`): two
  threads make 10 000 counted calls each; the totals are exact, and each
  stage is one span with an id of its own.
- `Tracker.n_lost_resets` / `n_submap_spawns` (JAX `tracker.py:982`,
  `:998`), which `scripts/run_gt_replay.py` reads: the same lost sequence
  through both packages' trackers (a young map lost, then an established
  one) gives the same counts and sub-maps. Exact."""

import sys
import threading

import numpy as np
import pytest
import torch

from test_global_ba import _feats
from orb_slam3_comments_ghr_tpu.frontend.types import empty_features as jempty
from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import tracker as jtracker
from orb_slam3_comments_ghr_tpu.utils import config as jconfig
from orb_slam3_comments_ghr_torch.frontend.types import empty_features
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, window_match
from orb_slam3_comments_ghr_torch.pipeline import tracker as ttracker
from orb_slam3_comments_ghr_torch.utils import config as tconfig
from orb_slam3_comments_ghr_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

CALLS = 10_000


def _two_threads(fn):
    """fn() CALLS times on each of two threads, switching as often as the
    interpreter can, so that an unlocked read-modify-write would lose
    counts."""
    threads = [threading.Thread(target=lambda: [fn() for _ in range(CALLS)], name=f"t{i}")
               for i in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_window_match_launch_count_is_exact(monkeypatch):
    monkeypatch.setattr(window_match, "launches", 0)
    monkeypatch.setattr(window_match, "launches_by_thread", {})
    _two_threads(window_match.count_launch)
    assert window_match.launches == 2 * CALLS
    assert window_match.launches_by_thread == {"t0": CALLS, "t1": CALLS}


def test_stage_timer_keeps_every_sample():
    timer = StageTimer()

    def staged():
        with timer.stage("local_ba"):
            pass

    _two_threads(staged)
    assert timer.stats()["local_ba"]["n"] == 2 * CALLS
    spans = timer.spans()
    assert len(spans) == 2 * CALLS and len({s.id for s in spans}) == 2 * CALLS
    assert all(s.parent is None for s in spans)


def _tracker(pkg: str):
    mc = dict(max_kf=64, max_mp=64, n_feat=256, obs_cap=8)
    cfg = dict(n_features=256)
    if pkg == "torch":
        m = tstate.MapState(tstate.MapConfig(**mc))
        return ttracker.Tracker(tcameras.euroc_cam0(), tconfig.SlamConfig(**cfg), m, device="cpu")
    m = jstate.MapState(jstate.MapConfig(**mc))
    return jtracker.Tracker(jcameras.euroc_cam0(), jconfig.SlamConfig(**cfg), m)


@pytest.fixture(scope="module")
def lost_sequences():
    """Both trackers through: 3 keyframes, then a frame whose timestamp goes
    back (lost: the young map is reset); 12 keyframes in the new map, lost
    again (a new sub-map is opened)."""
    out = {}
    for pkg in ("torch", "jax"):
        t = _tracker(pkg)
        feats = empty_features(256, device="cpu") if pkg == "torch" else jempty(256)
        ts = 10.0
        for n_kfs in (3, 12):
            for _ in range(n_kfs):
                t.map.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), _feats(),
                                   ts)
            t.state, t.last_time, t.last_kf = ttracker.OK, ts, int(t.map.kf_ids()[-1])
            t.track(feats, ts - 1.0)  # a timestamp that goes back: lost
            ts += 10.0
        out[pkg] = t
    return out


def test_lost_counters_against_jax(lost_sequences):
    tt, jt = lost_sequences["torch"], lost_sequences["jax"]
    assert (tt.n_lost_resets, tt.n_submap_spawns) == (1, 1)
    assert (jt.n_lost_resets, jt.n_submap_spawns) == (1, 1)
    assert tt.map.n_maps == jt.map.n_maps == 2
    assert tt.state == jt.state == ttracker.NOT_INITIALIZED
