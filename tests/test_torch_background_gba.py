"""The whole-map BA on its own thread in the port, on the CPU: the three
cases of `tests/test_background_gba.py` on `test_torch_global_ba.py`'s noisy
map (the loop closer's GBA thread under `async_mapping`, a keyframe inserted
while it runs, the abort of a 50-iteration GBA by the next loop, the
unbounded keyframe queue), and the bite-wise local BAs that asynchronous
mapping runs.

Bounds: the GBA thread's run and its JAX twin (the same stall, the same
inserted keyframe) leave maps within `test_torch_global_ba.same_maps`'
bounds (rotations 1e-4, translations 1e-3, points 1e-2, the same
observations); the inserted keyframe keeps its pose relative to its parent
within 1e-4, as in the JAX test. A bite-wise `_run_ba` / `_run_vi_ba` run to
its end equals the monolithic call bit for bit, and one stopped by the
queue probe after its first bite equals a 2-iteration call bit for bit."""

import functools
import threading
import time

import numpy as np
import torch

from test_global_ba import _build_noisy_map, _feats, _reproj_rmse
from test_torch_global_ba import TCAM, both_maps, same_maps
from test_torch_inertial_merge import port_mapper, two_fragments
from orb_slam3_comments_ghr_tpu.optim import ba as jba
from orb_slam3_comments_ghr_tpu.pipeline.loopcloser import LoopCloser as JLoopCloser
from orb_slam3_comments_ghr_tpu.utils.config import SlamConfig as JSlamConfig
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.optim import ba as tba
from orb_slam3_comments_ghr_torch.pipeline import mapper as tmapper
from orb_slam3_comments_ghr_torch.pipeline.loopcloser import LoopCloser
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

torch.set_num_threads(1)

CFG = dict(n_features=256, local_ba_points=512, async_mapping=True)


def _loopcloser(tm, tmp):
    return LoopCloser(TCAM, SlamConfig(**CFG), tm, kfdb=None, mapper=tmp, device="cpu")


class _Stall:
    """Holds the first bite of `module.bundle_adjust_resumable` until
    released, so that the test acts while the GBA is mid-run."""

    def __init__(self, module):
        self.module, self.orig = module, module.bundle_adjust_resumable
        self.started, self.release = threading.Event(), threading.Event()

    def __enter__(self):
        def stalled(*a, **k):
            self.started.set()
            self.release.wait(timeout=30)
            return self.orig(*a, **k)

        self.module.bundle_adjust_resumable = stalled
        return self

    def __exit__(self, *exc):
        self.module.bundle_adjust_resumable = self.orig
        self.release.set()


def _insert_child(m, par):
    child = m.add_keyframe(m.kf_R[par].copy(), (m.kf_t[par] + [0.1, 0, 0]).copy(), _feats(),
                           timestamp=99.0, parent=par)
    rel = m.kf_R[child] @ m.kf_R[par].T
    return child, rel, m.kf_t[child] - rel @ m.kf_t[par]


def test_runs_on_thread_and_tracker_side_work_continues():
    m, mapper, tm, tmp, kfs = both_maps(7)
    e0 = _reproj_rmse(tm, kfs)
    children = []
    tlc = _loopcloser(tm, tmp)
    jlc = JLoopCloser(mapper.cam, JSlamConfig(**CFG), m, kfdb=None, mapper=mapper)
    for mm, lc, launch, module in (
            (tm, tlc, lambda: tlc._launch_gba(tmp.global_ba, iters=4), tba),
            (m, jlc, lambda: jlc._global_ba(iters=4), jba)):
        with _Stall(module) as stall:
            launch()
            assert stall.started.wait(timeout=30)
            assert lc.gba_running
            # "tracking" inserts a keyframe while the GBA holds its snapshot
            children.append(_insert_child(mm, kfs[-1]))
            stall.release.set()
            lc.join_gba()
        assert not lc.gba_running
    same_maps(m, tm)
    e1 = _reproj_rmse(tm, kfs)
    assert e1 < e0, (e0, e1)
    # the spanning-tree propagation kept the child rigidly attached
    child, rel_before, trel_before = children[0]
    rel_after = tm.kf_R[child] @ tm.kf_R[kfs[-1]].T
    np.testing.assert_allclose(rel_after, rel_before, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t[child] - rel_after @ tm.kf_t[kfs[-1]], trel_before,
                               atol=1e-4)


def test_new_loop_aborts_running_gba():
    _, _, tm, tmp, _ = both_maps(9)
    lc = _loopcloser(tm, tmp)
    v0 = tm.version
    with _Stall(tba) as stall:
        lc._launch_gba(tmp.global_ba, iters=50)  # 25 bites unless stopped
        assert stall.started.wait(timeout=30)
        t0 = time.monotonic()
        stall.release.set()
        lc.abort_gba()  # what process_keyframe does when a loop verifies
        took = time.monotonic() - t0
    assert not lc.gba_running
    assert tmp.abort_gba   # the stop request reached the LM loop
    assert tm.version > v0  # the partial result was written back
    assert took < 20.0


def test_tracker_map_queue_never_blocks():
    slam = SLAM(TCAM, SlamConfig(**CFG), device="cpu")
    assert slam._map_queue.maxsize == 0
    assert slam.tracker.queue_probe is not None
    assert slam.loopcloser.on_gba_error is not None  # a GBA's exception is counted


@functools.lru_cache(maxsize=None)
def _noisy_snapshot(seed: int):
    """The noisy map of `both_maps(seed)` as arrays, its port config and
    keyframes: built once, copied into each port map."""
    m, mapper, kfs, _ = _build_noisy_map(seed=seed)
    return convert.map_state_to_numpy(m), convert.config_from_jax(mapper.cfg), kfs


def _visual_mapper(seed: int, share_stream: bool):
    """A port mapper on a fresh copy of the noisy map; with `share_stream`
    wired to an empty keyframe queue, as the worker's mapper is, so that
    its abortable BAs run in bites."""
    arrays, cfg, kfs = _noisy_snapshot(seed)
    tm = convert.map_state_from_numpy(arrays)
    tmp = tmapper.LocalMapper(TCAM, cfg, tm, device="cpu")
    if share_stream:
        tmp.queue_probe = lambda: 0
    return tm, tmp, kfs


def _same_bits(a, b):
    for k in ("kf_R", "kf_t", "kf_vel", "kf_bias", "mp_pos", "mp_obs_kf", "version"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_bitewise_ba_equals_monolithic():
    (tm1, mp1, kfs), (tm2, mp2, _) = _visual_mapper(2, False), _visual_mapper(2, True)
    pts = tm1.local_point_ids(kfs[:10], 512)
    mp1._run_ba(kfs[:10], pts, iters=7, abortable=True)
    mp2._run_ba(kfs[:10], pts, iters=7, abortable=True)  # nothing waits: every bite runs
    _same_bits(tm1, tm2)
    # stopped after the first bite by a waiting keyframe: two iterations
    (tm1, mp1, _), (tm2, mp2, _) = _visual_mapper(2, False), _visual_mapper(2, True)
    mp2.queue_probe = lambda: 1
    mp1._run_ba(kfs[:10], pts, iters=2)
    mp2._run_ba(kfs[:10], pts, iters=7, abortable=True)
    _same_bits(tm1, tm2)


def _inertial_mapper(share_stream: bool):
    m, kf_ids, preint = two_fragments()
    mapper = port_mapper(m, preint)
    if share_stream:
        mapper.queue_probe = lambda: 0
    return m, mapper, kf_ids


def test_bitewise_vi_ba_equals_monolithic():
    (m1, mp1, kfs), (m2, mp2, _) = _inertial_mapper(False), _inertial_mapper(True)
    pts = m1.local_point_ids(kfs[:3], 512)
    mp1._run_vi_ba(kfs[:3], pts, iters=5, abortable=True)
    mp2._run_vi_ba(kfs[:3], pts, iters=5, abortable=True)
    _same_bits(m1, m2)
    assert mp1.imu.bias.tobytes() == mp2.imu.bias.tobytes()
    (m1, mp1, _), (m2, mp2, _) = _inertial_mapper(False), _inertial_mapper(True)
    mp2.queue_probe = lambda: 2
    mp1._run_vi_ba(kfs[:3], pts, iters=2)
    mp2._run_vi_ba(kfs[:3], pts, iters=5, abortable=True)
    _same_bits(m1, m2)
