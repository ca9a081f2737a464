"""The port's span tracer (`utils/profiling.StageTimer`, `GLOBAL_TIMER`) on
the CPU: nesting, parent links and frame ids, per-thread stacks, a
keyframe's spans on the mapping worker's thread, self time, the off path,
the stage sites of a SLAM run, and that every name in `STAGES` has a site.

Exact: the counts, links and ids are bookkeeping; self time is checked on a
stand-in clock."""

import re
import threading
import types
from pathlib import Path

import torch

from orb_slam3_comments_ghr_torch.utils import profiling
from orb_slam3_comments_ghr_torch.utils.profiling import GLOBAL_TIMER, StageTimer
from test_torch_aux import feature_slam  # noqa: F401  (the 12-frame SLAM run)

torch.set_num_threads(1)

PACKAGE = Path(profiling.__file__).resolve().parents[1]
MAPPER_SPANS = ("mp_cull", "mp_create", "fuse", "kf_cull")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_and_frame_ids():
    t = StageTimer()
    with t.stage("frame", frame=7) as root:
        assert t.frame() == 7
        with t.stage("extract"):
            pass
        with t.stage("track_map"):
            with t.stage("pose_lm"):
                pass
    with t.stage("frame", frame=8):
        with t.stage("extract"):
            pass
    assert t.frame() is None
    spans = t.spans()
    names = [s.name for s in spans]
    assert names == ["frame", "extract", "track_map", "pose_lm", "frame", "extract"]
    by_id = {s.id: s for s in spans}
    assert spans[0] is root and root.parent is None
    assert [by_id[s.parent].name for s in spans[1:4]] == ["frame", "frame", "track_map"]
    assert spans[4].parent is None and by_id[spans[5].parent] is spans[4]
    assert [s.frame for s in spans] == [7, 7, 7, 7, 8, 8]
    assert {s.thread for s in spans} == {threading.current_thread().name}
    assert all(s.t1_ns >= s.t0_ns and s.ms == s.host_ms and s.device_ms is None for s in spans)
    assert len(t.samples["frame"]) == 2 and len(t.samples["extract"]) == 2
    t.reset()
    assert t.spans() == [] and not t.samples


def test_per_thread_stacks():
    """Two threads open nested spans at once; each child's parent is the
    span its own thread has open."""
    t = StageTimer()
    both = threading.Barrier(2)

    def work(frame):
        with t.stage("keyframe", frame=frame):
            both.wait()
            for _ in range(50):
                with t.stage("local_ba"):
                    with t.stage("imu_integration"):
                        pass
            both.wait()

    threads = [threading.Thread(target=work, args=(f,), name=f"w{f}") for f in (1, 2)]
    [th.start() for th in threads]
    [th.join(timeout=60) for th in threads]
    assert not any(th.is_alive() for th in threads)
    spans = t.spans()
    by_id = {s.id: s for s in spans}
    assert len(spans) == 2 * (1 + 2 * 50)
    for s in spans:
        if s.name == "keyframe":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.thread == s.thread and parent.frame == s.frame
        assert parent.name == {"local_ba": "keyframe", "imu_integration": "local_ba"}[s.name]
        assert s.frame == int(s.thread[1])


class _Clock:
    """perf_counter_ns standing in for the host clock: each read returns
    the next value."""

    def __init__(self, ms):
        self.ns = iter(int(v * 1e6) for v in ms)

    def perf_counter_ns(self):
        return next(self.ns)


def test_self_time_is_ms_less_the_children(monkeypatch):
    # reads: parent open, child open/close, child open/close, parent close
    monkeypatch.setattr(profiling, "time", _Clock([0, 10, 30, 40, 70, 100]))
    t = StageTimer()
    with t.stage("keyframe"):
        with t.stage("mp_cull"):
            pass
        with t.stage("local_ba"):
            pass
    kf, cull, ba = t.spans()
    assert (kf.ms, cull.ms, ba.ms) == (100.0, 20.0, 30.0)
    assert (kf.self_ms, cull.self_ms, ba.self_ms) == (50.0, 20.0, 30.0)


def _small_slam(**cfg):
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

    cam = cameras.euroc_cam0()
    slam = SLAM(cam, SlamConfig(n_features=256, local_points_cap=1024, local_ba_points=1024,
                                min_init_matches=50, **cfg), device="cpu")
    world = synthetic.make_world(9, n_points=2000)

    def frames(n):
        for i, (R, t) in enumerate(synthetic.circular_trajectory(12)[:n]):
            yield i * 0.05, synthetic.render_features(world, cam, R, t, n_feat=256,
                                                      seed=60 + i, device="cpu")[0]
    return slam, frames


def test_off_path_records_nothing(monkeypatch):
    """With GLOBAL_TIMER off, SLAM frames open no profiler range, record no
    CUDA event, read no clock and take no lock; on, the same counters
    move (so that they would catch a call)."""
    calls = {"range": 0, "event": 0, "clock": 0, "lock": 0}

    class Range:
        def __init__(self, name):
            calls["range"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Lock:
        def __enter__(self):
            calls["lock"] += 1

        def __exit__(self, *exc):
            return False

    def clock():
        calls["clock"] += 1
        return 0

    def event():
        calls["event"] += 1

    GLOBAL_TIMER.reset()
    monkeypatch.setattr(profiling.torch.profiler, "record_function", Range)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=clock))
    monkeypatch.setattr(profiling, "_event", event)
    monkeypatch.setattr(profiling.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(GLOBAL_TIMER, "_lock", Lock())
    monkeypatch.setattr(GLOBAL_TIMER, "enabled", False)
    slam, frames = _small_slam()
    seq = list(frames(5))
    for ts, feats in seq[:4]:
        slam.track_features(feats, ts)
    assert calls == {"range": 0, "event": 0, "clock": 0, "lock": 0}
    assert not GLOBAL_TIMER._spans and not GLOBAL_TIMER.samples
    monkeypatch.setattr(GLOBAL_TIMER, "enabled", True)
    slam.track_features(seq[4][1], seq[4][0])
    monkeypatch.setattr(GLOBAL_TIMER, "enabled", False)
    assert all(n > 0 for n in calls.values()), calls
    GLOBAL_TIMER.reset()  # the stand-in events are never resolved


def test_mapper_spans_once_per_keyframe(feature_slam):  # noqa: F811
    """The 12-frame CPU run: one root `frame` span a call; each keyframe
    processed inline is one `keyframe` span holding each mapper span once
    (the local BA at most once), all with the frame's id."""
    _, _, _, samples, spans = feature_slam
    by_id = {s.id: s for s in spans}
    named = _by_name(spans)
    frames = named["frame"]
    assert len(frames) == 12 and all(s.parent is None for s in frames)
    assert [s.frame for s in frames] == list(range(12))
    keyframes = named["keyframe"]
    assert len(keyframes) >= 1
    for kf in keyframes:
        assert by_id[kf.parent].name == "frame" and kf.frame == by_id[kf.parent].frame
        children = [s for s in spans if s.parent == kf.id]
        counts = {n: sum(c.name == n for c in children) for n in MAPPER_SPANS + ("local_ba",)}
        assert all(counts[n] == 1 for n in MAPPER_SPANS), counts
        assert counts["local_ba"] <= 1
        assert all(c.frame == kf.frame for c in children)
    for n in MAPPER_SPANS:
        assert len(named[n]) == len(keyframes) == len(samples[n]), n
    # the frame program's spans: the tracking search and its pose LM child
    assert all(by_id[s.parent].name == "track_map" for s in named["pose_lm"])
    assert len(named["pose_lm"]) == len(named["track_map"]) >= 1
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert root.name == "frame" and s.frame == root.frame


def test_keyframe_spans_on_the_mapping_worker(monkeypatch):
    """Asynchronous mapping: each keyframe's spans run on the worker's
    thread and carry the id of the frame that queued the keyframe."""
    monkeypatch.setattr(GLOBAL_TIMER, "enabled", True)
    GLOBAL_TIMER.reset()
    slam, frames = _small_slam(async_mapping=True)
    queued = []
    put = slam._map_queue.put

    def recording_put(item):
        queued.append((item[2], GLOBAL_TIMER.frame()))
        put(item)

    slam._map_queue.put = recording_put
    for ts, feats in frames(12):
        slam.track_features(feats, ts)
    slam.wait_idle()
    spans = GLOBAL_TIMER.spans()
    monkeypatch.setattr(GLOBAL_TIMER, "enabled", False)
    GLOBAL_TIMER.reset()
    assert slam.worker_errors == 0
    assert queued and all(a == b for a, b in queued)
    keyframes = [s for s in spans if s.name == "keyframe"]
    assert 1 <= len(keyframes) <= len(queued)
    assert {s.frame for s in keyframes} <= {f for f, _ in queued}
    main = threading.current_thread().name
    for kf in keyframes:
        assert kf.thread == "mapping" and kf.parent is None
        children = [s for s in spans if s.parent == kf.id]
        assert {c.name for c in children} >= set(MAPPER_SPANS)
        assert all(c.thread == "mapping" and c.frame == kf.frame for c in children)
    assert all(s.thread == main for s in spans if s.name == "frame")


def test_every_stage_has_a_site():
    """`STAGES` lists exactly the names that some `stage("...")` of the
    package opens."""
    sites = set()
    for path in PACKAGE.rglob("*.py"):
        sites |= set(re.findall(r'\.stage\(\s*"([a-z_]+)"', path.read_text()))
    assert sites == set(StageTimer.STAGES)
    assert len(StageTimer.STAGES) == len(set(StageTimer.STAGES))


def test_global_timer_starts_off():
    """GLOBAL_TIMER is off (REGISTER_TIMES compiled out); a timer built by
    hand is on."""
    assert not GLOBAL_TIMER.enabled
    assert StageTimer().enabled and not StageTimer(enabled=False).enabled
