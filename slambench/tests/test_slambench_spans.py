"""`trace.reduce` on a synthetic list of profiler events: launches and host
syncs go to the innermost range open on their thread, a harness `Timer`'s
synchronize stays in its harness range, and launches are counted inside
each `keyframe` span. Given the port's span names, it keeps their GPU
annotations out of the device's busy time and names an idle gap by the
innermost port span open when it began. `trace.take_spans` keeps the
warm-up's spans apart from the window's. Each reader of the spans returns
None on an empty context and reads what the run gives it."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import run, trace  # noqa: E402
from orb_slam3_comments_ghr_torch.utils.profiling import StageTimer  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
HARNESS = ("frame_program", "keyframe.mapper")
PORT = ("frame", "extract", "track_map", "pose_lm", "keyframe", "local_ba")
SPAN_METRICS = ("local_ba_ms", "keyframe_rest_ms", "keyframe_launches", "frame_syncs")


def ev(name, a, b=None, device=CPU, thread=1):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=a, end=a + 1 if b is None else b))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def two_frames():
    """Frame 0 (no keyframe): the harness's frame-program range around the
    port's extract and track_map (with pose_lm inside), a launch after the
    port's spans closed inside the harness range, a sync in track_map and
    the harness Timer's synchronize. Frame 1: a keyframe whose mapper range
    holds the local BA; a GPU annotation of `extract` on the device."""
    return Prof([
        ev(trace.FRAME, 0, 100), ev("frame", 1, 99),
        ev("frame_program", 10, 40), ev("extract", 12, 20), ev("track_map", 20, 38),
        ev("pose_lm", 25, 35),
        *[ev("cudaLaunchKernel", t) for t in (5, 13, 15, 22, 26, 27, 39)],
        ev("cudaStreamSynchronize", 36), ev("cudaDeviceSynchronize", 39.5),
        ev("cudaMemcpyAsync", 2, thread=2),  # another thread, no range of its own
        ev(trace.FRAME, 100, 200), ev("frame", 101, 199), ev("keyframe", 150, 190),
        ev("keyframe.mapper", 151, 189), ev("local_ba", 152, 180),
        *[ev("cudaLaunchKernel", t) for t in (120, 155, 160, 185)],
        ev("cudaEventSynchronize", 170),
        ev("kernel_a", 2, 3, CUDA), ev("kernel_b", 14, 16, CUDA), ev("extract", 12, 20, CUDA),
        ev("kernel_c", 130, 140, CUDA),
    ])


def test_launches_and_syncs_go_to_the_innermost_range():
    out = trace.reduce(two_frames(), HARNESS, PORT)
    # frame 0: frame 2 (t=2 from the other thread, t=5), extract 2,
    # track_map 1, pose_lm 2; the launch at 39 lies in frame_program after
    # the port's spans closed. Frame 1: frame 1, local_ba 2; the one at 185
    # lies in keyframe.mapper after the local BA
    assert out["port_launches_per_frame"] == [7, 3]
    assert out["keyframe_in_frame"] == [False, True]
    # the Timer's cudaDeviceSynchronize (t=39.5) lies in frame_program
    assert out["port_syncs_per_frame"] == [1, 1]
    r = out["by_range"]
    assert r["pose_lm"]["launches"] == 2 and r["extract"]["launches"] == 2
    assert r["track_map"] == {"calls": 1, "launches": 1, "syncs": 1}
    assert r["frame_program"] == {"calls": 1, "launches": 1, "syncs": 1}
    assert r["local_ba"] == {"calls": 1, "launches": 2, "syncs": 1}
    assert r["keyframe.mapper"]["launches"] == 1
    # a call from a thread that opened no range is charged by every thread's
    assert r["frame"]["launches"] == 3
    assert out["keyframe_launches"] == [3]


def test_idle_gaps_are_named_by_the_innermost_port_span():
    out = trace.reduce(two_frames(), HARNESS, PORT)
    named = {round(s * 1e6): n for n, s in out["idle_gaps"]}
    # busy: [2,3], [14,16], [130,140]; the gap at 0 opens before any port span
    assert named == {2: trace.FRAME, 11: "frame", 114: "extract", 60: "frame"}


def test_trace_reduce_keeps_port_annotations_out_of_the_busy_time():
    with_port = trace.reduce(two_frames(), HARNESS, PORT)
    without = trace.reduce(two_frames(), HARNESS)
    assert with_port["busy_s"] == pytest.approx(13e-6)  # kernels a, b, c
    assert without["busy_s"] == pytest.approx(19e-6)    # the annotation [12, 20] counted too


def test_readers_return_none_on_an_empty_context():
    for name in SPAN_METRICS:
        assert run.metric_reader(name)({}) is None, name


def test_readers_read_the_spans_and_the_trace():
    s = [{"id": 0, "name": "keyframe", "parent": None, "ms": 100.0},
         {"id": 1, "name": "local_ba", "parent": 0, "ms": 60.0},
         {"id": 2, "name": "keyframe", "parent": None, "ms": 50.0},
         {"id": 3, "name": "local_ba", "parent": 9, "ms": 20.0}]
    ctx = {"spans": s, "trace": trace.reduce(two_frames(), HARNESS, PORT)}
    read = {n: run.metric_reader(n)(ctx) for n in SPAN_METRICS}
    assert read == {"local_ba_ms": 40.0, "keyframe_rest_ms": 45.0, "keyframe_launches": 3.0,
                    "frame_syncs": 1.0}


def test_warm_up_spans_are_kept_apart_from_the_window_s():
    """The run takes the spans once when the warm-up ends and once when the
    window closes; a span still open at the first take (a whole-map BA on its
    own thread) joins the second."""
    timer = StageTimer()
    with timer.stage("frame", frame=0):
        with timer.stage("extract"):
            pass
    straddling = timer.stage("global_ba", frame=0)
    straddling.__enter__()
    warmup = trace.take_spans(timer)
    with timer.stage("frame", frame=1):
        with timer.stage("keyframe"):
            with timer.stage("local_ba"):
                pass
    straddling.__exit__(None, None, None)
    window = trace.take_spans(timer)
    assert [(s["name"], s["frame"]) for s in warmup] == [("frame", 0), ("extract", 0)]
    assert [(s["name"], s["frame"]) for s in window] == [("global_ba", 0), ("frame", 1),
                                                          ("keyframe", 1), ("local_ba", 1)]
    assert warmup[1]["parent"] == warmup[0]["id"] and window[3]["parent"] == window[2]["id"]
    assert not {s["id"] for s in warmup} & {s["id"] for s in window}
    assert trace.take_spans(timer) == []
    kf = {"spans": window, "warmup_spans": warmup}
    assert run.metric_reader("local_ba_ms")(kf) == window[3]["ms"]
    assert run.metric_reader("local_ba_ms")({"spans": [], "warmup_spans": window}) is None
