"""Per-stage timing: the port's span tracer.

Replaces the reference's compile-gated REGISTER_TIMES machinery
(include/Tracking.h:194-208 per-stage ms vectors, Tracking::PrintTimeStats
Tracking.cc:287) with a stage timer behind one switch, `GLOBAL_TIMER.enabled`,
off by default as REGISTER_TIMES is compiled out by default. It keeps the
reference's stage taxonomy where a name fits, so that numbers are comparable
with its per-stage tables. A `StageTimer()` built by hand is on.

Off, `stage(name)` returns a shared do-nothing context: no profiler range,
no CUDA event, no lock, no clock. On, each `stage(name)` is a span:

- its name, its parent (the span open around it on the same thread: each
  thread keeps its own stack) and its thread;
- the frame that caused it: the `frame` it is given, else its parent's.
  `SLAM`'s entry points open the root `frame` span with the id the tracker
  gives the frame; a keyframe's `keyframe` span carries the id of the frame
  that made it, also on the mapping worker's thread, and a whole-map BA's
  thread takes the frame of the keyframe that launched it;
- its host start and end (`perf_counter_ns`) and, once CUDA is initialized,
  a CUDA event on the current stream at entry and at exit (none while that
  stream captures a CUDA graph);
- a `torch.profiler.record_function` range of the same name, so that inside
  a profiled slice it sits on the profiler's clock beside the kernels and
  runtime calls it issued.

Nothing syncs the device on the way. `spans()` syncs once and resolves the
events: a span's `ms` is the larger of its host ms and its event-to-event
device ms, its `self_ms` is `ms` less what its children cover. Spans stay in
memory until `reset()`.

`samples` gives each stage's host ms, read from the closed spans, and
`stats()` / `print_time_stats()` read them as before; `print_time_stats()`
adds the mean device ms of the stages whose spans carry it. Stages come from
the tracking thread, the mapping worker and the whole-map BA's thread at
once: a lock keeps every span."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from typing import Optional

import torch


@dataclasses.dataclass
class Span:
    id: int
    name: str
    parent: Optional[int]
    frame: Optional[int]
    thread: str
    t0_ns: int = 0
    t1_ns: Optional[int] = None
    device_ms: Optional[float] = None  # event to event, on the card
    ms: Optional[float] = None         # max(host ms, device ms), once resolved
    self_ms: Optional[float] = None    # ms less the children's
    _events: Optional[list] = dataclasses.field(default=None, repr=False)
    _range: object = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


_OFF = contextlib.nullcontext()  # what `stage` returns while the timer is off


class _Scope:
    __slots__ = ("timer", "name", "frame", "span")

    def __init__(self, timer: "StageTimer", name: str, frame: Optional[int]):
        self.timer, self.name, self.frame = timer, name, frame

    def __enter__(self) -> Span:
        self.span = self.timer._open(self.name, self.frame)
        return self.span

    def __exit__(self, *exc):
        self.timer._close(self.span)
        return False


def _event() -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class StageTimer:
    # the names some site emits: the reference's taxonomy (SURVEY.md §5.1)
    # where one fits, in the order a stereo-inertial frame and its keyframe
    # meet them
    STAGES = [
        "frame", "imu_integration", "pose_prediction", "extract", "stereo_match",
        "track_map", "pose_lm", "fetch", "vi_refine", "new_kf", "keyframe", "mp_cull",
        "mp_create", "fuse", "local_ba", "imu_init", "kf_cull", "place_recognition",
        "loop_correct", "merge", "global_ba",
    ]

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: list[Span] = []
        self._ids = itertools.count()  # never reset: a parent opened before reset() keeps its id

    # ---------------------------------------------------------------- spans
    def stage(self, name: str, frame: Optional[int] = None):
        """A context around one stage's work; `frame` gives a root span its
        frame id (a nested span takes its parent's)."""
        if not self.enabled:
            return _OFF
        return _Scope(self, name, frame)

    def frame(self) -> Optional[int]:
        """The frame id of the innermost span open on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].frame if stack else None

    def _open(self, name: str, frame: Optional[int]) -> Span:
        stack = self._local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        if frame is None and parent is not None:
            frame = parent.frame
        with self._lock:
            span = Span(next(self._ids), name, None if parent is None else parent.id, frame,
                        threading.current_thread().name)
            self._spans.append(span)
        stack.append(span)
        span._range = torch.profiler.record_function(name)
        span._range.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            span._events = [_event()]
        span.t0_ns = time.perf_counter_ns()
        return span

    def _close(self, span: Span):
        t1 = time.perf_counter_ns()
        if span._events is not None:
            if torch.cuda.is_current_stream_capturing():
                span._events = None
            else:
                span._events.append(_event())
        span._range.__exit__(None, None, None)
        span._range = None
        self._local.stack.pop()  # `with` blocks on one thread close in reverse order
        span.t1_ns = t1

    @property
    def samples(self) -> dict[str, list[float]]:
        """Each stage's host ms, by name, over the closed spans in the order
        they opened."""
        with self._lock:
            done = [s for s in self._spans if s.t1_ns is not None]
        out = defaultdict(list)
        for s in done:
            out[s.name].append(s.host_ms)
        return dict(out)

    def spans(self) -> list[Span]:
        """The closed spans since the last `reset()`, in the order they
        opened, resolved: one device sync if any carries CUDA events."""
        with self._lock:
            done = [s for s in self._spans if s.t1_ns is not None]
        pending = [s for s in done if s.ms is None]
        if any(s._events for s in pending):
            torch.cuda.synchronize()
        for s in pending:
            if s._events:
                s.device_ms = s._events[0].elapsed_time(s._events[1])
                s._events = None
            s.ms = max(s.host_ms, s.device_ms or 0.0)
        cover = defaultdict(float)
        for s in done:
            if s.parent is not None:
                cover[s.parent] += s.ms
        for s in done:
            s.self_ms = max(0.0, s.ms - cover.get(s.id, 0.0))
        return done

    def reset(self):
        """Forget every closed span; spans still open are kept, and join the
        next `spans()` once they close."""
        with self._lock:
            self._spans = [s for s in self._spans if s.t1_ns is None]

    # ---------------------------------------------------------------- tables
    def stats(self) -> dict[str, dict]:
        import numpy as np

        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {
                "n": len(a), "mean_ms": float(a.mean()),
                "p50_ms": float(np.median(a)), "p95_ms": float(np.percentile(a, 95)),
                "total_ms": float(a.sum()),
            }
        return out

    def _device_means(self) -> dict[str, float]:
        """Mean device ms by stage, over the spans that carry it."""
        by_name = defaultdict(list)
        for s in self.spans():
            if s.device_ms is not None:
                by_name[s.name].append(s.device_ms)
        return {k: sum(v) / len(v) for k, v in by_name.items()}

    def print_time_stats(self):
        """Tracking::PrintTimeStats equivalent; a `dev` column (mean device
        ms) where spans carry device times."""
        stats = self.stats()
        dev = self._device_means()
        width = max((len(k) for k in stats), default=10)

        def col(k):
            return (f" {dev[k]:>8.2f}m" if k in dev else f" {'':>9}") if dev else ""

        print(f"{'stage':<{width}}  {'n':>6} {'mean':>9} {'p50':>9} {'p95':>9}"
              + (f" {'dev':>9}" if dev else ""))
        for k in self.STAGES:
            if k in stats:
                s = stats[k]
                print(
                    f"{k:<{width}}  {s['n']:>6} {s['mean_ms']:>8.2f}m "
                    f"{s['p50_ms']:>8.2f}m {s['p95_ms']:>8.2f}m" + col(k)
                )
        for k in stats:
            if k not in self.STAGES:
                s = stats[k]
                print(f"{k:<{width}}  {s['n']:>6} {s['mean_ms']:>8.2f}m")


GLOBAL_TIMER = StageTimer(enabled=False)
