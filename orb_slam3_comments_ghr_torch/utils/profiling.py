"""Per-stage timing instrumentation.

Replaces the reference's compile-gated REGISTER_TIMES machinery
(include/Tracking.h:194-208 per-stage ms vectors, Tracking::PrintTimeStats
Tracking.cc:287) with an always-on, near-zero-overhead stage timer keeping
the same stage taxonomy so numbers are comparable with the reference's
published per-stage tables.

Copied from `orb_slam3_comments_ghr_tpu/utils/profiling.py`. The clock is
the host's and a stage does not synchronize the device: on the card a
stage's time is the time to enqueue its work, unless the stage itself
fetches a result to the host. `track_map` (the tracker's frame) and the
mapper's `mp_create`, `fuse` and `local_ba` each fetch their result in one
copy, so their times include the device's; `mp_cull` and `kf_cull` are host
work. Stages come from the tracking thread and, with asynchronous
mapping, from the mapping worker at once: a lock keeps every sample."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimer:
    # the reference's stage taxonomy (SURVEY.md §5.1)
    STAGES = [
        "extract", "stereo_match", "imu_integration", "pose_prediction",
        "track_map", "new_kf", "mp_cull", "mp_create", "fuse", "local_ba",
        "kf_cull", "place_recognition", "loop_correct", "merge", "global_ba",
    ]

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.enabled = True
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                self.samples[name].append(ms)

    def stats(self) -> dict[str, dict]:
        import numpy as np

        with self._lock:
            samples = {k: list(v) for k, v in self.samples.items()}
        out = {}
        for k, v in samples.items():
            a = np.asarray(v)
            out[k] = {
                "n": len(a), "mean_ms": float(a.mean()),
                "p50_ms": float(np.median(a)), "p95_ms": float(np.percentile(a, 95)),
                "total_ms": float(a.sum()),
            }
        return out

    def print_time_stats(self):
        """Tracking::PrintTimeStats equivalent."""
        stats = self.stats()
        width = max((len(k) for k in stats), default=10)
        print(f"{'stage':<{width}}  {'n':>6} {'mean':>9} {'p50':>9} {'p95':>9}")
        for k in self.STAGES:
            if k in stats:
                s = stats[k]
                print(
                    f"{k:<{width}}  {s['n']:>6} {s['mean_ms']:>8.2f}m "
                    f"{s['p50_ms']:>8.2f}m {s['p95_ms']:>8.2f}m"
                )
        for k in stats:
            if k not in self.STAGES:
                s = stats[k]
                print(f"{k:<{width}}  {s['n']:>6} {s['mean_ms']:>8.2f}m")


GLOBAL_TIMER = StageTimer()
