"""A run on the CPU at a tiny size (a few warm-up frames, a short window),
past the harness's look for a card, with the timed path broken underneath:
`correct` must come out false, by the number that the fault is for; the
same run unbroken keeps those numbers within their limits. And the control
(the references in bfloat16 in the program's place) must come out false.

Each run renders and tracks full-width frames on the CPU: minutes each.
Run with `python -m pytest slambench/tests -p xdist -n 4`.
"""

import argparse
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import generate, run  # noqa: E402
from orb_slam3_comments_ghr_torch.optim import imu as imu_mod  # noqa: E402
from orb_slam3_comments_ghr_torch.optim import vi_ba  # noqa: E402
from orb_slam3_comments_ghr_torch.pipeline import programs  # noqa: E402

WARM = {"si_mh01": 60}


@pytest.fixture
def tiny(monkeypatch):
    orig = generate.load_traffic

    def load(name):
        spec = orig(name)
        spec.update(trace_from=0, trace_frames=1)
        spec["samples"].update(draw_from=3, window_match=3, pose=3, preint=3, vi_refine=3,
                               viba=1, viba_from=1)
        return spec

    monkeypatch.setattr(generate, "load_traffic", load)
    torch.set_num_threads(2)

    def go(workload, hooks=None, control=0, seconds=8.0):
        orig_load = generate.load_traffic

        def warm(name):
            spec = orig_load(name)
            spec["warmup_frames"] = WARM[workload]
            return spec

        monkeypatch.setattr(generate, "load_traffic", warm)
        args = argparse.Namespace(workload=workload, seed=2**31 + 11, seconds=seconds, trace=0,
                                  control=control)
        result, _ = run.run(args, torch.device("cpu"), hooks=hooks)
        monkeypatch.setattr(generate, "load_traffic", orig_load)
        return result

    return go


def _over(result, name):
    c = result["checks"][name]
    return c["value"] > c["limit"]


def _patch(monkeypatch, mod, name, make):
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))


def state_unchanged(monkeypatch):
    """The frame program's pose LM returns the pose it started from."""
    def make(fn):
        def wrapper(cam, feats, pts, R0, t0, *a, **k):
            return fn(cam, feats, pts, R0, t0, *a, **k)._replace(R=R0.clone(), t=t0.clone())
        return wrapper
    return lambda slam: _patch(monkeypatch, programs, "track_against_points", make)


def half_batch(monkeypatch):
    """The window match leaves out half of its queries (every other one:
    the padded tail of the local map has no candidates to lose)."""
    def make(fn):
        def wrapper(*a):
            idx, best, second = (x.clone() for x in fn(*a))
            idx[1::2], best[1::2], second[1::2] = 0, 1 << 20, 1 << 20
            return idx, best, second
        return wrapper
    return lambda slam: _patch(monkeypatch, programs, "window_match", make)


def answer_altered(monkeypatch):
    """The window match's best distance is off by one where it is made."""
    def make(fn):
        def wrapper(*a):
            idx, best, second = fn(*a)
            return idx, torch.where(best < (1 << 20), best + 1, best), second
        return wrapper
    return lambda slam: _patch(monkeypatch, programs, "window_match", make)


def preint_altered(monkeypatch):
    """The preintegrated velocity is off by 1 % where it is made."""
    def make(fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            return out._replace(dV=out.dV * 1.01)
        return wrapper
    return lambda slam: _patch(monkeypatch, imu_mod, "preintegrate", make)


def refine_altered(monkeypatch):
    """The VI refinement's body position is off by 1 cm where it is made."""
    def make(fn):
        def wrapper(*a, **k):
            st, *rest = fn(*a, **k)
            return (st._replace(pwb=st.pwb + 0.01), *rest)
        return wrapper

    def hook(slam):
        slam.tracker._pose_inertial = make(slam.tracker._pose_inertial)
    return hook


def viba_unchanged(monkeypatch):
    """The inertial local BA returns the state it started from."""
    def make(fn):
        def wrapper(cam, prob, *a, **k):
            out = fn(cam, prob, *a, **k)
            return (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p) + tuple(out[5:])
        return wrapper
    return lambda slam: _patch(monkeypatch, vi_ba, "vi_bundle_adjust", make)


CASES = [
    ("si_mh01", None, []),
    ("si_mh01", state_unchanged, ["pose_gap_mm"]),
    ("si_mh01", half_batch, ["wm_mismatch"]),
    ("si_mh01", answer_altered, ["wm_mismatch"]),
    ("si_mh01", preint_altered, ["preint_gap"]),
    ("si_mh01", refine_altered, ["vi_gap_mm"]),
    ("si_mh01", viba_unchanged, ["viba_cost_gap"]),
]


@pytest.mark.parametrize("workload,fault,caught", CASES,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}" for w, f, _ in CASES])
def test_fault_makes_the_run_incorrect(tiny, monkeypatch, workload, fault, caught):
    result = tiny(workload, hooks=fault(monkeypatch) if fault else None)
    if fault is None:
        assert result["correct"] is True, result["checks"]
        return
    assert result["correct"] is False
    for name in caught:
        assert _over(result, name), (name, result["checks"])


@pytest.mark.parametrize("workload", ["si_mh01"])
def test_control_is_incorrect(tiny, workload):
    result = tiny(workload, control=1)
    assert result["correct"] is False
    over = [n for n in result["checks"] if _over(result, n)]
    assert over, result["checks"]
