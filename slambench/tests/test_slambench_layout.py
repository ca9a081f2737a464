"""The harness finds each cell's files by name (its checks and per-layer
readers among them), draws the output check's samples as it always did,
and neither it nor a run loads JAX or the JAX package."""

import argparse
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import check, generate, run  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_comments_ghr_tpu")

NEW_CHECK = """
CALL = "pipeline.programs.track_against_points"
SAMPLE = "new_draw"


def picks(rng, samples):
    return rng.choice(samples["draw_from"], samples["new_draw"], False)


def keep(args, kwargs, out):
    return out.match_feat


def number(kept, ctx):
    return float(len(kept)) if kept else None
"""


def _plant(tmp_path: Path, limits: dict) -> Path:
    """A copy of the benchmark in `tmp_path` with a new configuration,
    traffic, cell, check and per-layer readers dropped into its folders,
    and the port beside it; the copy's `slambench/`."""
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / run.PORT).symlink_to(ROOT / run.PORT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "slambench"
    conf = json.loads((here / "configs" / "euroc_stereo_inertial.json").read_text())
    conf["ORBextractor.nFeatures"] = 1500
    (here / "configs" / "new_conf.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "mh01.json").read_text())
    traffic["start_frame"] = 1000
    traffic["samples"]["new_draw"] = 3
    (here / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    (here / "limits" / "new_cell.json").write_text(json.dumps(limits))
    (here / "checks" / "new_check.py").write_text(NEW_CHECK)
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    (here / "metrics" / "warmup_frame_spans.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(s['name'] == 'frame' for s in ctx['warmup_spans']))\n")
    (here / "metrics" / "window_frame_spans.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(s['name'] == 'frame' for s in ctx['spans']))\n")
    bench["configs"].append({"name": "new_conf", "source": "x", "file":
                             "slambench/configs/new_conf.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_conf", "traffic": "new_mix",
                               "chips": 1, "why": "x"})
    for name in ("new_metric", "warmup_frame_spans", "window_frame_spans"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "x", "moves": "fps",
                                   "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return here


def _si_mh01_limits() -> dict:
    return json.loads((ROOT / "slambench" / "limits" / "si_mh01.json").read_text())


def test_files_dropped_into_their_folders_are_found_by_name(tmp_path, monkeypatch):
    here = _plant(tmp_path, {**_si_mh01_limits(), "new_check": 100})
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(generate, "HERE", here)

    cell = run.load_cell("new_cell")
    assert cell["config"]["ORBextractor.nFeatures"] == 1500
    assert cell["limits"]["new_check"] == 100
    # the checks draw in the order of the traffic's samples keys: the new one last
    assert list(cell["checks"]) == ["wm_mismatch", "pose_gap_mm", "viba_cost_gap",
                                    "preint_gap", "vi_gap_mm", "new_check"]
    assert cell["checks"]["new_check"].SAMPLE == "new_draw"
    assert "new_metric" in [m["name"] for m in cell["per_layer"]]
    assert "vi_ms" not in [m["name"] for m in cell["per_layer"]]
    assert generate.load_traffic(cell["traffic"])["start_frame"] == 1000
    assert run.metric_reader("new_metric")({}) == 42.0
    assert run.metric_reader("window_match.roofline")({"trace": {}, "wm_bounds_s": []}) is None


def test_a_limit_with_no_check_stops_the_run_before_the_warm_up(tmp_path, monkeypatch):
    here = _plant(tmp_path, {**_si_mh01_limits(), "no_such_check": 1.0})
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(generate, "HERE", here)

    def built(*a, **k):
        raise AssertionError("frames built before the checks were found")
    monkeypatch.setattr(generate, "build_frames", built)
    monkeypatch.setattr(run, "build_slam", built)
    args = argparse.Namespace(workload="new_cell", seed=1, seconds=1.0, trace=0, control=0)
    import torch

    with pytest.raises(SystemExit, match="no_such_check"):
        run.run(args, torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 17, 3160000101])
def test_si_mh01_draws_the_calls_it_always_drew(seed):
    """The checks of `si_mh01` keep the calls that one `default_rng(seed)`
    gave in the order window match, pose, local BA, preintegration, VI
    refinement (the pose check keeps its first 60 and draws among them
    later, from a generator of its own)."""
    samples = generate.load_traffic("mh01")["samples"]
    checks = check.load(_si_mh01_limits(), samples)
    got = {name: sorted(s.picks) for name, s in check.samplers(checks, samples, seed).items()}
    rng = np.random.default_rng(seed)
    want = {"wm_mismatch": rng.choice(60, 6, False), "pose_gap_mm": range(60),
            "viba_cost_gap": rng.choice(6, 2, False), "preint_gap": rng.choice(60, 4, False),
            "vi_gap_mm": rng.choice(60, 4, False)}
    assert got == {name: sorted(int(i) for i in v) for name, v in want.items()}


def test_planted_check_and_readers_run_on_a_tiny_cpu_window(tmp_path):
    """In a fresh interpreter on the copy with the planted files: a run with
    `--trace 0` opens no span; a traced run of the new cell runs the new
    check on the calls it drew and the new readers, the warm-up's spans
    apart from the window's."""
    _plant(tmp_path, {**_si_mh01_limits(), "new_check": 100})
    script = textwrap.dedent(f"""
        import argparse, json, sys
        sys.path.insert(0, {str(tmp_path)!r})
        import torch
        torch.set_num_threads(2)
        from slambench import generate, run
        from orb_slam3_comments_ghr_torch.utils.profiling import GLOBAL_TIMER
        assert run.HERE == run.ROOT / "slambench" and str(run.ROOT) == {str(tmp_path)!r}
        orig = generate.load_traffic
        def tiny(name):
            s = orig(name)
            s.update(warmup_frames=3, trace_from=0, trace_frames=1)
            s["samples"].update(draw_from=3, window_match=2, pose=2, preint=2, vi_refine=2)
            return s
        generate.load_traffic = tiny
        opened = []
        open_ = GLOBAL_TIMER._open
        GLOBAL_TIMER._open = lambda *a: (opened.append(a[0]), open_(*a))[1]
        out = {{}}
        for trace in (0, 1):
            opened.clear()
            args = argparse.Namespace(workload="new_cell", seed=2**31 + 7, seconds=0.5,
                                      trace=trace, control=0)
            result, lines = run.run(args, torch.device("cpu"))
            out[trace] = {{"opened": len(opened), "enabled": GLOBAL_TIMER.enabled,
                          "left": len(GLOBAL_TIMER.spans()), "result": result}}
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=900, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = out["0"], out["1"]
    assert off["opened"] == 0 and not off["enabled"] and off["left"] == 0
    assert "spans" not in off["result"] and off["result"]["metrics"].keys() == {
        "fps", "frame_ms.p95", "setup_s"}
    assert on["opened"] > 0 and not on["enabled"] and on["left"] == 0
    res = on["result"]
    new = res["checks"]["new_check"]
    assert new["limit"] == 100.0 and 1.0 <= new["value"] == len(res["sampled"]["new_check"])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["new_metric"] == 42.0
    assert m["warmup_frame_spans"] == res["window"]["warmup_frames"] >= 3
    assert m["window_frame_spans"] == res["window"]["frames"] >= 1
    assert res["spans"]["frame"]["calls"] == res["window"]["frames"]
    assert list(res)[-1] == "checks"


def test_no_jax_in_the_harness_or_a_cpu_run():
    """Every module of the harness, its checks and readers imported, then a
    run of a few frames on the CPU, in a fresh interpreter: no loaded
    module's top-level name is JAX's or the JAX package's."""
    script = textwrap.dedent(f"""
        import argparse, importlib, json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(2)
        for m in ("run", "check", "generate", "probes", "reference", "trace"):
            importlib.import_module("slambench." + m)
        from slambench import check, generate, run
        for p in (run.HERE / "metrics").glob("*.py"):
            run.metric_reader(p.stem)
        for p in (run.HERE / "checks").glob("*.py"):
            check.load_module(p, "check")
        orig = generate.load_traffic
        def tiny(name):
            s = orig(name)
            s.update(warmup_frames=3, trace_from=0, trace_frames=1)
            s["samples"].update(draw_from=3, window_match=2, pose=2, preint=2, vi_refine=2)
            return s
        generate.load_traffic = tiny
        args = argparse.Namespace(workload="si_mh01", seed=2**31 + 5, seconds=0.5, trace=1,
                                  control=0)
        result, _ = run.run(args, torch.device("cpu"))
        print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "orb_slam3_comments_ghr_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_a_checkout_of_the_benchmark_alone_refuses_to_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and slambench/, a run
    exits non-zero and prints no result."""
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = textwrap.dedent("""
        import sys, torch
        torch.cuda.is_available = lambda: True  # past the look for a card
        torch.cuda.device_count = lambda: 1
        sys.argv = ["run", "--workload", "si_mh01", "--seed", "1", "--seconds", "1",
                    "--trace", "0"]
        from slambench import run
        sys.exit(run.main())
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
