"""The harness finds each cell's files by name, and neither it nor a run
loads JAX or the JAX package."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import generate, run  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_comments_ghr_tpu")


def test_files_dropped_into_their_folders_are_found_by_name(tmp_path, monkeypatch):
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "slambench"
    conf = json.loads((here / "configs" / "euroc_stereo_inertial.json").read_text())
    conf["ORBextractor.nFeatures"] = 1500
    (here / "configs" / "new_conf.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "mh01.json").read_text())
    traffic["start_frame"] = 1000
    (here / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    (here / "limits" / "new_cell.json").write_text(json.dumps({"rpe_mm": 7.0}))
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "new_conf", "source": "x", "file":
                             "slambench/configs/new_conf.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_conf", "traffic": "new_mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x", "moves": "fps",
                               "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(generate, "HERE", here)

    cell = run.load_cell("new_cell")
    assert cell["config"]["ORBextractor.nFeatures"] == 1500
    assert cell["limits"] == {"rpe_mm": 7.0}
    assert "new_metric" in [m["name"] for m in cell["per_layer"]]
    assert "vi_ms" not in [m["name"] for m in cell["per_layer"]]
    assert generate.load_traffic(cell["traffic"])["start_frame"] == 1000
    assert run.metric_reader("new_metric")({}) == 42.0
    assert run.metric_reader("window_match.roofline")({"trace": {}, "wm_bounds_s": []}) is None


def test_no_jax_in_the_harness_or_a_cpu_run():
    """Every module of the harness imported, then a run of a few frames on
    the CPU, in a fresh interpreter: no loaded module's top-level name is
    JAX's or the JAX package's."""
    script = textwrap.dedent(f"""
        import argparse, importlib, json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(2)
        for m in ("run", "check", "generate", "probes", "reference", "trace"):
            importlib.import_module("slambench." + m)
        from slambench import generate, run
        for p in (run.HERE / "metrics").glob("*.py"):
            run.metric_reader(p.stem)
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
