"""Run one cell of the port's benchmark once.

    python -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration in `slambench/configs/<config>.json`, its traffic in
`slambench/traffic/<traffic>.json`, the limits of its output check in
`slambench/limits/<workload>.json`, the check of each limit in
`slambench/checks/<limit>.py` (see `check.py`), and each per-layer
metric's reader in `slambench/metrics/<metric>.py`. A limit with no check
stops the run before anything is built.

A run (1) builds the scene and the IMU samples from the seed, renders the
frames on the card, builds the `SLAM` of the configuration and feeds it the
traffic's warm-up frames: that is `setup_s`, from the process's start to
the window's first frame; (2) replays the frames in a closed loop for
`--seconds`, the next frame going in when the previous call returns, with
the frames as host uint8 arrays; (3) checks the output against the plain
references and prints one JSON line. With `--trace 1` the same run
records the port's spans (`utils/profiling.GLOBAL_TIMER`, on from the
`SLAM`'s construction to the window's close, the warm-up's kept apart from
the window's), times the layers through the harness's wrappers, profiles a
slice of the window, and prints the per-layer metrics instead, with a table
of the spans by name. With `--trace 0` the tracer stays off.

`--control 1` is not used by the benchmark's own runs: it puts the
references, computed one precision lower (bfloat16), in the program's
place in the output check, for setting the check's limits, and prints the
program's own numbers on the same samples beside them (`program_checks`).

It needs a CUDA card and exits non-zero without one, or when anything of
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "orb_slam3_comments_ghr_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_comments_ghr_tpu")
CACHE = ROOT / ".slambench_cache"


def _environment():
    """Caches inside the checkout at fixed paths; a few host threads."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    if str(ROOT) not in sys.path[:1]:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(workload: str) -> dict:
    """The cell, its configuration, traffic, limits, checks and per-layer
    metrics, by the names in BENCHMARK.json."""
    from . import check, generate

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    spec = generate.load_traffic(cell["traffic"])
    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": cell["traffic"],
        "spec": spec,
        "limits": limits,
        "checks": check.load(limits, spec["samples"], HERE),
        "per_layer": per_layer,
        "end_to_end": end_to_end,
    }


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`."""
    from . import check

    return check.load_module(HERE / "metrics" / f"{name}.py", "slambench_metric").read


def port_attribute(call: str, slam):
    """(owner, name) of a check's `CALL`: a function of a module under the
    port's package (`optim.imu.preintegrate`), or an attribute of `slam`
    (`slam.tracker._pose_inertial`); None where it does not exist."""
    *path, name = call.split(".")
    if path[:1] == ["slam"]:
        owner = slam
        for part in path[1:]:
            owner = getattr(owner, part, None)
    else:
        owner = importlib.import_module(".".join([PORT, *path]))
    return (owner, name) if hasattr(owner, name) else None


def camera_dict(cfg: dict) -> dict:
    return {k: float(cfg[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy", "width", "height",
                                                   "bf", "fps")}


def build_slam(cfg: dict, device):
    """The port's SLAM for a configuration file."""
    import numpy as np

    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.optim import imu as imu_mod
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import config

    c = camera_dict(cfg)
    cam = cameras.Camera(kind=cameras.PINHOLE, fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                         width=int(c["width"]), height=int(c["height"]), bf=c["bf"],
                         fps=c["fps"])
    sensor = {"mono": config.MONOCULAR, "stereo": config.STEREO,
              "imu_stereo": config.IMU_STEREO}[cfg["sensor"]]
    voc = ROOT / PORT / cfg["vocabulary"]
    scfg = config.SlamConfig(
        sensor=sensor, n_features=int(cfg["ORBextractor.nFeatures"]),
        n_levels=int(cfg["ORBextractor.nLevels"]),
        scale_factor=float(cfg["ORBextractor.scaleFactor"]),
        ini_th_fast=float(cfg["ORBextractor.iniThFAST"]),
        min_th_fast=float(cfg["ORBextractor.minThFAST"]),
        max_frames_between_kf=int(round(c["fps"])),
        depth_th_factor=float(cfg.get("Stereo.ThDepth", 35.0)),
        enable_loop_closing=bool(cfg["loop_closing"]), async_mapping=False,
        voc_path=str(voc))
    calib = None
    if scfg.is_inertial:
        sf = float(cfg["IMU.Frequency"]) ** 0.5
        T = np.asarray(cfg["IMU.T_b_c1"], np.float32)
        calib = imu_mod.ImuCalib(
            Rbc=T[:3, :3].copy(), tbc=T[:3, 3].copy(), noise_g=cfg["IMU.NoiseGyro"] * sf,
            noise_a=cfg["IMU.NoiseAcc"] * sf, walk_g=cfg["IMU.GyroWalk"] / sf,
            walk_a=cfg["IMU.AccWalk"] / sf)
    return SLAM(cam, scfg, imu_calib=calib, device=device)


def imu_spec(cfg: dict) -> dict | None:
    if not cfg["sensor"].startswith("imu"):
        return None
    f = float(cfg["IMU.Frequency"])
    return {"rate_hz": f, "noise_g": cfg["IMU.NoiseGyro"] * f ** 0.5,
            "noise_a": cfg["IMU.NoiseAcc"] * f ** 0.5}


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank (inf counts as the largest)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)] if v else float("inf")


def window_metrics(latency_ms, tracked, window_s: float) -> dict:
    """`fps`: frames that returned a pose over the window's seconds;
    `frame_ms.p95`: the 95th percentile (nearest rank) of every frame's
    call-to-pose ms, a frame that returned no pose counting as missing
    every limit (inf)."""
    missing = [v if ok else float("inf") for v, ok in zip(latency_ms, tracked)]
    return {"fps": sum(map(bool, tracked)) / window_s,
            "frame_ms.p95": nearest_rank(missing, 0.95)}


def run(args, device, hooks=None) -> tuple[dict, list[str]]:
    """One run on `device`; returns (the result line's dict, the check
    lines). `hooks(slam)`, where given, runs once the warm-up has ended,
    before the window (the tests plant faults there)."""
    import torch

    from orb_slam3_comments_ghr_torch.optim import imu as imu_mod
    from orb_slam3_comments_ghr_torch.pipeline import programs
    from orb_slam3_comments_ghr_torch.utils.profiling import GLOBAL_TIMER, StageTimer

    from . import check, generate, probes
    from . import trace as trace_mod

    cell = load_cell(args.workload)
    cfg, limits, checks, spec = cell["config"], cell["limits"], cell["checks"], cell["spec"]
    cam = camera_dict(cfg)
    stereo = "stereo" in cfg["sensor"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    warm_max = int(spec["warmup_max"])
    n_frames = min(warm_max + int(spec["fps_cap"] * args.seconds),
                   len(generate.load_motion(spec["motion_path"]).times) - int(spec["start_frame"]))
    frames = generate.build_frames(spec, cam, args.seed, n_frames, stereo, imu_spec(cfg), device)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    traced = bool(args.trace)
    if traced:
        GLOBAL_TIMER.reset()
        GLOBAL_TIMER.enabled = True
    slam = build_slam(cfg, device)
    entry = slam.track_stereo if stereo else slam.track_monocular

    def feed(k: int):
        imu = None if frames.imu is None else frames.imu[k]
        if stereo:
            return entry(frames.left[k], frames.right[k], float(frames.times[k]), imu_samples=imu)
        return entry(frames.left[k], float(frames.times[k]), imu_samples=imu)

    # the warm-up: at least warmup_frames, then on until a frame returns a
    # pose (a monocular map initializes when the motion gives parallax)
    warm, pose = 0, None
    while warm < int(spec["warmup_frames"]) or pose is None:
        if warm >= warm_max:
            raise RuntimeError(f"not tracking after {warm} warm-up frames")
        pose = feed(warm)
        warm += 1
    sync()
    warmup_spans = trace_mod.take_spans(GLOBAL_TIMER) if traced else []
    if hooks is not None:
        hooks(slam)

    # the output check's samples, drawn from the seed
    samplers = check.samplers(checks, spec["samples"], args.seed)
    patches = probes.Patches()
    for name, mod in checks.items():
        where = port_attribute(mod.CALL, slam)
        if where is not None:
            patches.wrap(*where, samplers[name])

    timer = probes.Timer(sync)
    keyframe_at = set()
    cur = [0]
    wm_args = []
    prof = None
    profiling = [False]
    if traced:
        timer.on_call = lambda key: keyframe_at.add(cur[0]) if key.startswith("keyframe") else None
        frame_prog = "extract_and_track_stereo" if stereo else "extract_and_track"
        patches.wrap(programs, frame_prog, timer("frame_program"))
        patches.wrap(slam.mapper, "process_keyframe", timer("keyframe.mapper"))
        patches.wrap(slam.loopcloser, "process_keyframe", timer("keyframe.loopcloser"))
        if slam.imu is not None:
            patches.wrap(imu_mod, "preintegrate", timer("vi.preintegrate"))
            patches.wrap(imu_mod, "preintegrate_continue", timer("vi.preintegrate"))
            patches.wrap(slam.tracker, "_vi_refine", timer("vi.refine"))

        def keep_args(fn):
            def wrapper(*a):
                if profiling[0]:
                    wm_args.append(a)
                return fn(*a)
            return wrapper
        patches.wrap(programs, "window_match", keep_args)
    trace_from, trace_n = int(spec["trace_from"]), int(spec["trace_frames"])
    ranges = ("frame_program", "keyframe.mapper", "keyframe.loopcloser", "vi.preintegrate",
              "vi.refine")

    for s in samplers.values():
        s.armed = True
    vi_ms_at = {}
    latency, tracked = [], []
    setup_s = time.perf_counter() - T_START
    k = warm
    t0 = time.perf_counter()
    while True:
        if k >= n_frames:
            raise RuntimeError(f"the traffic ran out of frames after {k - warm} window frames")
        i = k - warm
        cur[0] = i
        if traced and i == trace_from:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if cuda
                                             else []))
            prof.__enter__()
            profiling[0] = True
        vi_before = len(timer.ms["vi.preintegrate"]), len(timer.ms["vi.refine"])
        t_call = time.perf_counter()
        with torch.profiler.record_function(trace_mod.FRAME):
            pose = feed(k)
        t_end = time.perf_counter()
        latency.append((t_end - t_call) * 1e3)
        tracked.append(pose is not None)
        if traced:
            vi_ms_at[i] = (sum(timer.ms["vi.preintegrate"][vi_before[0]:])
                           + sum(timer.ms["vi.refine"][vi_before[1]:]))
            if prof is not None and i == trace_from + trace_n - 1:
                sync()
                prof.__exit__(None, None, None)
                profiling[0] = False
        k += 1
        if t_end - t0 >= args.seconds:
            break
    window_s = t_end - t0
    if profiling[0]:  # the window ended inside the traced slice
        sync()
        prof.__exit__(None, None, None)
        profiling[0] = False
    spans = []
    if traced:
        GLOBAL_TIMER.enabled = False
        spans = trace_mod.take_spans(GLOBAL_TIMER)
    patches.restore()
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)

    n = len(latency)
    n_ok = sum(map(bool, tracked))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"correct": False, "attempted": n, "failed": n - n_ok, "metrics": {}}
    e2e = window_metrics(latency, tracked, window_s)
    e2e["setup_s"] = setup_s

    # the trajectory the window's frames produced, then the program's state freed
    est = {ts: T for ts, T in slam.trajectory()}
    events = {"keyframes": slam.n_keyframes(), "loops": slam.loopcloser.n_loops,
              "maps": slam.map.n_maps, "imu_init": bool(slam.map.map_imu_init.get(
                  slam.map.active_map, False)), "viba1": slam.mapper.viba1_done,
              "viba2": slam.mapper.viba2_done}
    del slam, entry
    if cuda:
        torch.cuda.empty_cache()

    win = slice(warm, warm + n)
    mono = cfg["sensor"] == "mono"
    ctx = check.Context(cam=cam, control=bool(args.control), seed=args.seed,
                        samples=spec["samples"], mono=mono)
    t_check = time.perf_counter()
    numbers = check.numbers(ctx, checks, samplers, limits)
    program_numbers = None
    if args.control:  # the program's own readings on the same samples, beside the control's
        program_numbers = check.numbers(dataclasses.replace(ctx, control=False), checks,
                                        samplers, limits)
    e2e["rpe_mm"] = check.rpe_mm(est, frames.times[win], frames.T_cw[win], mono)
    check_s = time.perf_counter() - t_check
    verdict = all(v <= lim for v, lim in numbers.values()) and set(numbers) == set(limits)
    result["correct"] = bool(verdict)
    lines = [f"{name} {v!r} limit {lim!r}" for name, (v, lim) in numbers.items()]
    for name in limits:
        if name not in numbers:
            lines.append(f"{name} missing limit {limits[name]!r}")

    if traced:
        port_spans = set(StageTimer.STAGES) | {s["name"] for s in spans + warmup_spans}
        summary = trace_mod.reduce(prof, ranges, port_spans) if prof is not None else {}
        wm_bounds = [check.window_match_bound_s(a) for a in wm_args]
        mctx = {"latency_ms": latency, "tracked": tracked, "keyframe_at": keyframe_at,
                "timer_ms": dict(timer.ms), "vi_ms_at": vi_ms_at, "trace": summary,
                "trace_from": trace_from, "wm_bounds_s": wm_bounds, "rpe_mm": e2e["rpe_mm"],
                "inertial": frames.imu is not None, "spans": spans,
                "warmup_spans": warmup_spans, "events": events, "warmup_frames": warm}
        for m in cell["per_layer"]:
            value = metric_reader(m["name"])(mctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
        result["spans"] = trace_mod.table(spans, summary)
        busy, wall = summary.get("busy_s", 0.0), summary.get("window_s", 0.0)
    else:
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else device.type,
                        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak),
                        "power_limit_w": power_limit()}
    if traced:
        result["device"].update(busy_s=busy, window_s=wall)
    result["events"] = events
    result["window"] = {"frames": n, "seconds": window_s, "warmup_frames": warm,
                        "rpe_mm": e2e["rpe_mm"] if math.isfinite(e2e["rpe_mm"]) else None,
                        "first_frame": int(spec["start_frame"]) + warm,
                        "check_s": check_s,
                        "no_pose_at": [i for i, ok in enumerate(tracked) if not ok]}
    if traced:
        result["window"]["keyframe_at"] = sorted(keyframe_at)
    result["sampled"] = {name: [i for i, _ in s.kept] for name, s in samplers.items()}
    if program_numbers is not None:
        result["program_checks"] = {name: {"value": v, "limit": lim}
                                    for name, (v, lim) in program_numbers.items()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    return result, lines


def _finite(result: dict) -> bool:
    """Replace each non-finite value of the metrics and checks (a tail over
    frames that returned no pose, an RPE over too few pairs) by 1e30 and
    mark the run not correct; True where all were finite."""
    ok = True
    for group in ("metrics", "checks"):
        for entry in result.get(group, {}).values():
            if not math.isfinite(entry["value"]):
                entry["value"], ok = 1e30, False
    if not ok:
        result["correct"] = False
    return ok


class ForbiddenImport(RuntimeError):
    pass


def power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    import torch

    cell = load_cell(args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"slambench: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import orb_slam3_comments_ghr_torch as port

    if not Path(port.__file__).resolve().is_relative_to(ROOT):
        print(f"slambench: {PORT} was imported from {port.__file__}, outside {ROOT}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result, lines = run(args, torch.device("cuda", 0))
    except ForbiddenImport as e:
        print(f"slambench: modules of JAX or the JAX package are loaded: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"slambench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    if not _finite(result):
        lines.append("a metric or number is not finite: not correct")
    sys.stderr.write("\n".join(lines) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
