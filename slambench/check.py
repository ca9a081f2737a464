"""The output check: each number compared beside its limit.

Each limit of a cell (`limits/<cell>.json`) names a check, the module
`checks/<name>.py`, found by that name; a new check is a new file there.
A check module states:

- `CALL`: the port's call it samples, either a module-level function under
  the port's package (`"optim.vi_ba.vi_bundle_adjust"`) or an attribute of
  the run's `SLAM` (`"slam.tracker._pose_inertial"`), wrapped only where it
  exists;
- `SAMPLE`: the key of the traffic's `samples` that sizes its draw;
- `picks(rng, samples)`: which of the window's calls it keeps, counted from
  0 at the window's first call: how many it draws, and from how many first
  calls. All checks of a cell draw from one generator seeded by the run's
  seed, in the order of their `SAMPLE` keys in the traffic's `samples`, so
  the same seed samples the same calls;
- `keep(args, kwargs, out)` (optional): what it keeps of a call, copied on
  the device as the call returns (by default all three);
- `number(kept, ctx)`: its number from the kept calls, a list of (call
  index, copy), by the plain references (`reference.py`, or a file of the
  check's own): the program's output where `ctx.control` is false, else the
  control's, the reference computed in bfloat16 in the program's place.
  None where nothing could be compared, which fails the run.

`rpe_mm` works out the per-layer metric of that name. The trajectory is not
compared: on an H100 the generated motion in bfloat16 (the control of
`rpe_mm`) read 1.5-2.9 mm RPE where the program read 3.7-11.6, so no limit
separates the two (PERF.md).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

from . import probes
from . import reference as ref

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Context:
    cam: dict
    control: bool
    seed: int
    samples: dict   # the traffic's `samples`
    mono: bool


def load_module(path: Path, prefix: str):
    """The module of one file, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(limits: dict, samples: dict, here: Path = HERE) -> dict:
    """{name: check module} for each limit, in the order the checks draw;
    stops the run on a limit with no check module, or one whose `SAMPLE`
    the traffic's `samples` lack."""
    missing = [n for n in limits if not (here / "checks" / f"{n}.py").is_file()]
    if missing:
        raise SystemExit(f"slambench: no check for the limit(s) {missing}: "
                         f"{[f'slambench/checks/{n}.py' for n in missing]} not found")
    checks = {n: load_module(here / "checks" / f"{n}.py", "slambench_check") for n in limits}
    unsized = [n for n, mod in checks.items() if mod.SAMPLE not in samples]
    if unsized:
        raise SystemExit(f"slambench: the traffic's samples size no draw of the check(s) "
                         f"{unsized} ({[checks[n].SAMPLE for n in unsized]})")
    order = list(samples)
    return dict(sorted(checks.items(), key=lambda kv: order.index(kv[1].SAMPLE)))


def samplers(checks: dict, samples: dict, seed: int) -> dict:
    """{name: probes.Sampler} of each check, its picks drawn from the seed."""
    rng = np.random.default_rng(seed)
    return {name: probes.Sampler(mod.picks(rng, samples), keep=getattr(mod, "keep", None))
            for name, mod in checks.items()}


def numbers(ctx: Context, checks: dict, samplers: dict, limits: dict) -> dict:
    """{name: (number, limit)} for each limit whose number could be worked
    out; a limit left out had nothing to compare, which fails the run."""
    out = {}
    with torch.no_grad():
        for name, limit in limits.items():
            value = checks[name].number(samplers[name].kept, ctx)
            if value is not None:
                out[name] = (float(value), float(limit))
    return out


def window_match_bound_s(args) -> float:
    """The least time (s) of one window-match launch on its arguments."""
    return ref.window_match_bound(args, ref.window_pairs(args))[0]


def rpe_mm(est: dict, times: np.ndarray, gt: np.ndarray, mono: bool) -> float:
    """`rpe_mm` of the window's tracked frames (inf under 20 pairs): `est`
    maps a timestamp to the T_cw the program gave it, `times` and `gt` are
    the window's frame times and true T_cw."""
    keep = [k for k, ts in enumerate(times) if float(ts) in est]
    if len(keep) < 3:
        return float("inf")
    gt_wc = np.linalg.inv(gt[keep])
    est_wc = np.linalg.inv(np.stack([est[float(times[k])] for k in keep]).astype(np.float64))
    value, pairs = ref.rpe(est_wc, gt_wc, times[keep], 1.0, mono)
    return value * 1e3 if pairs >= 20 else float("inf")
