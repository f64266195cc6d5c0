"""The benchmark of surreal_tpu_torch, driven by data.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`), its traffic, its chips and the limits of the
numbers that decide `correct`. The configuration names its driver
(`drivers/<driver>.py`; the cell's traffic may name another, such as one
that spreads the trainer over ranks). The driver's `run` builds and drives
the program, measures the window, and has its own reference judge what the
program produced; this file knows nothing of any algorithm. The metrics a
run prints are those that BENCHMARK.json lists for the cell, end-to-end ones
in a run with `--trace 0` and per-layer ones with `--trace 1`; each is read
by `metrics/<name>.py`, whose `read(ctx)` returns a number or None (nothing
to read: the metric is left out of the line).

What a driver's `run(cell, config, seed, seconds, trace, device, t_start)`
returns: (ctx, numbers). `numbers` are the judged numbers, by the names of
the cell's limits. `ctx` holds at least `setup_s`, `trace`, `window` (as
`timed_window` gives it) and `memory_peak_bytes` (the fullest card's); in
a traced run also `busy_s` and `window_s` (the device's busy seconds,
averaged over the cards, in a traced window of that length) and
`breakdown`; and whatever its metrics' readers read.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "surreal_tpu")
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ASSETS = ROOT / "surreal_tpu" / "envs" / "assets"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    cell = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    return cell, config


def driver_of(cell: dict, config: dict):
    """The cell's driver module: the traffic's `driver`, else the
    configuration's."""
    name = cell["traffic"].get("driver", config["driver"])
    return importlib.import_module(f"benchmark.drivers.{name}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics BENCHMARK.json has the cell report in this kind of run."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def read_metrics(entries: list[dict], ctx: dict) -> dict:
    out = {}
    for m in entries:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def checks_against(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def timed_window(iterate, seconds: float, sync, samples_per_iteration: int) -> dict:
    """Whole iterations of `iterate` until `seconds` have passed on the host
    clock, a synchronise at each end (the timing of
    surreal_tpu_torch/cli/bench.py, frozen here: work over the time around
    whole iterations)."""
    sync()
    t0 = time.perf_counter()
    ends = []
    while not ends or ends[-1] < seconds:
        iterate()
        ends.append(time.perf_counter() - t0)
    sync()
    window_s = time.perf_counter() - t0
    print("window: iterations end at " + " ".join(f"{e:.3f}" for e in ends) + " s",
          file=sys.stderr)
    return {"iterations": len(ends), "seconds": window_s, "opened": t0,
            "samples": len(ends) * samples_per_iteration}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple[dict, dict]:
    """Runs one cell; returns (ctx, numbers compared)."""
    import torch

    cell, config = load_cell(cell_name)
    return driver_of(cell, config).run(cell, config, seed, seconds, trace,
                                       torch.device(device), t_start)


def device_info(ctx: dict, chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": ctx.get("memory_peak_bytes", 0)}
    if ctx["trace"]:
        info["busy_s"], info["window_s"] = ctx["busy_s"], ctx["window_s"]
    return info


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="The benchmark of surreal_tpu_torch: one run of "
                                            "one cell, its result as the last line of stdout.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    ctx, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                            t_start)
    return report(bench, args.workload, cell, ctx, numbers)


def report(bench: dict, cell_name: str, cell: dict, ctx: dict, numbers: dict) -> int:
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    correct, checks = checks_against(numbers, cell["limits"])
    metrics = read_metrics(cell_metrics(bench, cell_name, ctx["trace"]), ctx)
    result = {"correct": correct, "attempted": ctx["window"]["iterations"], "failed": 0,
              "metrics": metrics, "device": device_info(ctx, cell["chips"])}
    if ctx["trace"]:
        result["breakdown"] = ctx["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0
