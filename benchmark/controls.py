"""The readings the limits of `correct` are set from, for one cell at its
own size, on the chip (the benchmark's runs never run this):

- the program: its first iteration and one after `--window-iterations`
  more captured and judged, as in a run, on each of `--seeds` (the lower
  readings are the largest of these);
- the control: the reference put in the program's place and computed in
  TF32, the nearest precision below the configuration's float32 with TF32
  off, on each of `--control-seeds` (its smallest readings are the upper
  ones, where they are 3x the lower or more);
- the faults, planted in the reference put in the program's place
  (`reference/producer.py`), on each of `--control-seeds`.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 --window-iterations 15 --out chiprun_out/controls_<cell>.json
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

FAULTS = ("frozen", "half_batch", "no_noise", "altered_reward")


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=list(FAULTS))
    p.add_argument("--window-iterations", type=int, default=15)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.drivers import ppo as drv_mod
    from benchmark.reference import judge, producer

    cell, config = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    task = drv_mod.load_task(config, dev)
    if dev.type == "cuda":
        from surreal_tpu_torch.ops import build
        build.build_all()
    spec, cfg = drv_mod.net_spec(config, task), drv_mod.reference_cfg(config)
    faults = args.faults
    out = {"cell": args.workload, "window_iterations": args.window_iterations,
           "program": {}, "control": {}, "faults": {f: {} for f in faults}}

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = drv_mod.Driver(config, cell["traffic"], seed, dev, task)
        caps = [drv.captured_iteration()]
        for _ in range(args.window_iterations):
            drv.iterate()
        caps.append(drv.captured_iteration())
        drv.close()
        del drv
        gc.collect()
        details = {}
        out["program"][seed] = judge.judge_all(caps, spec, cfg, task, dev, details=details)
        out.setdefault("details", {})[seed] = details
        print(f"program seed {seed}: {out['program'][seed]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        save()
    for seed in args.control_seeds:
        w, rows, start_t, perms = drv_mod.inputs(config, cell["traffic"], spec, task, seed, dev)
        runs = [("control", None, True)] + [(f, f, False) for f in faults]
        for label, fault, tf32 in runs:
            t0 = time.perf_counter()
            cap = producer.produce(spec, cfg, task, w, rows, start_t, perms, seed + 1,
                                   tf32=tf32, fault=fault)
            nums = judge.judge(cap, spec, cfg, task, dev)
            (out["control"] if label == "control" else out["faults"][label])[seed] = nums
            print(f"{label} seed {seed}: {nums} ({time.perf_counter() - t0:.1f} s)", flush=True)
            save()
    names = sorted({k for runs in out["program"].values() for k in runs})
    summary = {}
    for k in names:
        row = {"lower": max(r[k] for r in out["program"].values())}
        if out["control"]:
            row["control"] = min(r[k] for r in out["control"].values())
        for f in faults:
            if out["faults"][f]:
                row[f] = min(r[k] for r in out["faults"][f].values())
        summary[k] = row
    out["summary"] = summary
    save()
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main(sys.argv[1:]))
