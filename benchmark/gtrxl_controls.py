"""The readings the limits of the GTrXL cell's `correct` are set from, at the
cell's own size, on the chip (the benchmark's runs never run this):

- the program: its first iteration and one after `--window-iterations`
  more, captured and judged as in a run, on each of `--seeds` (the lower
  readings are the largest of these);
- the control: the reference put in the program's place and computed in
  TF32, the nearest precision below the configuration's float32 with TF32
  off (`reference/gtrxl_ppo.produce`), on each of `--control-seeds`;
- the faults, planted in the program (`FAULTS`), its first iteration and
  the next captured and judged, on each of `--control-seeds`.

    python3 benchmark/gtrxl_controls.py --workload ppo_gtrxl.cheetah_e1024_m512 \\
        --seeds 1 2 ... --control-seeds 7 8 9 --window-iterations 2 \\
        --out build/controls_gtrxl.json
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the program for the block:
    - 'ignore_starts': the attention's mask ignores episode starts (every
      slot written since the clock began is seen, in the decode and in the
      update's segment);
    - 'stale_cache': the keys and values are not rebuilt after the update
      (each rollout reuses the previous rollout's cache);
    - 'wrong_offset': the relative distance of every memory slot off by one."""
    from surreal_tpu_torch.models import gtrxl

    saved = {k: getattr(gtrxl.GTrXL, k) for k in ("step", "segment", "prefill")}
    saved_dist = gtrxl.slot_distances
    if fault == "ignore_starts":
        def step(self, x, cache, t, valid, write=True):
            seen = gtrxl.slot_distances(t, self.memory, x.device) <= t
            return saved["step"](self, x, cache, t, seen.expand_as(valid).clone(), write)

        def segment(self, x_seq, memory, valid, done, t0):
            seen = gtrxl.slot_distances(t0, self.memory, x_seq.device) <= t0
            return saved["segment"](self, x_seq, memory, seen.expand_as(valid),
                                    done.new_zeros(done.shape), t0)

        gtrxl.GTrXL.step, gtrxl.GTrXL.segment = step, segment
    elif fault == "stale_cache":
        def prefill(self, memory):
            kept = getattr(self, "_stale_cache", None)
            if kept is None:
                kept = self._stale_cache = saved["prefill"](self, memory)
            kept.memory = memory
            return kept

        gtrxl.GTrXL.prefill = prefill
    elif fault == "wrong_offset":
        def slot_distances(t, memory, device=None):
            return (saved_dist(t, memory, device) + 1).clamp(max=memory)

        gtrxl.slot_distances = slot_distances
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(gtrxl.GTrXL, k, v)
        gtrxl.slot_distances = saved_dist


FAULTS = ("ignore_starts", "stale_cache", "wrong_offset")


def program_caps(config: dict, cell: dict, seed: int, dev, task, window_iterations: int):
    from benchmark.drivers import ppo_gtrxl as drv_mod

    drv = drv_mod.Driver(config, cell["traffic"], seed, dev, task)
    caps = [drv.captured_iteration()]
    for _ in range(window_iterations):
        drv.iterate()
    caps.append(drv.captured_iteration())
    drv.close()
    del drv
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    return caps


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=list(FAULTS))
    p.add_argument("--window-iterations", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.drivers import ppo_gtrxl as drv_mod
    from benchmark.reference import gtrxl_judge, gtrxl_ppo

    cell, config = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    task = drv_mod.load_task(config, dev)
    if dev.type == "cuda":
        from surreal_tpu_torch.ops import build
        build.build_all()
    spec, cfg = drv_mod.net_spec(config, task), dict(config["ppo"])
    out = {"cell": args.workload, "window_iterations": args.window_iterations,
           "program": {}, "control": {}, "faults": {f: {} for f in args.faults}}

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds:
        t0 = time.perf_counter()
        caps = program_caps(config, cell, seed, dev, task, args.window_iterations)
        out["program"][seed] = gtrxl_judge.judge_all(caps, spec, cfg, task, dev)
        del caps
        print(f"program seed {seed}: {out['program'][seed]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        save()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        w, rows, start_t, perms = drv_mod.inputs(config, cell["traffic"], spec, task, seed, dev)
        cap = gtrxl_ppo.produce(spec, cfg, task, w, rows, start_t, perms, seed + 1, tf32=True)
        out["control"][seed] = gtrxl_judge.judge_one(cap, spec, cfg, task, dev)
        del cap
        print(f"control seed {seed}: {out['control'][seed]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        save()
        for fault in args.faults:
            t0 = time.perf_counter()
            with planted(fault):
                caps = program_caps(config, cell, seed, dev, task, 0)
            out["faults"][fault][seed] = gtrxl_judge.judge_all(caps, spec, cfg, task, dev)
            del caps
            print(f"{fault} seed {seed}: {out['faults'][fault][seed]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            save()
    names = sorted({k for runs in out["program"].values() for k in runs})
    summary = {}
    for k in names:
        row = {"lower": max(r[k] for r in out["program"].values())}
        if out["control"]:
            row["control"] = min(r[k] for r in out["control"].values())
        for f in args.faults:
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
