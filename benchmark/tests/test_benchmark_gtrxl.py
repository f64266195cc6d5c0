"""The GTrXL cell and the four-rank cell: the readers of their five
per-layer metrics on profiles built by hand (each event (name, start ns,
duration ns, correlation id), as their drivers record them), the operation
counts against a count by hand, the two cells' layout, and each cell's
driver run tiny on the CPU through the harness: correct as it stands,
incorrect with a fault planted in the program."""

from __future__ import annotations

import json

import pytest

from benchmark import gtrxl_flops, harness, profile
from benchmark.metrics import (
    allreduce_ms_per_update,
    gtrxl_decode_attention_roofline,
    gtrxl_decode_ms_per_step,
    gtrxl_update_ms_per_minibatch,
    mfu_gtrxl,
)

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
GTRXL, DP4 = "ppo_gtrxl.cheetah_e1024_m512", "ppo_mlp.cheetah_dp4"
NET = {"obs_dim": 17, "action_dim": 6, "layers": 2, "width": 8, "heads": 2, "memory": 4,
       "mlp_width": 16}


def _rollout_part(steps: int = 2) -> dict:
    """Each step: a policy span holding a decode (two layers' attention
    spans, each one launch of 300 ns on the device, and a cache write of
    one launch of 50 ns), and a done check holding a probe's decode (one
    launch of 1,000 ns, not the policy's)."""
    host, dev, corr = [], [], iter(range(1, 10_000))
    for k in range(steps):
        t0 = 1000 * (k + 1) * 100
        host += [("ppo.rollout.step", t0, 5000), ("ppo.rollout.policy", t0 + 1, 3000, ),
                 ("gtrxl.decode", t0 + 2, 2500)]
        for layer in range(2):
            c = next(corr)
            host += [("gtrxl.attention", t0 + 10 + 100 * layer, 50),
                     ("cudaLaunchKernel", t0 + 11 + 100 * layer, 5, c)]
            dev.append(("attention_kernel", t0 + 20_000, 300, c))
        c = next(corr)
        host += [("gtrxl.cache_write", t0 + 500, 50), ("cudaMemcpyAsync", t0 + 501, 5, c)]
        dev.append(("Memcpy DtoD (Device -> Device)", t0 + 21_000, 50, c))
        c = next(corr)
        host += [("ppo.rollout.done_check", t0 + 3500, 1000), ("gtrxl.decode", t0 + 3600, 500),
                 ("cudaLaunchKernel", t0 + 3700, 5, c)]
        dev.append(("probe_kernel", t0 + 22_000, 1000, c))
    host = [h if len(h) == 4 else (*h[:3], 0) for h in host]
    return {"host": [h[:3] for h in host], "device": [d[:3] for d in dev], "host_corr": host,
            "device_corr": dev, "wall_s": 1.0}


def test_decode_readers_count_the_policys_decode_only():
    ctx = {"profile": {"rollout": _rollout_part(), "num_envs": 3, "steps": 2}, "net": NET}
    # (2 x 300 + 50) ns a step: the probe's decode is the done check's
    assert gtrxl_decode_ms_per_step.read(ctx) == pytest.approx(650e-6)
    least = profile.bound(*gtrxl_flops.decode_attention_cost(NET, 3))
    want = 100.0 * least * 2 * 2 / (2 * 2 * 300e-9)
    assert gtrxl_decode_attention_roofline.read(ctx) == pytest.approx(want)


def test_readers_without_spans_or_correlation_return_none():
    part = _rollout_part()
    bare = {**part, "host_corr": [h for h in part["host_corr"] if not h[0].startswith("gtrxl.")]}
    for p in (bare, {**part, "host_corr": None}, {**part, "device_corr": []}):
        ctx = {"profile": {"rollout": p, "num_envs": 3, "update": p}, "net": NET}
        assert gtrxl_decode_ms_per_step.read(ctx) is None
        assert gtrxl_decode_attention_roofline.read(ctx) is None
        assert allreduce_ms_per_update.read(ctx) is None
    assert gtrxl_decode_ms_per_step.read({"trace": False}) is None
    assert allreduce_ms_per_update.read({"trace": False}) is None


def test_allreduce_reader_counts_the_nccl_launches_per_optimizer_step():
    host, dev = [], []
    for k in range(4):  # four minibatch steps, an all-reduce of 2 kernels each
        t0 = 1000 * k
        host += [("ppo.update.minibatch", t0, 900, 0), ("ppo.update.backward", t0 + 10, 500, 0),
                 ("cudaLaunchKernel", t0 + 20, 5, 100 + k),  # autograd's, outside
                 ("ppo.update.allreduce", t0 + 100, 200, 0),
                 ("cuLaunchKernelEx", t0 + 110, 5, 200 + k),
                 ("cudaLaunchKernelExC", t0 + 120, 5, 300 + k)]
        dev += [("backward_kernel", t0 + 50, 7000, 100 + k),
                ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", t0 + 300, 20_000, 200 + k),
                ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", t0 + 400, 4_000, 300 + k)]
    part = {"host": [h[:3] for h in host], "device": [d[:3] for d in dev], "host_corr": host,
            "device_corr": dev}
    assert allreduce_ms_per_update.read({"profile": {"update": part}}) == pytest.approx(0.024)


def test_update_and_mfu_readers():
    window = {"iterations": 3, "seconds": 30.0, "samples": 3000}
    cfg = {"horizon": 5, "epochs": 2, "num_minibatches": 2}
    timers = {"seconds": {"update": 0.8}, "calls": {"update": 1}, "minibatch_steps": 4}
    ctx = {"window": window, "cfg": cfg, "net": NET, "num_envs": 6, "timers": timers}
    assert gtrxl_update_ms_per_minibatch.read(ctx) == pytest.approx(200.0)
    ops = gtrxl_flops.iteration_flops(NET, 5, 6, 2, 2)
    assert mfu_gtrxl.read(ctx) == pytest.approx(100.0 * ops * 3 / 30.0 / 67e12)
    mlp = {**ctx, "net": {"obs_dim": 17, "action_dim": 6, "hidden": [16]}}
    assert gtrxl_update_ms_per_minibatch.read(mlp) is None and mfu_gtrxl.read(mlp) is None


def test_operation_counts_by_hand():
    """L 2, d 8, f 16, m 4, D 17, A 6; T 5, B 6, 2 epochs of 2 minibatches."""
    d, f, m, D, A, L = 8, 16, 4, 17, 6, 2
    dense = 2 * (d * d + 2 * d * d + d * d + 12 * d * d + 2 * d * f)  # 2 x 1,280 = 2,560
    assert dense == 2560
    assert gtrxl_flops.position_flops(NET, 5) == L * (2560 + 2 * 5 * d * 3) == 5600
    assert gtrxl_flops.embed_heads_flops(NET) == 2 * (D * d + d * (A + 1)) == 384
    prefill = L * (6 * m * 2 * d * 2 * d + (m + 1) * 2 * d * d)  # 2 x (6,144 + 640)
    assert gtrxl_flops.prefill_flops(NET, 6) == prefill == 13568
    rollout = prefill + 6 * 6 * (L * (2560 + 2 * 5 * d * 3) + 384)
    assert gtrxl_flops.rollout_flops(NET, 5, 6) == rollout
    fwd = 5 * (L * (2560 + 2 * 9 * d * 3) + 384) + L * m * 2 * d * 2 * d
    grads_free = L * m * 2 * d * 2 * d + 5 * 2 * D * d
    update = 2 * (6 * (3 * fwd - grads_free) + 2 * 2 * L * (m + 1) * 2 * d * d)
    assert gtrxl_flops.update_flops(NET, 5, 6, 2, 2) == update
    moved, ops = gtrxl_flops.decode_attention_cost(NET, 6)
    assert moved == 4 * (2 * 6 * m * d + 3 * 6 * d + (m + 1) * d + 6 * d) + 6 * m
    assert ops == 6 * (2 * (m + 1) * d * 3 + 5 * 2 * (m + 1))


def test_the_two_cells_layout():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert BENCH["workloads"][-2:] == [cells[DP4], cells[GTRXL]]
    assert cells[DP4]["chips"] == 4 and cells[GTRXL]["chips"] == 1
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 1
    w, c = harness.load_cell(DP4)
    assert c["name"] == "ppo_mlp" and w["traffic"]["driver"] == "ppo_dp"
    assert w["traffic"]["num_envs"] == 4 * 2048 and w["traffic"]["ranks"] == 4
    assert w["limits"]["rank_param_mismatch"] == 0
    w, c = harness.load_cell(GTRXL)
    assert c["driver"] == "ppo_gtrxl" and w["traffic"]["num_envs"] == 1024
    assert c["gtrxl"] == {"layers": 12, "width": 256, "heads": 8, "memory": 512,
                          "mlp_width": 1024}
    entry = next(x for x in BENCH["configs"] if x["name"] == "ppo_gtrxl")
    assert entry["reduced"] == c["reduced"]
    assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "width")) or
                k in ("layers", "heads", "memory")]
    new = {"gtrxl_decode_ms_per_step", "gtrxl_decode_attention_roofline",
           "gtrxl_update_ms_per_minibatch", "mfu_gtrxl"}
    for m in BENCH["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [GTRXL] and m["moves"] == "samples_per_s"
        elif m["name"] == "allreduce_ms_per_update":
            assert m["workloads"] == [DP4]
    for cell in (GTRXL, DP4):
        assert harness.cell_metrics(BENCH, cell, True)
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, False)} == {
            "samples_per_s", "setup_s"}


# ---- the drivers, tiny, on the CPU ----

@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Tiny copies of the two cells: GTrXL of 2 layers, width 32, 4 heads, a
    memory of 8, 8 envs, a chunk of 12, its envs' starts near their
    episodes' end; 2 gloo ranks of 4 envs each, (16, 16) networks."""
    import benchmark.drivers.ppo_gtrxl as drv

    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    c = json.loads((harness.HERE / "configs" / "ppo_gtrxl.json").read_text())
    c["name"] = "tiny_ppo_gtrxl"
    c["gtrxl"].update(layers=2, width=32, heads=4, memory=8, mlp_width=64)
    c["ppo"].update(horizon=12, epochs=2, num_minibatches=2)
    (tmp_path / "configs" / "tiny_ppo_gtrxl.json").write_text(json.dumps(c))
    w = json.loads((harness.HERE / "workloads" / f"{GTRXL}.json").read_text())
    w["name"], w["config"] = "tiny_ppo_gtrxl.t", "tiny_ppo_gtrxl"
    w["traffic"]["num_envs"] = 8
    (tmp_path / "workloads" / "tiny_ppo_gtrxl.t.json").write_text(json.dumps(w))
    c = json.loads((harness.HERE / "configs" / "ppo_mlp.json").read_text())
    c["name"], c["hidden"] = "tiny_ppo_mlp", [16, 16]
    c["ppo"].update(horizon=8, epochs=2, num_minibatches=2)
    (tmp_path / "configs" / "tiny_ppo_mlp.json").write_text(json.dumps(c))
    w = json.loads((harness.HERE / "workloads" / f"{DP4}.json").read_text())
    w["name"], w["config"] = "tiny_ppo_mlp.dp", "tiny_ppo_mlp"
    w["traffic"].update(num_envs=8, ranks=2, steps_to_episode_end=4)
    (tmp_path / "workloads" / "tiny_ppo_mlp.dp.json").write_text(json.dumps(w))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    orig = drv.inputs

    def inputs(*a, **k):  # starts within 20 steps of the episode's end: resets in the chunk
        weights, rows, start_t, perms = orig(*a, **k)
        return weights, rows, start_t % 20 + 980, perms

    monkeypatch.setattr(drv, "inputs", inputs)
    return tmp_path


def _run(cell: str, seed: int = 2**33 + 7) -> tuple[bool, dict]:
    c, _ = harness.load_cell(cell)
    ctx, numbers = harness.run_cell(cell, seed, 0.3, False, "cpu", 0.0)
    return harness.checks_against(numbers, c["limits"])[0], numbers


def test_the_tiny_gtrxl_cell_is_correct(tiny):
    correct, numbers = _run("tiny_ppo_gtrxl.t")
    assert correct, numbers


@pytest.mark.parametrize("fault", ["ignore_starts", "stale_cache", "wrong_offset"])
def test_a_fault_planted_in_the_gtrxl_program_reads_incorrect(tiny, fault):
    from benchmark.gtrxl_controls import planted

    with planted(fault):
        correct, numbers = _run("tiny_ppo_gtrxl.t")
    assert not correct, numbers


def test_the_tiny_dp_cell_is_correct_over_two_ranks(tiny):
    correct, numbers = _run("tiny_ppo_mlp.dp")
    assert correct and numbers["rank_param_mismatch"] == 0, numbers


def test_ranks_that_skip_the_all_reduce_read_incorrect(tiny):
    w = json.loads((tiny / "workloads" / "tiny_ppo_mlp.dp.json").read_text())
    w["traffic"]["fault"] = "no_allreduce"
    (tiny / "workloads" / "tiny_ppo_mlp.dp.json").write_text(json.dumps(w))
    correct, numbers = _run("tiny_ppo_mlp.dp")
    assert not correct and numbers["rank_param_mismatch"] > 0, numbers
