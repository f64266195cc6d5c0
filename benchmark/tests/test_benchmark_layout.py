"""The harness finds cells, configurations and metrics by name in files of
their own; BENCHMARK.json agrees with those files and keeps the contract's
shape; a new cell, configuration or metric needs new files only; a run's
last line has the keys the contract names."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import harness
from benchmark.tests.bench_fixtures import tiny_cells  # noqa: F401 (a fixture)

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree_with_benchmark_json(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w, c = harness.load_cell(cell)
    assert (w["name"], w["config"], w["chips"], w["why"]) == (
        cell, entry["config"], entry["chips"], entry["why"])
    assert w["traffic"]["name"] == entry["traffic"]
    assert c["name"] == entry["config"]
    cfg_entry = next(x for x in BENCH["configs"] if x["name"] == c["name"])
    assert cfg_entry["file"] == f"benchmark/configs/{c['name']}.json"
    assert cfg_entry["source"] == c["source"] and cfg_entry["reduced"] == c["reduced"]
    assert callable(harness.driver_of(w, c).run)
    importlib.import_module(f"benchmark.reference.tasks.{c['task']}")
    assert w["limits"], "a cell compares numbers against limits"
    e2e = harness.cell_metrics(BENCH, cell, False)
    assert {"setup_s"} < {m["name"] for m in e2e}
    assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader(metric):
    mod = importlib.import_module(f"benchmark.metrics.{metric}")
    assert callable(mod.read)


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_config_and_metric_need_new_files_only(tiny_cells, monkeypatch, tmp_path):
    """A configuration, a cell and a per-layer metric written as new files
    only, found by name."""
    import benchmark.metrics

    metric_dir = tmp_path / "more_metrics"
    metric_dir.mkdir()
    (metric_dir / "iterations_in_window.py").write_text(
        "def read(ctx):\n    return ctx['window']['iterations']\n")
    monkeypatch.setattr(benchmark.metrics, "__path__", [*benchmark.metrics.__path__,
                                                        str(metric_dir)])
    bench = {"end_to_end": [], "per_layer": [
        {"name": "iterations_in_window", "unit": "iterations", "better": "higher",
         "source": "program_counter", "layer": "Trainer", "moves": "samples_per_s",
         "workloads": ["tiny_ppo_mlp.t"]}]}
    cell, config = harness.load_cell("tiny_ppo_mlp.t")
    assert config["name"] == "tiny_ppo_mlp" and cell["traffic"]["num_envs"] == 8
    entries = harness.cell_metrics(bench, "tiny_ppo_mlp.t", True)
    assert harness.read_metrics(entries, {"window": {"iterations": 7}}) == {
        "iterations_in_window": {"value": 7, "unit": "iterations"}}
    assert harness.cell_metrics(bench, "other.cell", True) == []


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    ctx = {"trace": True, "window": {"iterations": 3, "seconds": 10.0, "samples": 30000}}
    assert harness.read_metrics(BENCH["per_layer"], ctx) == {}


STUB_DRIVER = """
import time

from benchmark import harness
from benchmark.drivers import stub_judge


def run(cell, config, seed, seconds, trace, device, t_start):
    done = []
    def iterate():
        time.sleep(0.002)
        done.append(seed % 7)
    window = harness.timed_window(iterate, seconds, lambda: None,
                                  config["samples_per_iteration"])
    ctx = {"trace": trace, "setup_s": window["opened"] - t_start, "window": window,
           "memory_peak_bytes": 1, "answers": done}
    if trace:
        ctx.update(busy_s=0.001, window_s=seconds,
                   breakdown={"device_ops": [], "idle_gaps": []})
    return ctx, stub_judge.judge(done, seed, cell["traffic"]["offset"])
"""

STUB_JUDGE = """
def judge(answers, seed, offset):
    return {"wrong_answers": sum(a + offset != seed % 7 for a in answers)}
"""


@pytest.mark.parametrize("offset,correct", [(0, True), (1, False)])
def test_a_new_algorithm_needs_new_files_only(tiny_cells, monkeypatch, tmp_path, capsys,
                                              offset, correct):
    """A configuration of another algorithm, its driver and judge, its cell
    and its metric: new files and entries only, run through the harness
    (its look for a card skipped) to the last line."""
    import torch

    import benchmark.drivers
    import benchmark.metrics

    extra = tmp_path / "more"
    extra.mkdir()
    (extra / "stub_algo.py").write_text(STUB_DRIVER)
    (extra / "stub_judge.py").write_text(STUB_JUDGE)
    (extra / "answers_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx['answers']) or None\n")
    monkeypatch.setattr(benchmark.drivers, "__path__", [*benchmark.drivers.__path__, str(extra)])
    monkeypatch.setattr(benchmark.metrics, "__path__", [*benchmark.metrics.__path__, str(extra)])
    (tiny_cells / "configs" / "stub.json").write_text(json.dumps(
        {"name": "stub", "driver": "stub_algo", "samples_per_iteration": 10}))
    (tiny_cells / "workloads" / "stub.x.json").write_text(json.dumps(
        {"name": "stub.x", "config": "stub", "chips": 1, "why": "a stub",
         "traffic": {"name": "x", "offset": offset}, "limits": {"wrong_answers": 0}}))
    bench = {"end_to_end": [m for m in BENCH["end_to_end"]], "per_layer": [
        {"name": "answers_in_window", "unit": "answers", "better": "higher",
         "source": "program_counter", "layer": "Stub", "moves": "samples_per_s",
         "workloads": ["stub.x"]}]}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    cell, _ = harness.load_cell("stub.x")
    for trace in (False, True):
        ctx, numbers = harness.run_cell("stub.x", 2**33 + 5, 0.05, trace, "cpu", 0.0)
        assert harness.report(bench, "stub.x", cell, ctx, numbers) == 0
        line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
        assert line["correct"] is correct
        names = {"answers_in_window"} if trace else {"samples_per_s", "setup_s"}
        assert set(line["metrics"]) == names
        assert line["checks"]["wrong_answers"]["limit"] == 0


def test_the_last_line_has_the_contract_keys(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    cell, _ = harness.load_cell(CELLS[0])
    ctx = {"trace": False, "setup_s": 12.5, "memory_peak_bytes": 123,
           "window": {"iterations": 3, "seconds": 10.0, "samples": 30000}}
    numbers = {k: 0.0 for k in cell["limits"]}
    assert harness.report(BENCH, CELLS[0], cell, ctx, numbers) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"samples_per_s": {"value": 3000.0, "unit": "samples/s"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert set(line["checks"]) == set(cell["limits"])
    assert err.strip().splitlines()[-1].startswith("check ")
    numbers[next(iter(numbers))] = float("nan")
    harness.report(BENCH, CELLS[0], cell, ctx, numbers)
    assert json.loads(capsys.readouterr()[0].strip().splitlines()[-1])["correct"] is False
