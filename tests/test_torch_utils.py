"""The port's trackers, logger, metrics writer and profiling helpers
against the reference's: the trackers on the same count sequences and the
same clock; the event file read back by tensorboard's own loader to the
(tag, step, value) triples the reference's MetricsWriter writes."""

import logging
import os
import time

import pytest

from surreal_tpu.utils import trackers as jtrackers
from surreal_tpu_torch.train.metrics import MetricsWriter, _masked_crc32c
from surreal_tpu_torch.utils import logger, profiling
from surreal_tpu_torch.utils import trackers as ttrackers
import torch_helpers  # noqa: F401  (one torch thread a test process)


@pytest.fixture
def clock(monkeypatch):
    """time.monotonic replaced by a clock the test advances."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


@pytest.mark.parametrize("period,init,counts", [
    (10, 0, list(range(1, 35))),
    (10, 0, [25, 29, 30, 31, 55, 56]),  # jumps past several periods fire once
    (32768, 98304, [131072, 163840, 196608, 229376]),  # a resumed run's trigger
])
def test_periodic_tracker_matches_the_reference(period, init, counts):
    fires = [[c for c in counts if t.track(c)]
             for t in (jtrackers.PeriodicTracker(period, init),
                       ttrackers.PeriodicTracker(period, init))]
    assert fires[0] == fires[1] and fires[0]


def test_timed_tracker_matches_the_reference(clock):
    trackers = [jtrackers.TimedTracker(0.5), ttrackers.TimedTracker(0.5)]
    seen = [[], []]
    for dt in (0.1, 0.3, 0.2, 0.6, 0.1, 1.5):
        clock[0] += dt
        for out, t in zip(seen, trackers):
            out.append(t.track())
    assert seen[0] == seen[1] and any(seen[0]) and not all(seen[0])


def test_throughput_tracker_matches_the_reference(clock):
    trackers = [jtrackers.ThroughputTracker(), ttrackers.ThroughputTracker(smoothing=0.9)]
    rates = [[], []]
    for dt, count in ((0.0, 0), (2.0, 32768), (1.5, 65536), (0.0, 65536), (3.0, 98304)):
        clock[0] += dt
        for out, t in zip(rates, trackers):
            out.append(t.update(count))
    assert rates[0] == rates[1] and rates[0][-1] > 0


def test_logger_name_and_host_file(tmp_path, monkeypatch):
    root = logging.getLogger(logger.ROOT)
    handlers = list(root.handlers)
    monkeypatch.setattr(logger, "_configured", False)
    try:
        log = logger.get_logger("testmod", logdir=str(tmp_path))
        assert log.name == "surreal_tpu_torch.testmod"
        assert logger.get_logger("surreal_tpu_torch.x").name == "surreal_tpu_torch.x"
        log.info("hello %d", 42)
        for h in root.handlers:
            h.flush()
        assert os.listdir(tmp_path) == ["host-0.log"]
        assert "hello 42" in (tmp_path / "host-0.log").read_text()
    finally:
        for h in root.handlers:
            if h not in handlers:
                root.removeHandler(h)
                h.close()


WRITES = [(10, {"loss": 1.0, "kl": 0.1}, None),
          (20, {"return_mean": 5.0, "episodes": 16}, "eval"),
          (2 ** 40, {"env_steps_per_s": 12345.678, "neg": -3.5}, None)]


def _read_triples(logdir):
    """(tag, step, value) of every scalar in the one event file under
    logdir, as tensorboard's loader reads it (simple values and TF2 scalar
    summaries both come out as scalar tensors)."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    (name,) = os.listdir(logdir)
    assert "tfevents" in name
    out = []
    for ev in EventFileLoader(os.path.join(logdir, name)).Load():
        for v in ev.summary.value:
            out.append((v.tag, ev.step, float(tensor_util.make_ndarray(v.tensor))))
    return out


def test_metrics_writer_reads_back_as_the_reference_writes(tmp_path):
    from surreal_tpu.train.metrics import MetricsWriter as RefWriter

    got = {}
    for label, cls in (("ref", RefWriter), ("port", MetricsWriter)):
        w = cls(str(tmp_path / label), section="learner")
        for step, scalars, section in WRITES:
            w.write(step, scalars, section=section)
        w.close()
        got[label] = _read_triples(tmp_path / label)
    assert got["port"] == got["ref"]
    assert ("eval/return_mean", 20, 5.0) in got["port"]
    assert len(got["port"]) == 6


def test_masked_crc32c_known_value():
    # CRC-32C("123456789") = 0xE3069283, masked as TFRecord masks it
    crc = 0xE3069283
    assert _masked_crc32c(b"123456789") == (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_metrics_writer_disabled_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = MetricsWriter(None)
    w.write(1, {"x": 1.0})
    w.close()
    assert os.listdir(tmp_path) == []


def test_profiling_trace_and_memory_stats(tmp_path):
    import torch

    with profiling.trace(str(tmp_path / "tb")):
        torch.ones(64).sum()
    (name,) = os.listdir(tmp_path / "tb")
    assert name.startswith("trace-") and name.endswith(".json")
    assert (tmp_path / "tb" / name).stat().st_size > 0
    assert profiling.device_memory_stats() == {}  # no card here
