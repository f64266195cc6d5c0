"""`gtrxl_segment_attention_roofline`'s reader on update profiles built by
hand (each event (name, start ns, duration ns, correlation id), as a traced
GTrXL run's profile holds them), and its counts at the cell's shapes
against a count by hand."""

from __future__ import annotations

import pytest

from benchmark import profile
from benchmark.metrics import gtrxl_segment_attention_roofline as roofline

NET = {"obs_dim": 17, "action_dim": 6, "layers": 2, "width": 8, "heads": 2, "memory": 4,
       "mlp_width": 16}
CFG = {"horizon": 5, "epochs": 1, "num_minibatches": 2}


def _update_part(segments: int = 2, backward: bool = True) -> dict:
    """Each minibatch step: a segment span holding two layers' attention
    spans (one launch of 400 ns each), another launch of 1,000 ns in the
    segment outside them (the projections); a backward holding, per layer,
    an attention_backward span (one launch of 900 ns) when `backward`, and
    autograd's launches of 2,000 ns outside it."""
    host, dev, corr = [], [], iter(range(1, 10_000))
    for k in range(segments):
        t0 = 100_000 * (k + 1)
        host += [("ppo.update.minibatch", t0, 90_000, 0), ("ppo.update.loss", t0 + 1, 40_000, 0),
                 ("gtrxl.segment", t0 + 2, 30_000, 0)]
        c = next(corr)
        host.append(("cudaLaunchKernel", t0 + 3, 5, c))
        dev.append(("sgemm", t0 + 60_000, 1000, c))
        for layer in range(2):
            c = next(corr)
            host += [("gtrxl.attention", t0 + 100 + 1000 * layer, 500, 0),
                     ("cudaLaunchKernel", t0 + 101 + 1000 * layer, 5, c)]
            dev.append(("fwd_kernel", t0 + 61_000 + 1000 * layer, 400, c))
        host.append(("ppo.update.backward", t0 + 50_000, 30_000, 0))
        for layer in range(2):
            c = next(corr)
            t1 = t0 + 51_000 + 5000 * layer
            if backward:
                host.append(("gtrxl.attention_backward", t1, 1000, 0))
            host.append(("cudaLaunchKernel", t1 + 10, 5, c))
            dev.append(("bwd_kernel", t1 + 20_000, 900, c))
            c = next(corr)
            host.append(("cudaLaunchKernel", t1 + 2000, 5, c))
            dev.append(("autograd_kernel", t1 + 21_000, 2000, c))
    return {"host": [h[:3] for h in host], "device": [d[:3] for d in dev], "host_corr": host,
            "device_corr": dev, "wall_s": 1.0}


def _ctx(part) -> dict:
    return {"profile": {"update": part}, "net": NET, "cfg": CFG, "num_envs": 6}


def test_reads_forward_and_backward_spans():
    f_moved, f_ops, b_moved, b_ops = roofline.segment_attention_cost(NET, 3, 5)
    least = (profile.bound(f_moved, f_ops) + profile.bound(b_moved, b_ops)) * 2 * 2
    want = 100.0 * least / (2 * 2 * (400 + 900) * 1e-9)
    assert roofline.read(_ctx(_update_part())) == pytest.approx(want)


def test_no_backward_span_reads_none():
    assert roofline.read(_ctx(_update_part(backward=False))) is None
    part = _update_part()
    assert roofline.read(_ctx({**part, "host_corr": None})) is None
    bare = {**part, "host_corr": [h for h in part["host_corr"] if h[0] != "gtrxl.segment"]}
    assert roofline.read(_ctx(bare)) is None
    assert roofline.read({"trace": False}) is None
    mlp = {**_ctx(part), "net": {"obs_dim": 17, "action_dim": 6, "hidden": [16]}}
    assert roofline.read(mlp) is None


def test_counts_at_the_cells_shapes_by_hand():
    """B 128 sequences, T 128, m 512, H 8, d 256 (d_head 32), J 640 keys, of
    which each query sees the 513 of its window."""
    net = {"layers": 12, "width": 256, "heads": 8, "memory": 512}
    f_moved, f_ops, b_moved, b_ops = roofline.segment_attention_cost(net, 128, 128)
    assert f_ops == 2 * 128 * 8 * 128 * 32 * 3 * 513 == 12_910_067_712
    assert b_ops == 2 * 128 * 8 * 128 * 32 * 6 * 513 == 25_820_135_424
    q = 128 * 128 * 256 * 4  # qu, qv, the output, dout, dqu, dqv: 16.8 MB each
    kv = 128 * 640 * 256 * 4  # k, v, dk, dv: 83.9 MB each
    pos = 513 * 256 * 4
    small = 128 * 8 * 128 * 4 + 128 * 128 * 4 + 128 * 512  # lse, episodes, validity
    assert f_moved == 3 * q + 2 * kv + pos + small == 219_284_480
    assert b_moved == f_moved + 3 * q + 2 * kv + pos == 437_913_600
    # compute-bound both ways: 0.1927 + 0.3854 ms a layer, 6.94 ms a minibatch step
    ms = 12 * (profile.bound(f_moved, f_ops) + profile.bound(b_moved, b_ops)) * 1e3
    assert ms == pytest.approx(6.9368, abs=1e-4)
