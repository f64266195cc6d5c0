"""The GTrXL PPO's share of the card's float32 peak over the window, in %:
the operations of the window's iterations (the prefill, the decode, the
segment forward and backward and the heads, benchmark/gtrxl_flops.py, from
the shapes) over its wall time, over 67 TFLOP/s (TF32 is off)."""

from benchmark import gtrxl_flops, profile


def read(ctx):
    w, net, cfg = ctx["window"], ctx.get("net"), ctx.get("cfg")
    if not net or "layers" not in net or not cfg:
        return None
    ops = gtrxl_flops.iteration_flops(net, cfg["horizon"], ctx["num_envs"], cfg["epochs"],
                                      cfg["num_minibatches"])
    return 100.0 * ops * w["iterations"] / w["seconds"] / profile.FP32_OPS_PER_S
