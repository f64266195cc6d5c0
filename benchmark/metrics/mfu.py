"""The networks' share of the card's float32 peak over the window, in %:
the operations of the window's iterations (benchmark/flops.py, from the
shapes) over its wall time, over 67 TFLOP/s (TF32 is off)."""

from benchmark import flops, profile


def read(ctx):
    w, cfg = ctx["window"], ctx.get("cfg")
    if not cfg or "horizon" not in cfg:
        return None
    ops = flops.ppo_iteration_flops(ctx["net"], cfg["horizon"], ctx["num_envs"], cfg["epochs"])
    return 100.0 * ops * w["iterations"] / w["seconds"] / profile.FP32_OPS_PER_S
