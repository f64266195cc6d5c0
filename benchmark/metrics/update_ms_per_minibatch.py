"""ms per minibatch step: `algos.ppo.update` on a synchronised timer (GAE,
the advantage normalisation and the Z-filter update included), over
epochs x minibatches."""


def read(ctx):
    t = ctx.get("timers")
    if not t or "update" not in t["seconds"]:
        return None
    return t["seconds"]["update"] * 1e3 / t["minibatch_steps"]
