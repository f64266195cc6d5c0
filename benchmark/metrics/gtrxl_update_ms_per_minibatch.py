"""ms per minibatch step of the GTrXL update: `algos.ppo_gtrxl.update` on a
synchronised timer (GAE, the advantage normalisation, each minibatch's
segment recompute, loss, backward and Adam, the Z-filter update), over
epochs x minibatches, in a traced run's timed iteration."""


def read(ctx):
    t, net = ctx.get("timers"), ctx.get("net")
    if not t or not net or "layers" not in net or "update" not in t["seconds"]:
        return None
    return t["seconds"]["update"] * 1e3 / t["minibatch_steps"]
