"""ms per rollout step: `algos.ppo.rollout` on a synchronised timer, over
the horizon, in a traced run's timed iteration."""


def read(ctx):
    t = ctx.get("timers")
    if not t or "rollout" not in t["seconds"]:
        return None
    return t["seconds"]["rollout"] * 1e3 / (t["calls"]["rollout"] * t["horizon"])
