"""ms per env step on a synchronised timer: the trainer's env `step`, in a
traced run's timed iteration."""


def read(ctx):
    t = ctx.get("timers")
    if not t or "env_step" not in t["seconds"]:
        return None
    return t["seconds"]["env_step"] * 1e3 / t["calls"]["env_step"]
