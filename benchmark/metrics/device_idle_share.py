"""The device's idle share of an iteration, in %: 1 - device busy (the
union of the device events' intervals, of the profiled rollout steps scaled
to the horizon plus the profiled update) over the unprofiled iteration's
wall time (the window's time over its iterations)."""

from benchmark import profile


def read(ctx):
    p, w = ctx.get("profile"), ctx["window"]
    if not p or not p["rollout"]["device"] or not p["update"]["device"]:
        return None
    busy = (profile.busy_seconds(p["rollout"]["device"]) * p["horizon"] / p["steps"]
            + profile.busy_seconds(p["update"]["device"]))
    return 100.0 * (1.0 - busy / (w["seconds"] / w["iterations"]))
