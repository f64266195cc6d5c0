"""Device kernels (every device event: kernels, copies, fills) in the
profiled rollout steps, per step."""


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    n = len(p["rollout"]["device"])
    return n / p["steps"] if n else None
