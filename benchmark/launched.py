"""Device time by the host span that launched it: a device event shares its
correlation id with the host runtime call that queued it, and that call
starts inside the program's spans (`surreal_tpu_torch.utils.profiling.span`)
that were open then. The drivers that record correlation ids
(`device_events`) keep them in a profile part's `device_corr` and
`host_corr`: (name, start ns, duration ns, correlation) each. A profile
without them, or without the spans, reads None."""

from __future__ import annotations

from benchmark.metrics.physics_launches_per_step import LAUNCH_PREFIXES, count, inside, spans


def device_events(fn, sync_fn, tries: int = 3):
    """Like `profile.device_events`, each event with its correlation id last:
    (name, start ns, duration ns, correlation). A device event shares its id
    with the host runtime call that launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync_fn()
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            corr = e.correlation_id() or e.linked_correlation_id()
            item = (e.name(), e.start_ns(), e.duration_ns(), corr)
            (dev if e.device_type() == DeviceType.CUDA else host).append(item)
        if dev:
            return dev, host
    return [], []


def device_ns_within(part: dict, nested: tuple[str, ...]) -> tuple[int, int] | None:
    """(summed device ns, kernels) of the device events launched inside a
    span of each name of `nested` at once (each a host span of that name
    open at the launch); None where the part lacks correlation ids or any of
    the spans."""
    host, dev = part.get("host_corr"), part.get("device_corr")
    if not host or not dev:
        return None
    named = [(n, s, d) for n, s, d, _ in host]
    intervals = [spans(named, name) for name in nested]
    if not all(intervals):
        return None
    launched = {c for name, s, _, c in host if c and name.startswith(LAUNCH_PREFIXES)
                and all(inside(s, iv) for iv in intervals)}
    hits = [d for _, _, d, c in dev if c in launched]
    return sum(hits), len(hits)


def per_span(ctx, part: str, nested: tuple[str, ...], per: str) -> float | None:
    """Device ms launched inside `nested` spans, over the number of `per`
    spans of the profile's `part`; None where there is nothing to read."""
    p = ctx.get("profile")
    if not p or part not in p:
        return None
    got = device_ns_within(p[part], nested)
    n = count(p[part]["host"], per)
    if got is None or not got[1] or not n:
        return None
    return got[0] * 1e-6 / n
