"""device.idle_share: percent of the traced epoch in which no kernel, copy
or fill ran on the card: 1 - the union of the device intervals over the
trace's extent."""

from perfbench import trace


def read(ctx):
    if ctx["trace"] is None:
        return None
    events = ctx["trace"]
    dev = trace.device_events(events)
    if not dev:
        return None
    busy, _ = trace.union([trace.span(e) for e in dev])
    a, b = trace.extent(events)
    return 100.0 * (1.0 - busy / (b - a))
