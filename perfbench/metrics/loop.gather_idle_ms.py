"""loop.gather_idle_ms: device milliseconds a training step of the traced
epoch in which the card sat idle while the loop gathered a dispatch
group from its loader: the part of each of the program's ``loop.gather``
spans, train and test phases, that no kernel, copy or fill covers (the
complement of the union of the device intervals), over the epoch's
training steps in the harness's book.

The spans are read from the record that the program keeps in its process
(``gantts_tpu_torch/tracing.py``'s ``RECORD``); nothing of the program is
imported or called, and a program without the record reads None.  They
are placed on the trace's clock here: each span of the loop's thread is
also a host range of the trace (``user_annotation``), the spans and ranges
of one name are paired in order where their counts agree, and the offset
is the median of the paired starts' differences."""

import statistics
import sys

from perfbench import trace


def offset(spans, loop_tid, events):
    """The trace's clock minus the record's, in us, or None."""
    ours, theirs = {}, {}
    for s in spans:
        if s.tid == loop_tid:
            ours.setdefault(s.name, []).append(s.start / 1e3)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in ours:
            theirs.setdefault(e["name"], []).append(e["ts"])
    diffs = []
    for name, starts in ours.items():
        ts = sorted(theirs.get(name, ()))
        if len(ts) == len(starts):
            diffs += [b - a for a, b in zip(sorted(starts), ts)]
    return statistics.median(diffs) if diffs else None


def read(ctx):
    tracing = sys.modules.get("gantts_tpu_torch.tracing")
    events = ctx["trace"]
    if tracing is None or events is None:
        return None
    spans = [s for s in tracing.RECORD.spans if s.end is not None]
    steps = len(ctx["book"].batches([ctx["trace_epoch"]], "train"))
    gathers = [s for s in spans if s.name == "loop.gather"]
    if not gathers or not steps:
        return None
    shift = offset(spans, tracing.RECORD.loop_tid, events)
    if shift is None:
        return None
    _, pieces = trace.union([trace.span(e)
                             for e in trace.device_events(events)])
    idle = 0.0
    for s in gathers:
        a, b = s.start / 1e3 + shift, s.end / 1e3 + shift
        busy = sum(max(0.0, min(b, q) - max(a, p)) for p, q in pieces)
        idle += (b - a) - busy
    return idle / 1e3 / steps
