"""recurrence_roofline: percent of the traced epoch's recurrence-kernel
device time (the SRU scans, the LSTM recurrences, the linear recurrences)
that their least time would take, by the kernel table's bytes and
operations bounds at each batch's shapes (``flops/<family>.py``)."""

from perfbench import trace


def read(ctx):
    if ctx["trace"] is None:
        return None
    busy = trace.seconds(trace.device_events(ctx["trace"]), "recurrence")
    hp, ops = ctx["hp"], ctx["ops"]
    least = sum(ops.recurrence_seconds(hp, f[3], f[4], f[1] == "train")
                for f in ctx["book"].batches([ctx["trace_epoch"]]))
    if busy <= 0 or not least:
        return None
    return 100.0 * least / busy
