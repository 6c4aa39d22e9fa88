"""loader.wait_ms: host milliseconds a training step of the traced epoch
that the loop's thread waited for a batch its loader had not yet
assembled: the program's ``loader.wait`` spans of the train phase, over
the epoch's training steps in the harness's book.  The program's
counterpart of ``loop.data_wait_ms``.

The spans are read from the record that the program keeps in its process
(``gantts_tpu_torch/tracing.py``'s ``RECORD``: closed spans with name,
phase, thread, start and end in ns); nothing of the program is imported or
called, and a program without the record reads None."""

import sys


def read(ctx):
    tracing = sys.modules.get("gantts_tpu_torch.tracing")
    if tracing is None:
        return None
    spans = [s for s in tracing.RECORD.spans
             if s.end is not None and s.phase == "train"]
    steps = len(ctx["book"].batches([ctx["trace_epoch"]], "train"))
    if not spans or not steps:
        return None
    return sum(s.end - s.start for s in spans
               if s.name == "loader.wait") / 1e6 / steps
