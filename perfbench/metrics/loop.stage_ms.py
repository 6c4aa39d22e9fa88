"""loop.stage_ms: host milliseconds a training step of the traced epoch
that the loop spent staging its batches: stacking a dispatch's arrays
into (pinned) host memory and, for an eager step, enqueueing their copy
to the card.  The program's ``loop.stage`` spans of the train phase, over
the epoch's training steps in the harness's book.

The spans are read from the record that the program keeps in its process
(``gantts_tpu_torch/tracing.py``'s ``RECORD``); nothing of the program is
imported or called, and a program without the record reads None."""

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
               if s.name == "loop.stage") / 1e6 / steps
