"""graphs.launch_ms: host milliseconds a training step of the traced epoch
that the loop spent in the calls that launch the step's work: each eager
step's ``trainer.step`` call (``step.launch``) and each graph replay's
fill, replay and output copy (``graphs.replay``), the program's spans of
the train phase, over the epoch's training steps in the harness's book.
Where the card's queue is full the calls wait for it, and that counts.

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
    return sum(s.end - s.start for s in spans if s.name in (
        "step.launch", "graphs.replay")) / 1e6 / steps
