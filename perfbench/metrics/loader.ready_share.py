"""loader.ready_share: percent of the traced epoch's training fetches
whose batch the loader had already assembled when the loop asked for it:
the program's ``loader.fetch`` counter.

The counts are read from the record that the program keeps in its process
(``gantts_tpu_torch/tracing.py``'s ``RECORD``: name, phase, value);
nothing of the program is imported or called, and a program without the
record reads None."""

import sys


def read(ctx):
    tracing = sys.modules.get("gantts_tpu_torch.tracing")
    if tracing is None:
        return None
    fetches = [c.value for c in tracing.RECORD.counts
               if c.name == "loader.fetch" and c.phase == "train"]
    if not fetches:
        return None
    return 100.0 * sum(bool(v) for v in fetches) / len(fetches)
