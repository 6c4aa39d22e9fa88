"""loader.assemble_ms: host milliseconds the loader took to assemble one
batch of the traced epoch's train phase (its items, padding, stacking),
on whichever thread assembled it: the program's ``loader.assemble`` spans
over their number.

The spans are read from the record that the program keeps in its process
(``gantts_tpu_torch/tracing.py``'s ``RECORD``); nothing of the program is
imported or called, and a program without the record reads None."""

import sys


def read(ctx):
    tracing = sys.modules.get("gantts_tpu_torch.tracing")
    if tracing is None:
        return None
    spans = [s for s in tracing.RECORD.spans if s.end is not None
             and s.phase == "train" and s.name == "loader.assemble"]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / len(spans)
