"""lstm.flag_share: percent of the traced epoch's LSTM scan launches (the
kernels ``lstm_fwd_*`` and ``lstm_bwd_*``, eager and replayed alike) that
took the flag design (``lstm_fwd_flag_kernel``, ``lstm_bwd_flag_kernel``);
the cooperative design's kernels are ``lstm_{fwd,bwd}_kernel``, the
cluster design's ``lstm_{fwd,bwd}_cluster_kernel``.  An epoch without an
LSTM scan reads None."""

import re

from perfbench import trace

SCANS = re.compile(r"^lstm_(?:fwd|bwd)_(cluster_|flag_)?kernel$")


def read(ctx):
    if ctx["trace"] is None:
        return None
    designs = [m.group(1) for e in trace.device_events(ctx["trace"])
               if e.get("cat") == "kernel"
               for m in [SCANS.match(trace.function_name(e["name"]))] if m]
    if not designs:
        return None
    return 100.0 * sum(d == "flag_" for d in designs) / len(designs)
