"""graphs.fused_share: percent of the traced epoch's training steps that
ran inside a dispatch of more than one step (a CUDA graph replay), counted
from the loop's ``gan_dispatch:K`` ranges in the trace."""

from perfbench import trace


def read(ctx):
    if ctx["trace"] is None:
        return None
    ks = [k for _, k, phase in trace.dispatches(ctx["trace"])
          if phase == "train"]
    if not ks:
        return None
    return 100.0 * sum(k for k in ks if k > 1) / sum(ks)
