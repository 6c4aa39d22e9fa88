"""loop.data_wait_ms: host milliseconds a training step of the window that
the loop waited on its next batch, by the harness's clock around each
fetch from the loader it hands the loop (``harness.Feed``)."""


def read(ctx):
    fetches = [f for f in ctx["book"].fetches
               if f[0] in ctx["window"] and f[1] == "train"]
    steps = sum(1 for f in fetches if f[3] is not None)
    if not steps:
        return None
    return 1e3 * sum(f[2] for f in fetches) / steps
