"""step_mfu: percent of the card's peak for the cell's compute dtype that
the window's model work reached: the matrix-product operations the steps
need on valid frames (forward and backward of each training step, forward
of each test step, no recomputation; ``flops/<family>.py``), over the
seconds of the window's epochs, the traced epoch left out."""

from perfbench.peaks import FLOPS_PER_S


def read(ctx):
    epochs = [e for e in ctx["window"] if e != ctx["trace_epoch"]] \
        or ctx["window"]
    seconds = sum(ctx["ends"][e] - ctx["ends"][e - 1] for e in epochs)
    hp, ops = ctx["hp"], ctx["ops"]
    flops = sum(ops.step_flops(hp, f[3], f[4], f[1] == "train", padded=False)
                for f in ctx["book"].batches(epochs))
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / FLOPS_PER_S[hp["compute_dtype"]]
