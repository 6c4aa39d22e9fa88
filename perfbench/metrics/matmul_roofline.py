"""matmul_roofline: percent of the traced epoch's GEMM device time that
the least time of its matrix-product work would take: the operations of
every product the GEMM kernels carry, at the batches' padded shapes
(``flops/<family>.py``), over the peak of the compute dtype, divided by
the device time of every GEMM kernel, the port's and the library's."""

from perfbench import trace
from perfbench.peaks import FLOPS_PER_S


def read(ctx):
    if ctx["trace"] is None:
        return None
    busy = trace.seconds(trace.device_events(ctx["trace"]), "gemm")
    hp, ops = ctx["hp"], ctx["ops"]
    flops = sum(ops.gemm_flops(hp, f[3], f[4], f[1] == "train")
                for f in ctx["book"].batches([ctx["trace_epoch"]]))
    if busy <= 0 or not flops:
        return None
    return 100.0 * flops / FLOPS_PER_S[hp["compute_dtype"]] / busy
