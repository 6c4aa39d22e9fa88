"""Operations and bytes of the LSTMRNN generator's step (bidirectional LSTM
stack, a linear head; MLPG after it, as the TTS step applies it), by
shapes.

Matrix products: each layer and direction's input projection x @ W_ih
(D, 4H), D the input's width (the first layer's, then 2H), and its
recurrent product h @ W_hh (H, 4H); the head (2H, out).  A training step
adds dW of every product, dx of the projections after the first layer
(the first one's input is data), the head's dx, and the recurrent
dh = dgates @ W_hh^T.  The recurrent products run inside the LSTM kernels
(both directions of a layer in one launch) and the rest as GEMMs, dW_hh
among them.  The recurrences are the kernel table's float32 bounds
(PERF.md, ``lstm_f32_bounds``) for each direction: x_p, c, the gates and
the cotangent read on valid frames, outputs written on every frame, W_hh
and the bias once, 2 H 4H operations a valid frame on the FMA pipes.
"""

from __future__ import annotations

from perfbench.flops import gan
from perfbench.peaks import least_seconds


def _dims(hp):
    gp = hp["generator_params"]
    H, dirs = gp["hidden_dim"], 2 if gp["bidirectional"] else 1
    ins = [gp["in_dim"]] + [dirs * H] * (gp["num_hidden"] - 1)
    return H, dirs, ins, gp["out_dim"]


def generator(hp, frames, train, recurrent=True, rows=0):
    """Matrix-product operations of the generator over ``frames`` frames
    of ``rows`` sequences; ``recurrent`` False leaves out the recurrent
    products (those the LSTM kernels carry).  dW_hh sums h_{t-1}^T dgates_t
    over every frame but each sequence's first."""
    H, dirs, ins, out = _dims(hp)
    proj = sum(dirs * 2 * d * 4 * H for d in ins)
    rec = len(ins) * dirs * 2 * H * 4 * H
    head = 2 * dirs * H * out
    total = frames * (proj + head + (rec if recurrent else 0))
    if train:
        total += frames * (proj + (proj - dirs * 2 * ins[0] * 4 * H))
        total += frames * 2 * head
        total += (frames - rows) * rec               # dW_hh, a GEMM
        total += frames * (rec if recurrent else 0)  # dh, in the scan
    return total


def step_flops(hp, T, lengths, train, padded):
    """All matrix-product operations of one step, at padded shapes or on
    valid frames only."""
    lengths = [int(n) for n in lengths]
    frames = len(lengths) * T if padded else sum(lengths)
    rows = len(lengths) if padded else sum(1 for n in lengths if n)
    return (generator(hp, frames, train, rows=rows)
            + gan.discriminator(hp, frames, train)
            + gan.mlpg(hp, lengths, T if padded else None, train))


def gemm_flops(hp, T, lengths, train):
    """The operations that GEMM kernels carry in one step, at padded
    shapes: all but the recurrent products."""
    frames = len(lengths) * T
    return (generator(hp, frames, train, recurrent=False,
                      rows=len(lengths))
            + gan.discriminator(hp, frames, train)
            + gan.mlpg(hp, lengths, T, train))


def recurrence_seconds(hp, T, lengths, train):
    """The least time of one step's LSTM kernels by the table's float32
    bounds: a forward scan per layer over both directions, and a backward
    scan each in a training step.  A launch's directions share nothing, so
    its bound is the directions' sum."""
    H, dirs, ins, _ = _dims(hp)
    nv, M = float(sum(int(n) for n in lengths)), len(lengths) * T
    wts = (H * 4 * H + 4 * H) * 4
    ops = 2 * nv * H * 4 * H
    fwd = least_seconds(ops, nv * 4 * H * 4 + wts + M * (H + H + 4 * H) * 4,
                        "float32")
    bwd = least_seconds(ops, wts + nv * (H + 4 * H + H) * 4 + M * 4 * H * 4
                        + 4 * H * 4, "float32")
    return len(ins) * dirs * (fwd + (bwd if train else 0.0))
