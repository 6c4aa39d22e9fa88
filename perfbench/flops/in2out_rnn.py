"""Operations and bytes of the In2OutRNNHighwayNet generator's step
(unidirectional LSTM trunk, a linear head, MLPG, the highway's gate), by
shapes.

Matrix products: each layer's input projection x @ W_ih (D, 4H) and its
recurrent product h @ W_hh (H, 4H); the head (H, out); the gate T (S, S)
on the input's statics.  A training step adds dW of every product, dx of
the projections after the first layer, the head's dx and the recurrent
dh = dgates @ W_hh^T; the gate's input is data.  The recurrent products
run inside the LSTM kernels and the rest as GEMMs.  The recurrences are
the kernel table's float32 bounds (PERF.md, ``lstm_f32_bounds``): x_p, c,
the gates and the cotangent read on valid frames, outputs written on every
frame, W_hh and the bias once, 2 H 4H operations a valid frame on the FMA
pipes.
"""

from __future__ import annotations

from perfbench.flops import gan
from perfbench.peaks import least_seconds


def _dims(hp):
    gp = hp["generator_params"]
    H = gp["hidden_dim"]
    ins = [gp["in_dim"]] + [H] * (gp["num_hidden"] - 1)
    return H, ins, gp["out_dim"], gp["static_dim"]


def generator(hp, frames, train, recurrent=True, rows=0):
    """Matrix-product operations of the generator over ``frames`` frames
    of ``rows`` sequences; ``recurrent`` False leaves out the recurrent
    products (those the LSTM kernels carry).  dW_hh sums h_{t-1}^T dgates_t
    over every frame but each sequence's first."""
    H, ins, out, S = _dims(hp)
    proj = sum(2 * d * 4 * H for d in ins)
    rec = len(ins) * 2 * H * 4 * H
    other = 2 * H * out + 2 * S * S
    fwd = proj + other + (rec if recurrent else 0)
    total = frames * fwd
    if train:
        total += frames * (proj + (proj - 2 * ins[0] * 4 * H))
        total += frames * (2 * H * out * 2 + 2 * S * S)
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
    bounds: a forward scan per layer, and a backward scan each in a
    training step."""
    H, ins, _, _ = _dims(hp)
    nv, M = float(sum(int(n) for n in lengths)), len(lengths) * T
    wts = (H * 4 * H + 4 * H) * 4
    ops = 2 * nv * H * 4 * H
    fwd = least_seconds(ops, nv * 4 * H * 4 + wts + M * (H + H + 4 * H) * 4,
                        "float32")
    bwd = least_seconds(ops, wts + nv * (H + 4 * H + H) * 4 + M * 4 * H * 4
                        + 4 * H * 4, "float32")
    return len(ins) * (fwd + (bwd if train else 0.0))
