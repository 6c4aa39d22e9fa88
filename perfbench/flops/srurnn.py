"""Operations and bytes of the SRURNN generator's step (bidirectional SRU
stack, a linear head), by shapes.

Matrix products: each layer and direction u = x @ W (D, 4H); the head
(2H, out).  A training step adds dW of every product and dx of every
product but the first layer's (its input is data).  The recurrences are
the kernel table's bounds (PERF.md): ``sru_fwd_scan`` reads u on valid
frames and the bias, writes h and c on every frame, about 16 operations a
valid lane; ``sru_bwd_scan`` reads u, c and the cotangent on valid frames,
writes du on every frame and the bias gradient, about 30 operations a
valid lane; float32 I/O.
"""

from __future__ import annotations

from perfbench.flops import gan
from perfbench.peaks import least_seconds


def _layers(hp):
    gp = hp["generator_params"]
    H, dirs = gp["hidden_dim"], 2 if gp["bidirectional"] else 1
    ins = [gp["in_dim"]] + [H * dirs] * (gp["num_hidden"] - 1)
    return H, dirs, ins, gp["out_dim"]


def generator(hp, frames, train, rows=0):
    """Matrix-product operations of the generator over ``frames`` frames
    (``rows``, the sequences, change nothing here)."""
    H, dirs, ins, out = _layers(hp)
    fwd = sum(dirs * 2 * d * 4 * H for d in ins) + 2 * H * dirs * out
    total = frames * fwd
    if train:
        dw = fwd
        dx = fwd - dirs * 2 * ins[0] * 4 * H
        total += frames * (dw + dx)
    return total


def step_flops(hp, T, lengths, train, padded):
    """All matrix-product operations of one step: at the padded shapes
    (``padded``: every frame of B x T, as the products run) or on valid
    frames only (the model's work)."""
    lengths = [int(n) for n in lengths]
    frames = len(lengths) * T if padded else sum(lengths)
    return (generator(hp, frames, train)
            + gan.discriminator(hp, frames, train)
            + gan.mlpg(hp, lengths, T if padded else None, train))


def gemm_flops(hp, T, lengths, train):
    """The operations that GEMM kernels carry in one step: every product,
    at padded shapes (the SRU has no recurrent product)."""
    return step_flops(hp, T, lengths, train, padded=True)


def recurrence_seconds(hp, T, lengths, train):
    """The least time of one step's recurrence kernels by the table's
    bounds: a forward scan per layer and direction, and a backward scan
    each in a training step."""
    H, dirs, ins, _ = _layers(hp)
    B, nv, M, N = len(lengths), float(sum(int(n) for n in lengths)), \
        len(lengths) * T, 4 * H
    fwd = least_seconds(16 * nv * H,
                        nv * N * 4 + N * 4 + B * 4 + M * H * 8, "float32")
    bwd = least_seconds(30 * nv * H,
                        nv * (N * 4 + H * 4 + H * 4) + N * 4 + B * 4
                        + M * N * 4 + B * 2 * H * 4, "float32")
    scans = len(ins) * dirs
    return scans * (fwd + (bwd if train else 0.0))
