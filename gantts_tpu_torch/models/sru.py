"""SRU (Simple Recurrent Unit), the TTS generator's recurrence (counterpart
of gantts_tpu/models/sru.py).

    c_t = f_t * c_{t-1} + (1 - f_t) * x~_t
    h_t = r_t * g(c_t) + (1 - r_t) * x'_t        (highway bypass)

with f = sigmoid(u_f + bf), r = sigmoid(u_r + br), g = relu or tanh, and
u = x @ W.  Padded frames use f = 1 and input 0, so the state is carried
through unchanged, and h is zeroed there.  The reversed direction of a k=4
layer is a reversed traversal, with no flip.

When D != H (k=4 projection blocks: the first layer, and every layer of a
bidirectional stack), a layer is ``kernels.fused_sru_proj_layer``.  When
D == H (k=3 blocks: every layer after the first of a unidirectional stack)
the highway reads the raw input, as in the JAX package: u = x @ W
(``matmul_cast``), the gates, the length mask and the highway combine in f32
PyTorch ops (XLA's share in the JAX package), and the recurrence through
``kernels.linear_scan.linear_recurrence``; its reversed direction flips time
around the recurrence, as the JAX package's k=3 path does.  Either way the
Hopper kernels run for CUDA tensors and their plain versions for CPU
tensors.

Dropout is variational: one (1, B, D) mask per application, shared by every
time step, drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gantts_tpu_torch.kernels.linear_scan import linear_recurrence
from gantts_tpu_torch.kernels.sru_scan import fused_sru_proj_layer
from gantts_tpu_torch.models.common import (
    batch_view,
    default_lengths,
    matmul_cast,
    rand,
    uniform_,
)


class SRULayer(nn.Module):
    """One direction of one SRU layer, time-major: (T, B, D) -> (T, B, H)."""

    def __init__(self, in_dim, hidden_dim, use_relu=0, compute_dtype="float32",
                 reverse=False, generator=None, device=None):
        super().__init__()
        H = hidden_dim
        self.hidden_dim, self.use_relu = H, use_relu
        self.compute_dtype, self.reverse = compute_dtype, reverse
        self.k = 3 if in_dim == H else 4
        bound = 1.0 / H ** 0.5
        self.w = nn.Parameter(uniform_(
            torch.empty(in_dim, self.k * H, device=device), bound, generator))
        self.bf = nn.Parameter(uniform_(torch.empty(H, device=device), bound,
                                        generator))
        self.br = nn.Parameter(uniform_(torch.empty(H, device=device), bound,
                                        generator))

    def forward(self, x, lengths):
        if self.k == 4:
            zeros = torch.zeros_like(self.bf)
            bias4 = torch.cat([zeros, self.bf, self.br, zeros])
            return fused_sru_proj_layer(
                x, self.w, lengths, bias4=bias4, reverse=self.reverse,
                use_relu=self.use_relu, compute_dtype=self.compute_dtype)
        H = self.hidden_dim
        u = matmul_cast(x, self.w, self.compute_dtype)
        m = (torch.arange(x.shape[0], device=x.device)[:, None]
             < lengths[None, :]).float()[..., None]
        x_prime = x.float()  # the raw input
        if self.reverse:
            u, m, x_prime = u.flip(0), m.flip(0), x_prime.flip(0)
        f = torch.sigmoid(u[..., H:2 * H] + self.bf)
        r = torch.sigmoid(u[..., 2 * H:3 * H] + self.br)
        f_m = f * m + (1.0 - m)                 # f -> 1 on padding
        b_m = (1.0 - f) * u[..., :H] * m        # input contribution -> 0
        c = linear_recurrence(f_m, b_m)
        g = torch.relu(c) if self.use_relu else torch.tanh(c)
        h = (r * g + (1.0 - r) * x_prime) * m
        return h.flip(0) if self.reverse else h


class SRU(nn.Module):
    """Multi-layer (bi)SRU; sublayers are named ``l{i}_fwd`` / ``l{i}_bwd``
    as in the JAX package."""

    def __init__(self, in_dim, hidden_dim, num_layers, bidirectional=False,
                 dropout=0.0, rnn_dropout=0.0, use_relu=0,
                 compute_dtype="float32", generator=None, device=None):
        super().__init__()
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.dropout, self.rnn_dropout = dropout, rnn_dropout
        dirs = 2 if bidirectional else 1
        for i in range(num_layers):
            d = in_dim if i == 0 else hidden_dim * dirs
            self.add_module(f"l{i}_fwd", SRULayer(
                d, hidden_dim, use_relu, compute_dtype, False, generator,
                device))
            if bidirectional:
                self.add_module(f"l{i}_bwd", SRULayer(
                    d, hidden_dim, use_relu, compute_dtype, True, generator,
                    device))

    def _vdrop(self, x, rate, generator):
        """Variational dropout on time-major (T, B, D): one (1, B, D)
        Bernoulli keep-mask shared by every time step."""
        if not self.training or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = rand((1,) + tuple(x.shape[1:]),
                    batch_view(generator, axis=1), x.device) < keep
        return x * (mask.to(x.dtype) / keep)

    def forward(self, x, lengths=None, generator=None):
        lengths = default_lengths(x, lengths)
        out = x.transpose(0, 1)  # time-major through the whole stack
        for i in range(self.num_layers):
            inp = self._vdrop(out, self.rnn_dropout, generator)
            fwd = getattr(self, f"l{i}_fwd")(inp, lengths)
            if self.bidirectional:
                bwd = getattr(self, f"l{i}_bwd")(inp, lengths)
                out = torch.cat([fwd, bwd], dim=-1)
            else:
                out = fwd
            if self.dropout > 0 and i < self.num_layers - 1:
                out = self._vdrop(out, self.dropout, generator)
        return out.transpose(0, 1)
