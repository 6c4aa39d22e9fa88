"""Masked multi-layer (bi)LSTM (counterpart of gantts_tpu/models/recurrent.py).

torch gate order (i, f, g, o).  Sequences stay padded and the recurrence is
masked as ``pack_padded_sequence`` would leave it: both carries freeze past
each row's length and the output is zero there.  The reversed direction of a
bidirectional layer is a reversed traversal, with no flip.

Every layer is ``kernels.lstm_proj_layer``: one projection GEMM and one scan
launch for all of the layer's directions, the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors.  Dropout between layers is
per element, as flax's ``nn.Dropout`` in the JAX package, on every layer's
output but the last.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gantts_tpu_torch.kernels.lstm_scan import lstm_proj_layer
from gantts_tpu_torch.models.common import _dropout, default_lengths, uniform_


class LSTMLayer(nn.Module):
    """The parameters of one direction of one layer, in the JAX package's
    names and layouts: ``w_ih`` (D, 4H), ``w_hh`` (H, 4H), and torch's two
    bias vectors ``b_ih`` and ``b_hh`` (4H), all from U(-1/sqrt(H),
    1/sqrt(H)).  The kernels take the sum of the biases."""

    def __init__(self, in_dim, hidden_dim, generator=None, device=None):
        super().__init__()
        H = hidden_dim
        bound = 1.0 / H ** 0.5

        def param(*shape):
            return nn.Parameter(uniform_(torch.empty(*shape, device=device),
                                         bound, generator))

        self.w_ih = param(in_dim, 4 * H)
        self.w_hh = param(H, 4 * H)
        self.b_ih = param(4 * H)
        self.b_hh = param(4 * H)

    def params(self):
        return dict(w_ih=self.w_ih, w_hh=self.w_hh,
                    bias=self.b_ih + self.b_hh)


class StackedLSTM(nn.Module):
    """Multi-layer (bi)LSTM; sublayers are named ``l{i}_fwd`` / ``l{i}_bwd``
    as in the JAX package.  (B, T, D) in, (B, T, dirs*H) out, time-major in
    between."""

    def __init__(self, in_dim, hidden_dim, num_layers, bidirectional=False,
                 dropout=0.0, compute_dtype="float32", generator=None,
                 device=None):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        self.compute_dtype = compute_dtype
        self.reverse = (False, True) if bidirectional else (False,)
        for i in range(num_layers):
            d = in_dim if i == 0 else hidden_dim * len(self.reverse)
            for name in ("fwd", "bwd")[:len(self.reverse)]:
                self.add_module(f"l{i}_{name}",
                                LSTMLayer(d, hidden_dim, generator, device))

    def forward(self, x, lengths=None, generator=None):
        lengths = default_lengths(x, lengths)
        out = x.transpose(0, 1)
        for i in range(self.num_layers):
            params = [getattr(self, f"l{i}_{name}").params()
                      for name in ("fwd", "bwd")[:len(self.reverse)]]
            out = lstm_proj_layer(out, params, lengths, self.reverse,
                                  self.compute_dtype)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = _dropout(out, self.dropout, self.training, generator)
        return out.transpose(0, 1)
