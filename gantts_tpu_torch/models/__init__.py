"""Model registry (counterpart of gantts_tpu/models/__init__.py).

All six models of the JAX package: the VC generators ``In2OutHighwayNet``
and ``In2OutRNNHighwayNet``, ``MLP`` (the per-frame discriminator),
``SRURNN`` (the TTS generator) and the LSTM family, ``LSTMRNN`` and
``GRURNN``.  Module and parameter names follow the JAX package's scopes, so
``convert.py`` maps parameters one to one.  Every module takes an explicit
``device`` and draws its init from an explicit ``torch.Generator``; dropout
runs in training mode only, from the generator passed to ``forward``.

Two generator protocols, switched on ``include_parameter_generation``:
the In2Out models take ``(x, R, lengths)`` and apply MLPG themselves,
returning ``(first, x_static + sigmoid(T(x_static)) * MLPG(G(x)))``; the
others take ``(x, lengths)`` and leave MLPG to the trainer.  R is the dense
(T, K*T) matrix or a ``core.fast_mlpg.MLPGStencil`` with the true lengths.
The reference's quirks are kept: ``In2OutHighwayNet`` returns its
pre-MLPG ``last_linear`` output first, so an MSE term trains the trunk;
``In2OutRNNHighwayNet`` returns its input first, so its MSE term carries no
gradient.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gantts_tpu_torch.core.paramgen import unit_variance_mlpg
from gantts_tpu_torch.models.common import TorchLinear, _dropout, leaky_relu
from gantts_tpu_torch.models.recurrent import StackedLSTM
from gantts_tpu_torch.models.sru import SRU


class _In2Out(nn.Module):
    """The highway around a trunk: y = x_static + sigmoid(T(x_static)) *
    MLPG(trunk(x)).  ``T`` and the trunk's head stay float32; subclasses
    build the trunk after ``T``, as the JAX package's init order does."""

    include_parameter_generation = True

    def __init__(self, static_dim, generator, device):
        super().__init__()
        self.static_dim = static_dim
        self.T = TorchLinear(static_dim, static_dim, "float32", generator,
                             device)

    def highway(self, x, h, R, lengths):
        x_static = x[:, :, :self.static_dim]
        Tx = torch.sigmoid(self.T(x_static))
        return x_static + Tx * unit_variance_mlpg(R, h, lengths=lengths)


class In2OutHighwayNet(_In2Out):
    """Input-to-output highway network for VC: an MLP trunk ``H_{i}``
    (compute_dtype) and ``last_linear``."""

    def __init__(self, in_dim=118, out_dim=118, static_dim=118 // 2,
                 num_hidden=3, hidden_dim=512, dropout=0.5,
                 compute_dtype="float32", generator=None, device=None):
        super().__init__(static_dim, generator, device)
        self.num_hidden, self.dropout = num_hidden, dropout
        for i in range(num_hidden):
            self.add_module(f"H_{i}", TorchLinear(
                in_dim if i == 0 else hidden_dim, hidden_dim, compute_dtype,
                generator, device))
        self.last_linear = TorchLinear(
            hidden_dim if num_hidden else in_dim, out_dim, "float32",
            generator, device)

    def forward(self, x, R, lengths=None, generator=None):
        if x.dim() == 2:
            x = x[None]
        h = x
        for i in range(self.num_hidden):
            h = getattr(self, f"H_{i}")(h)
            h = _dropout(leaky_relu(h), self.dropout, self.training,
                         generator)
        h = self.last_linear(h)
        # the reference reassigns x through the trunk: the first return is
        # the pre-MLPG trunk output
        return h, self.highway(x, h, R, lengths)


class In2OutRNNHighwayNet(_In2Out):
    """The RNN variant: a (bi)LSTM trunk scoped ``lstm`` and a linear head
    ``hidden2out``."""

    def __init__(self, in_dim=118, out_dim=118, static_dim=118 // 2,
                 num_hidden=3, hidden_dim=512, bidirectional=False,
                 dropout=0.5, compute_dtype="float32", generator=None,
                 device=None):
        super().__init__(static_dim, generator, device)
        self.lstm = StackedLSTM(in_dim, hidden_dim, num_hidden, bidirectional,
                                dropout, compute_dtype, generator, device)
        dirs = 2 if bidirectional else 1
        self.hidden2out = TorchLinear(hidden_dim * dirs, out_dim, "float32",
                                      generator, device)

    def forward(self, x, R, lengths=None, generator=None):
        if x.dim() == 2:
            x = x[None]
        h = self.hidden2out(self.lstm(x, lengths, generator=generator))
        # the reference never reassigns x here: the first return is the
        # input, so an MSE term on it carries no gradient
        return x, self.highway(x, h, R, lengths)


class MLP(nn.Module):
    """Feed-forward net; doubles as the per-frame discriminator."""

    include_parameter_generation = False

    def __init__(self, in_dim=118, out_dim=1, num_hidden=2, hidden_dim=256,
                 dropout=0.5, last_sigmoid=True, bidirectional=None,
                 compute_dtype="float32", generator=None, device=None):
        super().__init__()
        del bidirectional  # accepted for parity with the reference surface
        self.num_hidden, self.dropout = num_hidden, dropout
        self.last_sigmoid = last_sigmoid
        for i in range(num_hidden):
            self.add_module(f"layers_{i}", TorchLinear(
                in_dim if i == 0 else hidden_dim, hidden_dim, compute_dtype,
                generator, device))
        self.last_linear = TorchLinear(
            hidden_dim if num_hidden else in_dim, out_dim, "float32",
            generator, device)

    def forward(self, x, lengths=None, generator=None):
        h = x
        for i in range(self.num_hidden):
            h = getattr(self, f"layers_{i}")(h)
            h = _dropout(leaky_relu(h), self.dropout, self.training,
                         generator)
        h = self.last_linear(h)
        return torch.sigmoid(h) if self.last_sigmoid else h


class SRURNN(nn.Module):
    """SRU generator: a (bi)SRU stack scoped ``gru`` and a linear head
    ``hidden2out``."""

    include_parameter_generation = False

    def __init__(self, in_dim=118, out_dim=118, num_hidden=2, hidden_dim=256,
                 bidirectional=False, dropout=0.0, last_sigmoid=False,
                 use_relu=0, rnn_dropout=0.0, compute_dtype="float32",
                 generator=None, device=None):
        super().__init__()
        self.last_sigmoid = last_sigmoid
        self.gru = SRU(in_dim, hidden_dim, num_hidden, bidirectional, dropout,
                       rnn_dropout, use_relu, compute_dtype, generator, device)
        dirs = 2 if bidirectional else 1
        self.hidden2out = TorchLinear(hidden_dim * dirs, out_dim, "float32",
                                      generator, device)

    def forward(self, x, lengths=None, generator=None):
        h = self.hidden2out(self.gru(x, lengths, generator=generator))
        return torch.sigmoid(h) if self.last_sigmoid else h


class LSTMRNN(nn.Module):
    """(Bi)LSTM stack scoped ``lstm`` and a linear head ``hidden2out``."""

    include_parameter_generation = False
    scope = "lstm"

    def __init__(self, in_dim=118, out_dim=118, num_hidden=2, hidden_dim=256,
                 bidirectional=False, dropout=0.0, last_sigmoid=False,
                 compute_dtype="float32", generator=None, device=None):
        super().__init__()
        self.last_sigmoid = last_sigmoid
        self.add_module(self.scope, StackedLSTM(
            in_dim, hidden_dim, num_hidden, bidirectional, dropout,
            compute_dtype, generator, device))
        dirs = 2 if bidirectional else 1
        self.hidden2out = TorchLinear(hidden_dim * dirs, out_dim, "float32",
                                      generator, device)

    def forward(self, x, lengths=None, generator=None):
        h = getattr(self, self.scope)(x, lengths, generator=generator)
        h = self.hidden2out(h)
        return torch.sigmoid(h) if self.last_sigmoid else h


class GRURNN(LSTMRNN):
    """Misnamed in the reference: an LSTM, scoped ``gru``."""

    scope = "gru"


MODEL_REGISTRY = {
    "MLP": MLP,
    "SRURNN": SRURNN,
    "In2OutHighwayNet": In2OutHighwayNet,
    "In2OutRNNHighwayNet": In2OutRNNHighwayNet,
    "GRURNN": GRURNN,
    "LSTMRNN": LSTMRNN,
}


def create_model(name, **params):
    """Construction by name, as the JAX package's ``create_model``."""
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError as e:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from e
    return cls(**params)


def include_parameter_generation(model) -> bool:
    """Whether the model applies MLPG itself (the In2Out protocol)."""
    return bool(getattr(model, "include_parameter_generation", False))
