"""Model registry (counterpart of gantts_tpu/models/__init__.py).

Ported so far: ``MLP`` (the per-frame discriminator) and ``SRURNN`` (the TTS
generator).  Module and parameter names follow the JAX package's scopes, so
``convert.py`` maps parameters one to one.  Every module takes an explicit
``device`` and draws its init from an explicit ``torch.Generator``; dropout
runs in training mode only, from the generator passed to ``forward``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gantts_tpu_torch.models.common import TorchLinear, leaky_relu
from gantts_tpu_torch.models.sru import SRU


def _dropout(x, rate, training, generator):
    """Per-element dropout (flax ``nn.Dropout``: kept values scaled 1/keep)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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


def _not_ported(name, item):
    def build(**_params):
        raise NotImplementedError(
            f"{name} is not ported to gantts_tpu_torch yet "
            f"(ROADMAP.md, open items {item})")
    return build


MODEL_REGISTRY = {
    "MLP": MLP,
    "SRURNN": SRURNN,
    "In2OutHighwayNet": _not_ported("In2OutHighwayNet",
                                    "queue 1 item 10, VC path"),
    "In2OutRNNHighwayNet": _not_ported("In2OutRNNHighwayNet",
                                       "queue 1 item 8, LSTM family"),
    "GRURNN": _not_ported("GRURNN", "queue 1 item 8, LSTM family"),
    "LSTMRNN": _not_ported("LSTMRNN", "queue 1 item 8, LSTM family"),
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
