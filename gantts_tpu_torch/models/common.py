"""Shared building blocks for the models (counterpart of
gantts_tpu/models/common.py).

Initialization matches torch's defaults, as the JAX package does: Linear
kernels and biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), SRU parameters
from U(-1/sqrt(hidden), 1/sqrt(hidden)), drawn from an explicit generator.

The JAX package pads every RNN stack's time and batch axes to TPU tiles once
(``pad_rnn_stack``).  The card has no such tiling, so the port does not pad:
masked semantics are unchanged, since padding only added frames past every
row's length and rows of length 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gantts_tpu_torch.kernels.sru_scan import mm_f32


def uniform_(tensor, bound, generator=None):
    """In-place U(-bound, bound), torch's default init, from ``generator``."""
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


class _MatmulBF16(torch.autograd.Function):
    """bf16 operands, f32 accumulation and output.  The backward casts the
    cotangent to bf16 so both backward matmuls also run in bf16; dW is
    float32 and dx takes the dtype of the primal x."""

    @staticmethod
    def forward(ctx, x, w):
        x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(x16, w16)
        ctx.dtypes = (x.dtype, w.dtype)
        lead = x16.shape[:-1]
        y = mm_f32(x16.reshape(-1, x16.shape[-1]), w16)
        return y.reshape(*lead, w16.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        g16 = g.to(torch.bfloat16).reshape(-1, g.shape[-1])
        x2 = x16.reshape(-1, x16.shape[-1])
        dx = mm_f32(g16, w16.t()).reshape(x16.shape)
        dw = mm_f32(x2.t(), g16)
        if x_dtype == torch.bfloat16:
            dx = dx.to(torch.bfloat16)
        return dx.to(x_dtype), dw.to(w_dtype)


def matmul_cast(x, w, compute_dtype="float32"):
    """``x @ w`` in ``compute_dtype`` with float32 accumulation and output.

    float32 is the plain product (the card runs it without TF32, see
    core/paramgen.py).  bfloat16 follows the JAX package's contract: bf16
    operands, f32 result, bf16 backward matmuls."""
    if str(compute_dtype).endswith("bfloat16"):
        return _MatmulBF16.apply(x, w)
    if str(compute_dtype).endswith("float32"):
        return x.float() @ w
    raise ValueError(f"Unsupported compute_dtype {compute_dtype!r}")


class TorchLinear(nn.Module):
    """Linear layer with torch's default init, keeping the JAX package's
    (in, out) ``kernel`` layout so parameters convert one to one."""

    def __init__(self, in_features, features, compute_dtype="float32",
                 generator=None, device=None):
        super().__init__()
        bound = 1.0 / in_features ** 0.5
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(uniform_(
            torch.empty(in_features, features, device=device), bound,
            generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(features, device=device), bound, generator))

    def forward(self, x):
        return matmul_cast(x, self.kernel, self.compute_dtype).float() \
            + self.bias


def _dropout(x, rate, training, generator):
    """Per-element dropout (flax ``nn.Dropout``: kept values scaled 1/keep)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def leaky_relu(x):
    """torch.nn.LeakyReLU's default negative_slope of 0.01."""
    return F.leaky_relu(x, negative_slope=0.01)


def default_lengths(x, lengths):
    """(B,) int lengths; every row is full length when ``lengths`` is None."""
    if lengths is None:
        B, T = x.shape[0], x.shape[1]
        return torch.full((B,), T, dtype=torch.int32, device=x.device)
    return torch.as_tensor(lengths, device=x.device).to(torch.int32)
