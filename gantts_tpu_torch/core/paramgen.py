"""Differentiable MLPG (counterpart of gantts_tpu/core/paramgen.py): the
dense (T, K*T) R product, or, when R is a ``core.fast_mlpg.MLPGStencil``,
the length-general stencil operator at each example's true length.

R is applied in exact float32.  On the card PyTorch would otherwise be free
to run float32 products in TF32, which keeps about three decimal digits and
breaks the invariant ``unit_variance_mlpg(R, delta_features(s)) == s``
(~1e-6).  Importing this module therefore sets, for the process,
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import numpy as np
import torch

from gantts_tpu_torch.core.fast_mlpg import (
    MLPGStencil,
    unit_variance_mlpg_dynamic,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def unit_variance_mlpg(R, means, lengths=None):
    """Apply the (T, K*T) unit-variance MLPG matrix to (B, T, K*S) or
    (T, K*S) normalized static+dynamic features; returns (B, T, S) or
    (T, S).  Features are re-laid-out window-major ((K*T, S)) first.

    ``R`` may instead be an ``MLPGStencil``: then ``lengths`` (B,) gives each
    example's true length, ``means`` may be zero-padded to any T, and the
    padding comes back zero.  A dense R ignores ``lengths``."""
    if isinstance(R, MLPGStencil):
        if lengths is None:
            raise ValueError("MLPGStencil mode requires per-example lengths")
        return unit_variance_mlpg_dynamic(R, means, lengths)
    T = R.shape[0]
    K = R.shape[1] // T
    squeeze = means.dim() == 2
    if squeeze:
        means = means[None]
    B, Tm, KS = means.shape
    if Tm != T:
        raise ValueError(f"means time axis {Tm} != R time axis {T}")
    if KS % K:
        raise ValueError(f"means feature dim {KS} not divisible by {K} windows")
    S = KS // K
    m = means.reshape(B, T, K, S).permute(0, 2, 1, 3).reshape(B, K * T, S)
    out = torch.matmul(R.float(), m.float())
    return out[0] if squeeze else out


def multi_stream_mlpg(inputs, R, stream_sizes=(180, 3, 1, 3),
                      has_dynamic_features=(True, True, False, True),
                      streams=(True, True, True, True)):
    """Apply MLPG to the dynamic streams of (B, T, D) features; streams
    without dynamic features pass through."""
    num_windows = 1 if R is None else R.shape[1] // R.shape[0]
    D = inputs.shape[-1]
    if D != int(np.sum(stream_sizes)):
        raise RuntimeError(
            "You probably have specified wrong dimension params: "
            f"inputs D={D}, sum(stream_sizes)={int(np.sum(stream_sizes))}")
    for size, dyn in zip(stream_sizes, has_dynamic_features):
        if dyn and size % num_windows:
            raise RuntimeError(
                f"dynamic stream size {size} not divisible by "
                f"{num_windows} windows")
    starts = np.hstack(([0], np.cumsum(stream_sizes)[:-1])).astype(int)
    ret = []
    for start, size, dyn, enabled in zip(starts, stream_sizes,
                                         has_dynamic_features, streams):
        if enabled:
            x = inputs[..., start:start + size]
            ret.append(unit_variance_mlpg(R, x) if dyn else x)
    return torch.cat(ret, dim=-1)
