"""Length masking and masked sequence losses (counterpart of
gantts_tpu/core/masking.py)."""

from __future__ import annotations

import torch


def sequence_mask(lengths, max_len):
    """(B,) lengths -> (B, T) float 0/1 mask."""
    seq_range = torch.arange(max_len, device=lengths.device)
    return (seq_range[None, :] < lengths[:, None]).float()


def masked_mse_loss(input, target, lengths=None, mask=None, max_len=None,
                    denom=None):
    """``sum((input - target)^2 * mask) / mask.sum()``: the denominator is the
    number of valid frames (mask is (B, T, 1)), not frames x dims.  ``denom``
    replaces ``mask.sum()`` (a data-parallel rank divides its own sum by
    the global batch's valid frames)."""
    if lengths is None and mask is None:
        raise RuntimeError("Should provide either lengths or mask")
    if mask is None:
        if max_len is None:
            max_len = input.shape[1]
        mask = sequence_mask(lengths, max_len)[..., None]
    diff = (input - target) * mask
    if denom is None:
        denom = torch.sum(mask)
    return torch.sum(diff * diff) / denom
