"""Masked speech-domain distortion metrics on the device (counterpart of
gantts_tpu/train/metrics.py).

  melcd      10*sqrt(2)/ln(10) * mean_t ||x_t - y_t||_2 over valid frames
  lf0 MSE    over frames voiced in both sequences (linear domain: exp first);
             nan when no such frame exists
  vuv_error  fraction of valid frames with differing V/UV decisions
  mse        element mean over valid frames (duration model)

Each is a ratio of two sums over the batch, and each ``*_sums`` function
returns that numerator and denominator.  The training step sums both over
the data-parallel group before it divides, so its metrics are those of the
global batch: ``FROM_SUMS`` forms each of its metrics from them.  ``melcd``
and the other one-batch functions divide at once.
"""

from __future__ import annotations

import math

import torch

_LOGDB = 10.0 / math.log(10.0) * math.sqrt(2.0)


def melcd_sums(x, y, mask):
    """x, y: (B, T, D); mask: (B, T, 1) validity."""
    d = x - y
    per_frame = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return torch.sum(per_frame * mask), torch.sum(mask)


def _melcd(num, den):
    return _LOGDB * num / den


def lf0_sums(lf0, vuv, lf0_hat, vuv_hat, mask, linear_domain=True):
    """vuv/vuv_hat are binarized {0,1}: the squared error over frames voiced
    in both, and their count."""
    both = (vuv > 0.5) & (vuv_hat > 0.5) & (mask[..., 0] > 0.5)
    both_f = both.to(lf0.dtype)
    a = torch.exp(lf0) if linear_domain else lf0
    b = torch.exp(lf0_hat) if linear_domain else lf0_hat
    d = (a - b)[..., 0] if a.dim() == 3 else (a - b)
    return torch.sum(d * d * both_f), torch.sum(both_f)


def _lf0_mse(num, cnt):
    """nan if no co-voiced frame."""
    return torch.where(cnt > 0, num / torch.clamp_min(cnt, 1.0),
                       torch.full_like(num, math.nan))


def vuv_sums(vuv, vuv_hat, mask):
    m = mask[..., 0]
    diff = torch.abs((vuv > 0.5).float() - (vuv_hat > 0.5).float())
    if diff.dim() == 3:
        diff = diff[..., 0]
    return torch.sum(diff * m), torch.sum(m)


def mse_sums(x, y, mask):
    """Element mean over valid frames (duration metric)."""
    d = (x - y) * mask
    return torch.sum(d * d), torch.sum(mask) * x.shape[-1]


# The training step's metrics from their sums: name -> f(num, den)
FROM_SUMS = {
    "mcd": _melcd,
    "bap_mcd": lambda num, den: _melcd(num, den) / 10.0,
    "f0_rmse": lambda num, cnt: torch.sqrt(_lf0_mse(num, cnt)),
    "vuv_err": lambda num, den: num / den,
    "dur_rmse": lambda num, den: torch.sqrt(num / den),
}


def melcd(x, y, mask):
    return _melcd(*melcd_sums(x, y, mask))


def lf0_mean_squared_error(lf0, vuv, lf0_hat, vuv_hat, mask,
                           linear_domain=True):
    return _lf0_mse(*lf0_sums(lf0, vuv, lf0_hat, vuv_hat, mask,
                              linear_domain))


def vuv_error(vuv, vuv_hat, mask):
    num, den = vuv_sums(vuv, vuv_hat, mask)
    return num / den


def mean_squared_error(x, y, mask):
    num, den = mse_sums(x, y, mask)
    return num / den
