"""Stencil (banded) MLPG: O(T*W) instead of the dense O(T^2) R product
(counterpart of gantts_tpu/core/fast_mlpg.py).

The unit-variance MLPG matrix R = P^{-1} W*^T is the inverse of a banded SPD
matrix times a banded matrix, and P^{-1}'s entries decay geometrically away
from the diagonal (about 0.268 a frame for the standard three windows).  So
every interior row of R converges to one Toeplitz stencil, R[t, k*T + t + j]
-> s_k[j], whatever t and T:

  * interior frames: y[t] = sum_k sum_{|j|<=W} s_k[j] u_k[t+j], run as a
    blocked-Toeplitz product, 128-frame blocks with a W-frame halo on each
    side against one (128, K, 128+2W) band matrix;
  * the first and last W frames: exact boundary rows, taken once from a
    reference R at T0 = 8W (rows of R for any T >= T0 agree with them to
    about 1e-12, by the same decay).

With W = 24 the result matches dense MLPG to about 1e-6 in float32.  It
needs T >= 4W + 2; callers take the dense R below that.  The parts are built
in float64 numpy from the port's own ``core/windows.py`` and cast to
float32.  The products run in exact float32 like the dense path's:
``core/paramgen.py`` turns TF32 off for the process.

``MLPGStencil`` holds the parts as tensors.  Passed to
``core.paramgen.unit_variance_mlpg`` in place of R, with each example's true
length, it places the exact bottom rows at that length and zeroes the
padding (``unit_variance_mlpg_dynamic``): one operator for every utterance
length, which is how the VC synthesis runs the In2Out models.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix

DEFAULT_HALFWIDTH = 24
BLOCK_T = 128  # time-block size of the blocked-Toeplitz interior product


def _windows_key(windows):
    return tuple((int(l), int(u), tuple(np.asarray(c, dtype=np.float64)))
                 for l, u, c in windows)


@lru_cache(maxsize=16)
def _stencil_parts(windows_key, halfwidth):
    """(stencil (K, 2W+1), top (K, W, 2W), bot (K, W, 2W)) float32 numpy,
    from a float64 reference R at T0 = 8W."""
    windows = [(l, u, np.array(c)) for l, u, c in windows_key]
    W = halfwidth
    T0 = 8 * W
    K = len(windows)
    R0 = unit_variance_mlpg_matrix(windows, T0, dtype=np.float64)
    mid = T0 // 2
    stencil = np.stack([
        R0[mid, k * T0 + mid - W: k * T0 + mid + W + 1] for k in range(K)])
    C = 2 * W  # boundary rows reach only C columns into each window block
    top = np.stack([R0[:W, k * T0: k * T0 + C] for k in range(K)])
    bot = np.stack([R0[T0 - W:, k * T0 + T0 - C: k * T0 + T0]
                    for k in range(K)])
    return (stencil.astype(np.float32), top.astype(np.float32),
            bot.astype(np.float32))


@lru_cache(maxsize=16)
def _block_matrix(windows_key, halfwidth, block_t):
    """(block_t, K, block_t + 2W) embedding of the stencil, M[a, k, c] =
    s_k[c - a - W] (0 outside the band).  Independent of T."""
    stencil, _, _ = _stencil_parts(windows_key, halfwidth)
    K, width = stencil.shape
    M = np.zeros((block_t, K, block_t + 2 * halfwidth), dtype=np.float32)
    for a in range(block_t):
        M[a, :, a: a + width] = stencil
    return M


@lru_cache(maxsize=16)
def _block_tensor(windows_key, halfwidth, device):
    return torch.as_tensor(_block_matrix(windows_key, halfwidth, BLOCK_T),
                           device=device)


def _interior_blocked(u, windows_key, W):
    """u (B, T, K, S) -> the interior stencil product (B, T, S): time split
    into BLOCK_T-frame blocks with a W-frame halo on each side, each block
    contracted against the band matrix."""
    B, T, K, S = u.shape
    n_blk = -(-T // BLOCK_T)
    Tpad = n_blk * BLOCK_T
    u_p = F.pad(u, (0, 0, 0, 0, W, Tpad - T + W))
    blocks = u_p.unfold(1, BLOCK_T + 2 * W, BLOCK_T)  # (B, n, K, S, halo)
    M = _block_tensor(windows_key, W, u.device)
    y = torch.einsum("bnksh,tkh->bnts", blocks, M)
    return y.reshape(B, Tpad, S)[:, :T]


def _boundary(u_c, part):
    """Exact boundary rows: u_c (B, C, K, S) against part (K, W, C)."""
    return torch.einsum("bcks,kwc->bws", u_c, part)


def unit_variance_mlpg_stencil(means, windows, halfwidth=DEFAULT_HALFWIDTH):
    """Stencil MLPG on (B, T, K*S) or (T, K*S) features, T >= 4*halfwidth
    + 2; interchangeable with ``unit_variance_mlpg(
    unit_variance_mlpg_matrix(windows, T), means)``."""
    squeeze = means.dim() == 2
    if squeeze:
        means = means[None]
    B, T, KS = means.shape
    K = len(windows)
    W = halfwidth
    if T < 4 * W + 2:
        raise ValueError(f"T={T} too short for stencil MLPG (need >= "
                         f"{4 * W + 2})")
    key = _windows_key(windows)
    _, top, bot = _stencil_parts(key, W)
    top, bot = (torch.as_tensor(a, device=means.device) for a in (top, bot))
    C = 2 * W
    u = means.float().reshape(B, T, K, KS // K)
    y = _interior_blocked(u, key, W)
    y = torch.cat([_boundary(u[:, :C], top), y[:, W:T - W],
                   _boundary(u[:, T - C:], bot)], dim=1)
    return y[0] if squeeze else y


class MLPGStencil:
    """The length-general MLPG operator: pass it to
    ``core.paramgen.unit_variance_mlpg`` in place of the dense R, with each
    example's true length.  Holds the Toeplitz interior stencil (K, 2W+1),
    the exact boundary blocks top and bot (K, W, 2W), and the windows' key,
    from which the blocked interior's band matrix is built."""

    def __init__(self, stencil, top, bot, windows_key):
        self.stencil, self.top, self.bot = stencil, top, bot
        self.windows_key = windows_key

    @property
    def halfwidth(self):
        return self.top.shape[1]

    @classmethod
    def create(cls, windows, halfwidth=DEFAULT_HALFWIDTH, device=None):
        key = _windows_key(windows)
        parts = (torch.as_tensor(a, device=device)
                 for a in _stencil_parts(key, halfwidth))
        return cls(*parts, windows_key=key)

    def to(self, device):
        return MLPGStencil(self.stencil.to(device), self.top.to(device),
                           self.bot.to(device), self.windows_key)


def unit_variance_mlpg_dynamic(op: MLPGStencil, means, lengths):
    """Stencil MLPG on zero-padded (B, Tp, K*S) features with each example's
    true length: frames [W, length-W) from the interior stencil, [0, W) and
    [length-W, length) overwritten with the exact boundary rows, frames past
    the length zeroed.  As the JAX package's dynamic slices do, the bottom
    block's start is clamped into the array (a length under 2W reads and
    writes the first frames)."""
    squeeze = means.dim() == 2
    if squeeze:
        means = means[None]
    lengths = torch.as_tensor(lengths, device=means.device).reshape(-1).long()
    B, Tp, KS = means.shape
    K = op.stencil.shape[0]
    W = op.halfwidth
    C = 2 * W
    u = means.float().reshape(B, Tp, K, KS // K)
    y = _interior_blocked(u, op.windows_key, W)
    y = torch.cat([_boundary(u[:, :C], op.top), y[:, W:]], dim=1)

    # the exact bottom block at each example's length
    rows = torch.arange(B, device=u.device)[:, None]
    src = (lengths - C).clamp(0, Tp - C)[:, None] + torch.arange(
        C, device=u.device)
    dst = (lengths - W).clamp(0, Tp - W)[:, None] + torch.arange(
        W, device=u.device)
    y = y.index_put((rows, dst), _boundary(u[rows, src], op.bot))

    mask = torch.arange(Tp, device=u.device)[None, :] < lengths[:, None]
    y = y * mask[:, :, None]
    return y[0] if squeeze else y


def multi_stream_mlpg_stencil(inputs, windows, stream_sizes,
                              has_dynamic_features, streams=None,
                              halfwidth=DEFAULT_HALFWIDTH):
    """Stencil variant of ``core.paramgen.multi_stream_mlpg`` (no R)."""
    if streams is None:
        streams = (True,) * len(stream_sizes)
    starts = np.hstack(([0], np.cumsum(stream_sizes)[:-1])).astype(int)
    ret = []
    for start, size, dyn, enabled in zip(starts, stream_sizes,
                                         has_dynamic_features, streams):
        if enabled:
            x = inputs[..., start:start + size]
            ret.append(unit_variance_mlpg_stencil(x, windows, halfwidth)
                       if dyn else x)
    return torch.cat(ret, dim=-1)
