"""The plain linear recurrence of the k=3 SRU layer: hand-written CUDA kernels
for Hopper, their plain PyTorch versions, and the autograd Function around
them.

Counterpart of ``pallas_linear_recurrence`` / ``linear_recurrence_pallas``
in gantts_tpu/kernels/sru_scan.py.  Two kernels, built from
``csrc/linear_scan.cu`` at first use (see that file's note for what bounds
them on the card and what their design does about it):

  ``linear_recurrence_fwd``  c_t = f_t c_{t-1} + b_t, c_{-1} = 0
                             (replaces ``_fwd_kernel``); any T, walked in
                             windows of 256 steps;
  ``linear_recurrence_bwd``  ghat_t = g_t + f_{t+1} ghat_{t+1},
                             df_t = ghat_t c_{t-1}, db_t = ghat_t
                             (replaces ``_bwd_kernel`` and the shifted
                             copies its caller builds); T up to
                             ``MAX_BWD_STEPS``.

Both split T into chunks (16 steps forward, 32 backward) joined through their
carries, so they agree with their plain versions to rounding (1e-6 of
scale), not bit for bit: only the chunk each traversal starts with (the
forward's first 16 steps, the backward's last 32), whose carry is 0, is
exact.

Each wrapper takes the plain version when, and only when, its tensors lie on
the CPU.  A CUDA tensor goes to the kernel; anything the kernel does not take
(another device, a dtype other than float32, a shape mismatch, a
non-contiguous or empty tensor) raises, and so does a failed build or launch.
Each launch adds one to ``launch_counts[name]``, the dict shared with
``sru_scan``.

Layout is time-major (T, B, H), float32 only: the JAX k=3 path is all f32
downstream of its bf16 projection.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gantts_tpu_torch.kernels.sru_scan import (
    _on_cpu,
    _require,
    _stream,
    launch_counts,
)

launch_counts.update(linear_recurrence_fwd=0, linear_recurrence_bwd=0)

F32 = (torch.float32,)
MAX_BWD_STEPS = 8192  # 32-step chunks, all of a lane's in one block


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and what the kernels are held to on the card.
# Each product and sum is its own op, as the kernels' second passes round
# them.
# ---------------------------------------------------------------------------


def linear_recurrence_fwd_plain(f, b):
    """c (T, B, H) from f, b (T, B, H), a Python loop over T."""
    c = torch.zeros_like(b[0])
    cs = []
    for t in range(f.shape[0]):
        c = f[t] * c + b[t]
        cs.append(c)
    return torch.stack(cs)


def linear_recurrence_bwd_plain(g, f, c):
    """(df, db) from the cotangent g of c and the forward's f and c."""
    ghat, f_next = torch.zeros_like(g[0]), torch.zeros_like(f[0])
    T = g.shape[0]
    db = [None] * T
    for t in range(T - 1, -1, -1):
        ghat = g[t] + f_next * ghat
        f_next = f[t]
        db[t] = ghat
    db = torch.stack(db)
    c_prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    return db * c_prev, db


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    from gantts_tpu_torch.kernels._build import load_library

    lib = load_library("linear_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.linear_scan_error_string.argtypes = [I]
    lib.linear_scan_error_string.restype = ctypes.c_char_p
    lib.linear_recurrence_fwd.argtypes = [P, P, P, I, I, P]
    lib.linear_recurrence_bwd.argtypes = [P, P, P, P, P, I, I, P]
    for fn in (lib.linear_recurrence_fwd, lib.linear_recurrence_bwd):
        fn.restype = I
    return lib


def _launched(name, code):
    if code != 0:
        msg = _lib().linear_scan_error_string(code).decode()
        raise RuntimeError(f"{name}: launch failed ({code}: {msg})")
    launch_counts[name] += 1


def _check(name, first, *rest):
    dev, shape = first.device, tuple(first.shape)
    if len(shape) != 3 or 0 in shape:
        raise ValueError(f"{name}: expected a non-empty (T, B, H) tensor, "
                         f"got shape {shape}")
    for what, t in (("f", first),) + rest:
        _require(name, t, what, dev, F32, shape)
    return dev, shape


def linear_recurrence_fwd(f, b):
    """c_t = f_t c_{t-1} + b_t over (T, B, H) float32; returns c."""
    if _on_cpu(f, b):
        return linear_recurrence_fwd_plain(f, b)
    name = "linear_recurrence_fwd"
    dev, (T, B, H) = _check(name, f, ("b", b))
    c = torch.empty_like(f)
    _launched(name, _lib().linear_recurrence_fwd(
        f.data_ptr(), b.data_ptr(), c.data_ptr(), T, B * H, _stream(dev)))
    return c


def linear_recurrence_bwd(g, f, c):
    """(df, db) for the cotangent g of c; f and c are the forward's."""
    if _on_cpu(g, f, c):
        return linear_recurrence_bwd_plain(g, f, c)
    name = "linear_recurrence_bwd"
    dev, (T, B, H) = _check(name, f, ("g", g), ("c", c))
    if T > MAX_BWD_STEPS:
        raise ValueError(f"{name}: T={T} steps, at most {MAX_BWD_STEPS}")
    df, db = torch.empty_like(f), torch.empty_like(f)
    _launched(name, _lib().linear_recurrence_bwd(
        g.data_ptr(), f.data_ptr(), c.data_ptr(), df.data_ptr(),
        db.data_ptr(), T, B * H, _stream(dev)))
    return df, db


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class LinearRecurrence(torch.autograd.Function):
    """c = linear_recurrence(f, b) on time-major float32 (T, B, H)."""

    @staticmethod
    def forward(ctx, f, b):
        f, b = f.contiguous(), b.contiguous()
        c = linear_recurrence_fwd(f, b)
        ctx.save_for_backward(f, c)
        return c

    @staticmethod
    def backward(ctx, g):
        f, c = ctx.saved_tensors
        return linear_recurrence_bwd(g.contiguous(), f, c)


def linear_recurrence(f, b):
    """Differentiable c_t = f_t c_{t-1} + b_t along axis 0 of (T, B, H)."""
    return LinearRecurrence.apply(f, b)
