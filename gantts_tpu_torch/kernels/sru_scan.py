"""One direction of one SRU layer: hand-written CUDA kernels for Hopper, their
plain PyTorch versions, and the autograd Functions around them.

Counterpart of gantts_tpu/kernels/sru_scan.py.  Three kernels, built from
``csrc/sru_scan.cu`` at first use (see that file's note for what bounds each
one on the card and what its design does about it):

  ``sru_proj_gemm``  u = x @ W, f32 accumulation, u in the I/O dtype
                     (replaces ``_proj_u`` of ``_psru_fwd_kernel``);
  ``sru_fwd_scan``   gates, length mask, recurrence and highway output from u
                     (replaces the scan of ``_psru_fwd_kernel`` and all of
                     ``_fused_fwd_kernel``);
  ``sru_bwd_scan``   the adjoint recurrence, du and the f/r bias gradient
                     (replaces ``_fused_bwd_kernel``).

Each wrapper takes the plain version when, and only when, its tensors lie on
the CPU.  A CUDA tensor goes to the kernel; anything the kernel does not take
raises, and so does a failed build or launch.  Each launch adds one to
``launch_counts[name]``.

Layout is time-major: x (T, B, D), u and du (T, B, 4H) as [x~ | f | r | x']
blocks, h, c and the cotangent of h (T, B, H).  I/O is float32 or bfloat16;
the recurrence state c, the bias and its gradient are always float32.  The
bias vector is (4H,) ``[0, bf, br, 0]``: only the f and r blocks are read,
and only they receive gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

IO_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = {"sru_proj_gemm": 0, "sru_fwd_scan": 0, "sru_bwd_scan": 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def io_dtype(compute_dtype):
    """I/O dtype of the kernels for a model ``compute_dtype``."""
    return (torch.bfloat16 if str(compute_dtype).endswith("bfloat16")
            else torch.float32)


def mm_f32(a, b):
    """2-D ``a @ b`` of two float32 or two bfloat16 operands, accumulated
    and returned in float32.  bf16 products are exact in f32, so on the CPU
    upcasting first gives the same products as the card's f32-output GEMM."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and what the kernels are held to on the card.
# ---------------------------------------------------------------------------


def sru_proj_gemm_plain(x2, w):
    return mm_f32(x2, w).to(x2.dtype)


def sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu):
    """Returns h (T, B, H) in u's dtype and c (T, B, H) float32.

    A Python loop over T with exactly the kernel's cell math.  It is
    differentiable, so the k=3 layer (no kernel yet) runs through it too."""
    T, B, H4 = u.shape
    H = H4 // 4
    bf, br = bias4[H:2 * H].float(), bias4[2 * H:3 * H].float()
    lengths = lengths.to(u.device)
    c = torch.zeros((B, H), dtype=torch.float32, device=u.device)
    hs, cs = [None] * T, [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        ut = u[t].float()
        m = (t < lengths).float()[:, None]
        f = torch.sigmoid(ut[:, H:2 * H] + bf)
        c = (f * m + (1.0 - m)) * c + (1.0 - f) * ut[:, :H] * m
        r = torch.sigmoid(ut[:, 2 * H:3 * H] + br)
        g = torch.relu(c) if use_relu else torch.tanh(c)
        hs[t] = ((r * g + (1.0 - r) * ut[:, 3 * H:]) * m).to(u.dtype)
        cs[t] = c
    return torch.stack(hs), torch.stack(cs)


def sru_bwd_scan_plain(u, bias4, lengths, c, gh, reverse, use_relu):
    """Returns du (T, B, 4H) in u's dtype and db (4H,) float32.

    Walks T opposite to the forward pass: ghat_t = a_t + fm_{t+1} ghat_{t+1}
    with a = gh m r g'(c); the forward's previous state c_{t-1} is read from
    c.  The bias gradient is summed per (b, h) over T, then over B, in the
    kernel's order."""
    T, B, H4 = u.shape
    H = H4 // 4
    bf, br = bias4[H:2 * H].float(), bias4[2 * H:3 * H].float()
    lengths = lengths.to(u.device)
    zeros = torch.zeros((B, H), dtype=torch.float32, device=u.device)
    ghat, fm_next, dbf, dbr = zeros, zeros, zeros, zeros
    du = [None] * T
    for s in range(T):
        t = s if reverse else T - 1 - s
        tp = t + 1 if reverse else t - 1
        ut = u[t].float()
        cp = c[tp] if 0 <= tp < T else zeros
        g_h = gh[t].float()
        m = (t < lengths).float()[:, None]
        f = torch.sigmoid(ut[:, H:2 * H] + bf)
        r = torch.sigmoid(ut[:, 2 * H:3 * H] + br)
        if use_relu:
            g = torch.relu(c[t])
            gp = (c[t] > 0).float()
        else:
            g = torch.tanh(c[t])
            gp = 1.0 - g * g
        ghat = g_h * m * r * gp + fm_next * ghat
        fm_next = f * m + (1.0 - m)
        du_f = m * ghat * (cp - ut[:, :H]) * f * (1.0 - f)
        du_r = g_h * m * (g - ut[:, 3 * H:]) * r * (1.0 - r)
        du[t] = torch.cat([ghat * (1.0 - f) * m, du_f, du_r,
                           g_h * (1.0 - r) * m], dim=-1).to(u.dtype)
        dbf = dbf + du_f
        dbr = dbr + du_r
    z = torch.zeros(H, dtype=torch.float32, device=u.device)
    return torch.stack(du), torch.cat([z, dbf.sum(0), dbr.sum(0), z])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    from gantts_tpu_torch.kernels._build import load_library

    lib = load_library("sru_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sru_error_string.argtypes = [I]
    lib.sru_error_string.restype = ctypes.c_char_p
    lib.sru_proj_gemm.argtypes = [P, P, P, I, I, I, I, P]
    lib.sru_fwd_scan.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.sru_bwd_scan.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    for fn in (lib.sru_proj_gemm, lib.sru_fwd_scan, lib.sru_bwd_scan):
        fn.restype = I
    return lib


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _require(name, t, what, device, dtypes, shape):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: {what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _launched(name, code):
    if code != 0:
        msg = _lib().sru_error_string(code).decode()
        raise RuntimeError(f"{name}: launch failed ({code}: {msg})")
    launch_counts[name] += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def sru_proj_gemm(x2, w):
    """u = x2 @ w: (M, K) x (K, N) -> (M, N) in x2's dtype, f32 accumulation.

    The bf16 kernel loads 8 elements (16 bytes) at a time, so it takes K and
    N in multiples of 8 and 16-byte aligned operands.  Anything else is
    zero-padded into fresh allocations here (the first layer's K=425 to
    432): the padding adds only zero products."""
    if _on_cpu(x2, w):
        return sru_proj_gemm_plain(x2, w)
    name, dev = "sru_proj_gemm", x2.device
    M, K = x2.shape
    N = w.shape[1]
    _require(name, x2, "x", dev, IO_DTYPES, (M, K))
    _require(name, w, "w", dev, (x2.dtype,), (K, N))
    Np = N
    if x2.dtype == torch.bfloat16:
        pad_k, Np = -K % 8, N + -N % 8
        if pad_k or Np != N or x2.data_ptr() % 16 or w.data_ptr() % 16:
            x2 = F.pad(x2, (0, pad_k))
            w = F.pad(w, (0, Np - N, 0, pad_k))
            K += pad_k
    u = torch.empty((M, Np), dtype=x2.dtype, device=dev)
    _launched(name, _lib().sru_proj_gemm(
        x2.data_ptr(), w.data_ptr(), u.data_ptr(), M, Np, K,
        int(x2.dtype == torch.bfloat16), _stream(dev)))
    return u if Np == N else u[:, :N].contiguous()


def sru_fwd_scan(u, bias4, lengths, reverse, use_relu):
    """(u, bias4, lengths) -> (h in u's dtype, c float32), both (T, B, H)."""
    if _on_cpu(u, bias4, lengths):
        return sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu)
    name, dev = "sru_fwd_scan", u.device
    T, B, H4 = u.shape
    H = H4 // 4
    _require(name, u, "u", dev, IO_DTYPES, (T, B, 4 * H))
    _require(name, bias4, "bias4", dev, (torch.float32,), (4 * H,))
    _require(name, lengths, "lengths", dev, (torch.int32,), (B,))
    h = torch.empty((T, B, H), dtype=u.dtype, device=dev)
    c = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    _launched(name, _lib().sru_fwd_scan(
        u.data_ptr(), bias4.data_ptr(), lengths.data_ptr(), h.data_ptr(),
        c.data_ptr(), T, B, H, int(bool(reverse)), int(bool(use_relu)),
        int(u.dtype == torch.bfloat16), _stream(dev)))
    return h, c


def sru_bwd_scan(u, bias4, lengths, c, gh, reverse, use_relu):
    """-> (du in u's dtype (T, B, 4H), db float32 (4H,)).  ``gh`` is the
    cotangent of h in u's dtype; ``reverse`` is the forward layer's."""
    if _on_cpu(u, bias4, lengths, c, gh):
        return sru_bwd_scan_plain(u, bias4, lengths, c, gh, reverse,
                                  use_relu)
    name, dev = "sru_bwd_scan", u.device
    T, B, H4 = u.shape
    H = H4 // 4
    _require(name, u, "u", dev, IO_DTYPES, (T, B, 4 * H))
    _require(name, bias4, "bias4", dev, (torch.float32,), (4 * H,))
    _require(name, lengths, "lengths", dev, (torch.int32,), (B,))
    _require(name, c, "c", dev, (torch.float32,), (T, B, H))
    _require(name, gh, "gh", dev, (u.dtype,), (T, B, H))
    du = torch.empty((T, B, 4 * H), dtype=u.dtype, device=dev)
    dbp = torch.empty((B, 2 * H), dtype=torch.float32, device=dev)
    _launched(name, _lib().sru_bwd_scan(
        u.data_ptr(), bias4.data_ptr(), lengths.data_ptr(), c.data_ptr(),
        gh.data_ptr(), du.data_ptr(), dbp.data_ptr(), T, B, H,
        int(bool(reverse)), int(bool(use_relu)),
        int(u.dtype == torch.bfloat16), _stream(dev)))
    z = torch.zeros(H, dtype=torch.float32, device=dev)
    return du, torch.cat([z, dbp.sum(0), z])  # [0 | dbf | dbr | 0]


# ---------------------------------------------------------------------------
# Autograd and the public layer functions
# ---------------------------------------------------------------------------


class _SRUProjLayer(torch.autograd.Function):
    """h = scan(x @ W).  W arrives in its parameter dtype and is cast to the
    I/O dtype inside, so dW stays in the parameter dtype (float32)."""

    @staticmethod
    def forward(ctx, x, w, bias4, lengths, reverse, use_relu):
        T, B, D = x.shape
        w_c = w.to(x.dtype).contiguous()
        u = sru_proj_gemm(x.reshape(T * B, D), w_c).reshape(T, B, -1)
        h, c = sru_fwd_scan(u, bias4, lengths, reverse, use_relu)
        ctx.save_for_backward(x, w_c, bias4, lengths, u, c)
        ctx.flags = (reverse, use_relu, w.dtype)
        return h

    @staticmethod
    def backward(ctx, gh):
        x, w_c, bias4, lengths, u, c = ctx.saved_tensors
        reverse, use_relu, w_dtype = ctx.flags
        du, db = sru_bwd_scan(u, bias4, lengths, c,
                              gh.to(u.dtype).contiguous(), reverse, use_relu)
        T, B, D = x.shape
        du2 = du.reshape(T * B, -1)
        # dx and dW stay library matmuls, as the JAX package leaves them to
        # XLA: operands in the I/O dtype, f32 accumulation.
        dx = mm_f32(du2, w_c.t()).reshape(T, B, D).to(x.dtype)
        dw = mm_f32(x.reshape(T * B, D).t(), du2).to(w_dtype)
        return dx, dw, db, None, None, None


class _SRULayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, bias4, lengths, reverse, use_relu):
        h, c = sru_fwd_scan(u, bias4, lengths, reverse, use_relu)
        ctx.save_for_backward(u, bias4, lengths, c)
        ctx.flags = (reverse, use_relu)
        return h

    @staticmethod
    def backward(ctx, gh):
        u, bias4, lengths, c = ctx.saved_tensors
        du, db = sru_bwd_scan(u, bias4, lengths, c,
                              gh.to(u.dtype).contiguous(), *ctx.flags)
        return du, db, None, None, None


def _bias_and_lengths(bias4, lengths, H4, device):
    if bias4 is None:
        bias4 = torch.zeros(H4, dtype=torch.float32, device=device)
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    return bias4.float().contiguous(), lengths.contiguous()


def fused_sru_proj_layer(x, w, lengths, bias4=None, reverse=False,
                         use_relu=0, compute_dtype="float32"):
    """One SRU layer direction from the raw input: x (T, B, D), w (D, 4H) in
    its parameter dtype, lengths (B,).  Returns h (T, B, H) in the compute
    I/O dtype, zero on padded frames.  dx comes back in x's dtype."""
    bias4, lengths = _bias_and_lengths(bias4, lengths, w.shape[-1], x.device)
    x = x.to(io_dtype(compute_dtype)).contiguous()
    return _SRUProjLayer.apply(x, w, bias4, lengths, bool(reverse),
                               bool(use_relu))


def fused_sru_layer(u, lengths, bias4=None, reverse=False, use_relu=0):
    """One SRU layer direction from u = x @ W (T, B, 4H), float32 or
    bfloat16.  Returns h (T, B, H) in u's dtype, zero on padded frames."""
    bias4, lengths = _bias_and_lengths(bias4, lengths, u.shape[-1], u.device)
    return _SRULayer.apply(u.contiguous(), bias4, lengths, bool(reverse),
                           bool(use_relu))
