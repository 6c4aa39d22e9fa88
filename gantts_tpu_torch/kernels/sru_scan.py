"""One direction of one SRU layer: hand-written CUDA kernels for Hopper, their
plain PyTorch versions, and the autograd Functions around them.

Counterpart of gantts_tpu/kernels/sru_scan.py.  Three kernels, built from
``csrc/sru_scan.cu`` at first use (that file's notes say what bounds each one
on the card, what its design does about it, and how it rounds):

  ``sru_proj_gemm``  u = x @ W, f32 accumulation, u in the I/O dtype
                     (replaces ``_proj_u`` of ``_psru_fwd_kernel``).  bf16 is
                     a wgmma kernel fed by TMA; f32 an FMA kernel fed by a
                     cp.async ring, with K split across blocks as
                     ``_f32_gemm_plan`` says;
  ``sru_fwd_scan``   gates, length mask, recurrence and highway output from u
                     (replaces the scan of ``_psru_fwd_kernel`` and all of
                     ``_fused_fwd_kernel``);
  ``sru_bwd_scan``   the adjoint recurrence, du and the f/r bias gradient
                     (replaces ``_fused_bwd_kernel``), writing the whole
                     (4H,) bias gradient itself.

Both scans split T into runs whose scans are joined through their carries,
so they sum in another order than the plain versions (f32 rounding apart).

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
from typing import NamedTuple

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

    A Python loop over T with the kernel's cell math, summed step by step
    (the kernel joins 4-step runs through their carries, f32 rounding
    apart).  Padded frames (t >= length) get h = 0 and c = the carried
    value: the last valid c in the forward traversal, 0 in the reversed
    one, before the first valid frame.  It is differentiable; the CPU path
    and the tests use it."""
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
# The f32 GEMM's plan
# ---------------------------------------------------------------------------

F32_TILE_K = 32  # the kernel's kFBK: k a pipeline stage
# The kernel's tiles, (tile_m, tile_n) -> blocks resident on an SM
F32_TILES = {(128, 256): 1, (128, 128): 2, (64, 128): 2}
F32_WAVES = 4          # 128x256 tiles only when they fill the SMs 4 times
F32_MIN_SPLIT_K = 64   # K a split takes at least: two stages


class GemmPlan(NamedTuple):
    """How the f32 kernel cuts (M, K) x (K, N): tiles of tile_m x tile_n
    outputs, each computed by ``splits`` blocks, split z over k in
    ``k_ranges[z]`` (``k_steps`` steps of F32_TILE_K each, the last one
    shorter); the splits' partial tiles go to ``workspace`` floats (splits x
    M x N, none unsplit) and are added in order of z."""
    tile_m: int
    tile_n: int
    tiles_m: int
    tiles_n: int
    splits: int
    k_steps: int
    k_ranges: tuple
    workspace: int


def _cdiv(a, b):
    return -(-a // b)


def _f32_gemm_plan(M, N, K, sm_count):
    """The tile and split-K choice of the f32 kernel, for ``sm_count`` SMs.

    128 x 256 tiles (8 x 16 outputs a thread, one block an SM) where they
    fill the SMs F32_WAVES times or more, so that the last wave's idle SMs
    cost little; else 128 x 128 (two blocks an SM), or 64 x 128 (two) when
    M <= 64.  K is split only when those tiles are fewer than the
    SMs: into as many splits as fill the SMs with resident blocks, each of
    at least F32_MIN_SPLIT_K of K, then evened out so that every split is
    non-empty."""
    tile_m, tile_n = 128, 256
    if _cdiv(M, tile_m) * _cdiv(N, tile_n) < F32_WAVES * sm_count:
        tile_m, tile_n = (64 if M <= 64 else 128), 128
    tiles_m, tiles_n = _cdiv(M, tile_m), _cdiv(N, tile_n)
    tiles = tiles_m * tiles_n
    nk = _cdiv(K, F32_TILE_K)
    want = 1
    if 0 < tiles < sm_count:
        want = max(1, min(F32_TILES[tile_m, tile_n] * sm_count // tiles,
                          K // F32_MIN_SPLIT_K))
    k_steps = _cdiv(nk, want)
    splits = _cdiv(nk, k_steps) if k_steps else 1
    span = k_steps * F32_TILE_K
    k_ranges = tuple((z * span, min(K, (z + 1) * span))
                     for z in range(splits))
    return GemmPlan(tile_m, tile_n, tiles_m, tiles_n, splits, k_steps,
                    k_ranges, splits * M * N if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib.sru_proj_gemm_bf16.argtypes = [P, P, P, I, I, I, I, P]
    lib.sru_proj_gemm_f32.argtypes = [P, P, P, P] + [I] * 8 + [P]
    lib.sru_fwd_scan.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.sru_bwd_scan.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                 P]
    for fn in (lib.sru_proj_gemm_bf16, lib.sru_proj_gemm_f32,
               lib.sru_fwd_scan, lib.sru_bwd_scan):
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

    Both kernels read w's rows in 16-byte pieces (TMA in bf16, cp.async in
    f32), which takes a row stride and a base in multiples of 16 bytes: an
    N that is not a multiple of 8 (bf16) or 4 (f32), or a misaligned w, is
    zero-padded into a fresh w, and u sliced back to N columns.  The bf16
    kernel reads x the same way, so a K that is not a multiple of 8 (the
    first layer's 425) or a misaligned x makes x be copied into rows
    8-aligned apart; the f32 kernel copies x 4 bytes at a time and takes it
    as it is.  The f32 kernel follows ``_f32_gemm_plan`` and gets its
    split-K workspace from here."""
    if _on_cpu(x2, w):
        return sru_proj_gemm_plain(x2, w)
    name, dev = "sru_proj_gemm", x2.device
    M, K = x2.shape
    N = w.shape[1]
    _require(name, x2, "x", dev, IO_DTYPES, (M, K))
    _require(name, w, "w", dev, (x2.dtype,), (K, N))
    bf16 = x2.dtype == torch.bfloat16
    Np, ldx = N + -N % (8 if bf16 else 4), K
    if bf16 and (K % 8 or x2.data_ptr() % 16):
        ldx = K + -K % 8
        xp = torch.empty((M, ldx), dtype=x2.dtype, device=dev)
        x2 = xp[:, :K].copy_(x2)  # its row stride is ldx
    if Np != N or w.data_ptr() % 16:
        w = F.pad(w, (0, Np - N))
    u = torch.empty((M, Np), dtype=x2.dtype, device=dev)
    if bf16:
        code = _lib().sru_proj_gemm_bf16(
            x2.data_ptr(), w.data_ptr(), u.data_ptr(), M, Np, K, ldx,
            _stream(dev))
    else:
        plan = _f32_gemm_plan(M, Np, K, _sm_count(dev.index))
        ws = (torch.empty(plan.workspace, dtype=torch.float32, device=dev)
              if plan.splits > 1 else None)
        code = _lib().sru_proj_gemm_f32(
            x2.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if ws is None else ws.data_ptr(), M, Np, K, ldx,
            plan.tile_m, plan.tile_n, plan.splits, plan.k_steps,
            _stream(dev))
    _launched(name, code)
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
    cotangent of h in u's dtype; ``reverse`` is the forward layer's.  The
    kernel joins the per-b bias gradients through counters of its own, so
    two of its launches must not overlap on different streams."""
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
    db = torch.empty(4 * H, dtype=torch.float32, device=dev)
    dbp = torch.empty((B, 2 * H), dtype=torch.float32, device=dev)  # scratch
    _launched(name, _lib().sru_bwd_scan(
        u.data_ptr(), bias4.data_ptr(), lengths.data_ptr(), c.data_ptr(),
        gh.data_ptr(), du.data_ptr(), dbp.data_ptr(), db.data_ptr(), T, B, H,
        int(bool(reverse)), int(bool(use_relu)),
        int(u.dtype == torch.bfloat16), _stream(dev)))
    return du, db


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
