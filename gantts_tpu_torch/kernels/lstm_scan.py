"""The LSTM recurrence, one or two directions of one layer per launch:
hand-written CUDA kernels for Hopper, their plain PyTorch versions, and the
autograd Functions around them.

Counterpart of gantts_tpu/kernels/lstm_scan.py.  Two kernels, built from
``csrc/lstm_scan.cu`` at first use (see that file's note for what bounds
them on the card and what their design does about it):

  ``lstm_fwd_scan``  gates, masked h/c carries, y, c and the activated gates
                     g4 from xp = x @ W_ih (replaces the recurrence of
                     ``_lstm_fwd_kernel``, ``_plstm_fwd_kernel`` and
                     ``_bilstm_fwd_kernel``);
  ``lstm_bwd_scan``  masked BPTT from the stored gates: dxp (= dgates) and
                     the bias gradient (replaces ``_lstm_bwd_kernel`` and
                     ``_bilstm_bwd_kernel``).

Three designs for each, chosen by shape in the launcher (``fwd_design``
and ``bwd_design`` say which a shape takes).  In bf16 with H of 256 or 512
and B up to 24 (the training steps' shapes) each kernel runs one
thread-block cluster per direction, with its block's slice of W_hh in
registers: the forward all-gathers each step's h_t, the backward
reduce-scatters its partial products, through distributed shared memory.
In float32 where ``_flag_plan`` gives a plan (H of 256 to 512, B up to 24:
the f32 paths' shapes) each direction is spread over H / U blocks of U
units (the "flag" design), W_hh's slice in registers, the same all-gather
and reduce-scatter through global scratch, each block releasing a step flag
that the blocks needing its part poll; with one direction the rows are cut
into two slices, each with blocks, flags and scratch of its own (a row's
recurrence needs only its own h and dh), so that 128 blocks of 8 units
stage half the bytes a step; the wrapper allocates the scratch and zeroes
the flags.  Every other shape (f32 the plan refuses, other H,
larger B) takes a persistent cooperative launch: a direction's blocks
exchange each step's activations through global memory and meet at a grid
barrier.  The flag and the cooperative designs need every block resident at
once, or the launch fails and the wrapper raises.  A cluster launch that
fails raises too; nothing falls back to another design.

The input projection, which the TPU kernels run inside their bodies, is the
port's ``sru_proj_gemm`` (the counterpart of ``_proj_u``), one launch over
both directions' concatenated W_ih.  dW_hh, dx and dW_ih stay library
matmuls (``mm_f32``), as the JAX package leaves them to XLA.

Each wrapper takes the plain version when, and only when, its tensors lie on
the CPU.  A CUDA tensor goes to the kernel; anything the kernel does not take
raises, and so does a failed build or launch.  Each launch adds one to
``launch_counts[name]``, the dict shared with ``sru_scan``.

Layout is time-major, with the ``ndir`` directions (1 or 2) side by side on
the last axis: xp, g4 and dxp are (T, B, ndir*4H), direction d's gate blocks
[i | f | g | o] (torch's order) at [d*4H, (d+1)*4H); y, c and the cotangent
of y are (T, B, ndir*H).  W_hh is (ndir, H, 4H) in the I/O dtype, the summed
bias b_ih + b_hh (ndir, 4H) float32, lengths (B,) int32, and ``reverse`` one
flag per direction.  I/O is float32 or bfloat16; the carries, c, the gate
math, the bias and its gradient are float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gantts_tpu_torch.kernels.sru_scan import (
    IO_DTYPES,
    _on_cpu,
    _require,
    _sm_count,
    _stream,
    io_dtype,
    launch_counts,
    mm_f32,
    reset_launch_counts,
    sru_proj_gemm,
)

launch_counts.update(lstm_fwd_scan=0, lstm_bwd_scan=0)
DESIGNS = ("cooperative", "cluster", "flag")

# The flag design's plan, as csrc/lstm_scan.cu's ``f32_flag_plan``:
# (units a block, row slices), in order of preference, by way (kFPlans)
FLAG_PLANS = {"fwd": ((8, 2), (4, 1), (8, 1)),
              "bwd": ((8, 2), (8, 1), (4, 1))}
FLAG_MAX_B = 24           # rows it takes (kFMaxB)
FLAG_MAX_H = 512          # H it takes, at most (kFMaxH)
FLAG_MIN_BLOCKS = 64      # blocks a direction, at least (kFMinBlocks)
FLAG_SPLITS = 32          # the forward product's K splits (kFSplits)
SMEM_LIMIT = 232448       # shared memory a block may use on Hopper
FLAG_THREADS = 256        # threads a block (kThreads)


class FlagPlan(NamedTuple):
    """How a flag kernel cuts one layer: ``units`` hidden units a block
    (the block's 4 * units gate columns of W_hh, all H rows, in registers
    for the launch), ``blocks`` blocks a direction and row slice, ``grid``
    blocks in all (one an SM), its shared memory a block, the ``slices``
    the B rows are cut into (each with its own blocks) and the ``rows`` a
    block pads its slice's rows to."""
    units: int
    blocks: int
    grid: int
    smem: int
    slices: int
    rows: int


def _pad4(B):
    return -(-B // 4) * 4


def _padded_rows(B, slices):
    """A block's rows (csrc ``padded_rows``): B rounded up to 4 in one
    slice; a slice's ceil(B / slices) rows rounded up to 2 in more."""
    per = -(-B // slices)
    return _pad4(B) if slices == 1 else per + per % 2


def _flag_plan(B, H, ndir, dtype, sm_count, way):
    """The flag design's plan for ``lstm_{way}_scan`` (way "fwd" or "bwd")
    at (B, H, ndir) in ``dtype`` on ``sm_count`` SMs, or None where the
    cooperative design takes the shape: float32, 1 <= B <= FLAG_MAX_B,
    H <= FLAG_MAX_H, and the first (U, RS) of FLAG_PLANS[way] where U
    divides H by 32 U (the threads' split of the products), gives at least
    FLAG_MIN_BLOCKS blocks of U units a direction, every block of every
    direction and row slice has its own SM, every slice holds a row
    (B >= RS), and the kernel's shared memory fits (W_hh's slice lives in
    registers):

      "fwd"  h_{t-1} H x Bp, the K splits' partial sums 32 x Bp x 5U,
             the xp slots 2 x 256 x 4 (floats);
      "bwd"  the partial-dh slices H x Bp, dgates_t 4U x Bp, the cell
             input slots 2 x 2 x 256 x 4;

    Bp is a block's padded rows (``_padded_rows``)."""
    if (dtype != torch.float32 or not 1 <= B <= FLAG_MAX_B
            or not 1 <= H <= FLAG_MAX_H):
        return None
    for U, rs in FLAG_PLANS[way]:
        nb, bp = H // U, _padded_rows(B, rs)
        if (H % (32 * U) or nb < FLAG_MIN_BLOCKS or ndir * rs * nb > sm_count
                or B < rs):
            continue
        if way == "fwd":
            smem = 4 * (H * bp + FLAG_SPLITS * bp * 5 * U
                        + 2 * 4 * FLAG_THREADS)
        else:
            smem = 4 * (H * bp + 4 * U * bp + 2 * 2 * 4 * FLAG_THREADS)
        if smem <= SMEM_LIMIT:
            return FlagPlan(U, nb, ndir * rs * nb, smem, rs, bp)
    return None


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and what the kernels are held to on the card.
# ---------------------------------------------------------------------------


def lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse):
    """Returns y (T, B, ndir*H) and g4 (T, B, ndir*4H) in xp's dtype, and c
    (T, B, ndir*H) float32.

    A Python loop over T with exactly the kernel's cell math: pre = (xp_t +
    b) + h_{t-1} @ W_hh, with h cast to W_hh's dtype and f32 accumulation."""
    T, B, _ = xp.shape
    ndir, H = whh.shape[:2]
    lengths = lengths.to(xp.device)
    ys, cs, gs = [], [], []
    for d in range(ndir):
        xpd, w, b = xp[..., 4 * H * d:4 * H * (d + 1)], whh[d], bias[d].float()
        h = torch.zeros((B, H), dtype=torch.float32, device=xp.device)
        c = h
        y_t, c_t, g_t = [None] * T, [None] * T, [None] * T
        for s in range(T):
            t = T - 1 - s if reverse[d] else s
            m = (t < lengths).float()[:, None]
            pre = xpd[t].float() + b + mm_f32(h.to(w.dtype), w)
            ig = torch.sigmoid(pre[:, :H])
            fg = torch.sigmoid(pre[:, H:2 * H])
            gg = torch.tanh(pre[:, 2 * H:3 * H])
            og = torch.sigmoid(pre[:, 3 * H:])
            c_new = fg * c + ig * gg
            h_new = og * torch.tanh(c_new)
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            y_t[t] = (h_new * m).to(xp.dtype)
            c_t[t] = c
            g_t[t] = torch.cat([ig, fg, gg, og], dim=-1).to(xp.dtype)
        ys.append(torch.stack(y_t))
        cs.append(torch.stack(c_t))
        gs.append(torch.stack(g_t))
    return torch.cat(ys, -1), torch.cat(cs, -1), torch.cat(gs, -1)


def lstm_bwd_scan_plain(whh, lengths, c, g4, gy, reverse):
    """Returns dxp (T, B, ndir*4H) in g4's dtype and db (ndir, 4H) float32.

    Walks T opposite to each direction's forward traversal.  c_{t-1} is read
    from c at the forward's previous step (zero at its start); the carried
    dh takes dxp_t @ W_hh^T with dxp_t in its stored dtype.  The bias
    gradient is summed per (b, column) over T, then over B, in the kernel's
    order."""
    T, B, _ = g4.shape
    ndir, H = whh.shape[:2]
    lengths = lengths.to(g4.device)
    dxps, dbs = [], []
    for d in range(ndir):
        w = whh[d]
        g4d = g4[..., 4 * H * d:4 * H * (d + 1)]
        cd, gyd = c[..., H * d:H * (d + 1)], gy[..., H * d:H * (d + 1)]
        dh = torch.zeros((B, H), dtype=torch.float32, device=g4.device)
        dc, zeros = dh, dh
        db = torch.zeros((B, 4 * H), dtype=torch.float32, device=g4.device)
        dxp = [None] * T
        for s in range(T):
            t = s if reverse[d] else T - 1 - s
            tp = t + 1 if reverse[d] else t - 1
            m = (t < lengths).float()[:, None]
            gates = g4d[t].float()
            ig, fg = gates[:, :H], gates[:, H:2 * H]
            gg, og = gates[:, 2 * H:3 * H], gates[:, 3 * H:]
            cp = cd[tp] if 0 <= tp < T else zeros
            tc = torch.tanh(cd[t])
            da = m * (dh + gyd[t].float())
            do_ = da * tc
            dc_new = da * og * (1.0 - tc * tc) + m * dc
            di, df, dg = dc_new * gg, dc_new * cp, dc_new * ig
            dgates = torch.cat([di * ig * (1.0 - ig), df * fg * (1.0 - fg),
                                dg * (1.0 - gg * gg), do_ * og * (1.0 - og)],
                               dim=-1)
            dxp[t] = dgates.to(g4.dtype)
            db = db + dgates
            dh = (1.0 - m) * dh + mm_f32(dxp[t].to(w.dtype), w.t())
            dc = (1.0 - m) * dc + dc_new * fg
        dxps.append(torch.stack(dxp))
        dbs.append(db.sum(0))
    return torch.cat(dxps, -1), torch.stack(dbs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    from gantts_tpu_torch.kernels._build import load_library

    return _bind(load_library("lstm_scan"))


def _bind(lib):
    """Sets the C signatures on ``lib``, a loaded build of lstm_scan.cu (the
    package's, or a tool's patched copy), and returns it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_error_string.argtypes = [I]
    lib.lstm_error_string.restype = ctypes.c_char_p
    lib.lstm_fwd_scan.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.lstm_bwd_scan.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.lstm_flag_units.argtypes = [I, I, I, I, I]
    lib.lstm_flag_slices.argtypes = [I, I, I, I, I]
    for way in ("fwd", "bwd"):
        getattr(lib, f"lstm_{way}_design").argtypes = [I, I, I, I]
        getattr(lib, f"lstm_{way}_cluster_occupancy").argtypes = [I, P]
    for fn in (lib.lstm_fwd_scan, lib.lstm_bwd_scan, lib.lstm_fwd_design,
               lib.lstm_bwd_design, lib.lstm_flag_units,
               lib.lstm_flag_slices,
               lib.lstm_fwd_cluster_occupancy,
               lib.lstm_bwd_cluster_occupancy):
        fn.restype = I
    return lib


def _design(way, B, H, dtype, ndir):
    code = getattr(_lib(), f"lstm_{way}_design")(
        B, H, ndir, int(dtype == torch.bfloat16))
    if code < 0:
        raise RuntimeError(f"lstm_{way}_design: the device cannot be queried")
    return DESIGNS[code]


def fwd_design(B, H, dtype, ndir=1):
    """The design ``lstm_fwd_scan``'s launcher takes at this shape on the
    current device: "cluster" (bf16, H of 256 or 512, B up to 24), "flag"
    (float32 where ``_flag_plan`` gives a plan) or "cooperative"."""
    return _design("fwd", B, H, dtype, ndir)


def bwd_design(B, H, dtype, ndir=1):
    """The design ``lstm_bwd_scan``'s launcher takes at this shape, as
    ``fwd_design``."""
    return _design("bwd", B, H, dtype, ndir)


def _checked_flag_plan(way, B, H, dtype, ndir, device):
    """``_flag_plan`` on ``device``, held to the launcher's own rule."""
    name = f"lstm_{way}_scan"
    plan = _flag_plan(B, H, ndir, dtype, _sm_count(device.index), way)
    args = (B, H, ndir, int(dtype == torch.bfloat16), int(way == "bwd"))
    units = _lib().lstm_flag_units(*args)
    slices = _lib().lstm_flag_slices(*args)
    if ((plan.units, plan.slices) if plan else (0, 1)) != (units, slices):
        raise RuntimeError(f"{name}: the launcher plans {units} units a "
                           f"block in {slices} row slices, _flag_plan "
                           f"{plan}")
    return plan


def _cluster_occupancy(name, H):
    n = ctypes.c_int(0)
    code = getattr(_lib(), name)(H, ctypes.addressof(n))
    if code != 0:
        msg = _lib().lstm_error_string(code).decode()
        raise RuntimeError(f"{name}: {code}: {msg}")
    return n.value


def fwd_cluster_occupancy(H):
    """How many clusters of the forward's cluster kernel (one per
    direction) can be resident at once on the current device, at H = 256
    or 512."""
    return _cluster_occupancy("lstm_fwd_cluster_occupancy", H)


def bwd_cluster_occupancy(H):
    """As ``fwd_cluster_occupancy``, for the backward's cluster kernel."""
    return _cluster_occupancy("lstm_bwd_cluster_occupancy", H)


def _launched(name, code):
    if code != 0:
        msg = _lib().lstm_error_string(code).decode()
        raise RuntimeError(f"{name}: launch failed ({code}: {msg})")
    launch_counts[name] += 1


def _rev_mask(name, reverse, ndir):
    if ndir not in (1, 2) or len(reverse) != ndir:
        raise ValueError(f"{name}: {ndir} directions with reverse flags "
                         f"{reverse}; expected 1 or 2 directions, one flag "
                         f"each")
    return sum(int(bool(r)) << d for d, r in enumerate(reverse))


def lstm_fwd_scan(xp, whh, bias, lengths, reverse):
    """(xp, W_hh, bias, lengths, reverse) -> (y, c float32, g4); see the
    module docstring for the layouts.  The launcher picks the design by
    shape (``fwd_design``); only the cooperative one takes the h scratch
    and the barrier counters."""
    if _on_cpu(xp, whh, bias, lengths):
        return lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    name, dev = "lstm_fwd_scan", xp.device
    T, B, _ = xp.shape
    ndir, H = whh.shape[:2]
    mask = _rev_mask(name, reverse, ndir)
    _require(name, xp, "xp", dev, IO_DTYPES, (T, B, ndir * 4 * H))
    _require(name, whh, "whh", dev, (xp.dtype,), (ndir, H, 4 * H))
    _require(name, bias, "bias", dev, (torch.float32,), (ndir, 4 * H))
    _require(name, lengths, "lengths", dev, (torch.int32,), (B,))
    y = torch.empty((T, B, ndir * H), dtype=xp.dtype, device=dev)
    c = torch.empty((T, B, ndir * H), dtype=torch.float32, device=dev)
    g4 = torch.empty((T, B, ndir * 4 * H), dtype=xp.dtype, device=dev)
    hx = bar = None
    design = fwd_design(B, H, xp.dtype, ndir)
    if design == "cooperative":
        hx = torch.empty((2, ndir, B, H), dtype=xp.dtype, device=dev)
        bar = torch.zeros(ndir, dtype=torch.int32, device=dev)
    elif design == "flag":  # h by parity and slice, [H][Bp]; a flag a block
        plan = _checked_flag_plan("fwd", B, H, xp.dtype, ndir, dev)
        hx = torch.empty((2, ndir * plan.slices, H, plan.rows),
                         dtype=xp.dtype, device=dev)
        bar = torch.zeros(plan.grid, dtype=torch.int32, device=dev)
    _launched(name, _lib().lstm_fwd_scan(
        xp.data_ptr(), whh.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
        y.data_ptr(), c.data_ptr(), g4.data_ptr(),
        None if hx is None else hx.data_ptr(),
        None if bar is None else bar.data_ptr(), T, B, H, ndir, mask,
        int(xp.dtype == torch.bfloat16), _stream(dev)))
    return y, c, g4


def lstm_bwd_scan(whh, lengths, c, g4, gy, reverse):
    """-> (dxp in g4's dtype, db float32 (ndir, 4H)).  ``gy`` is the
    cotangent of y in g4's dtype; ``reverse`` the forward layer's flags.
    The launcher picks the design by shape (``bwd_design``); only the
    cooperative one takes a barrier counter."""
    if _on_cpu(whh, lengths, c, g4, gy):
        return lstm_bwd_scan_plain(whh, lengths, c, g4, gy, reverse)
    name, dev = "lstm_bwd_scan", g4.device
    T, B, _ = g4.shape
    ndir, H = whh.shape[:2]
    mask = _rev_mask(name, reverse, ndir)
    _require(name, g4, "g4", dev, IO_DTYPES, (T, B, ndir * 4 * H))
    _require(name, whh, "whh", dev, (g4.dtype,), (ndir, H, 4 * H))
    _require(name, lengths, "lengths", dev, (torch.int32,), (B,))
    _require(name, c, "c", dev, (torch.float32,), (T, B, ndir * H))
    _require(name, gy, "gy", dev, (g4.dtype,), (T, B, ndir * H))
    dxp = torch.empty((T, B, ndir * 4 * H), dtype=g4.dtype, device=dev)
    dbp = torch.empty((B, ndir * 4 * H), dtype=torch.float32, device=dev)
    px = bar = None
    design = bwd_design(B, H, g4.dtype, ndir)
    if design == "cooperative":
        bar = torch.zeros(ndir, dtype=torch.int32, device=dev)
    elif design == "flag":  # each block's partial dh by parity and slice
        plan = _checked_flag_plan("bwd", B, H, g4.dtype, ndir, dev)
        px = torch.empty((2, ndir * plan.slices, plan.blocks, plan.rows, H),
                         dtype=torch.float32, device=dev)
        bar = torch.zeros(plan.grid, dtype=torch.int32, device=dev)
    _launched(name, _lib().lstm_bwd_scan(
        whh.data_ptr(), lengths.data_ptr(), c.data_ptr(), g4.data_ptr(),
        gy.data_ptr(), dxp.data_ptr(), dbp.data_ptr(),
        None if px is None else px.data_ptr(),
        None if bar is None else bar.data_ptr(),
        T, B, H, ndir, mask, int(g4.dtype == torch.bfloat16), _stream(dev)))
    return dxp, dbp.sum(0).reshape(ndir, 4 * H)


# ---------------------------------------------------------------------------
# Autograd and the public layer functions
# ---------------------------------------------------------------------------


def _shifted_dwhh(y, dxp, d, H, layer_rev):
    """dW_hh of direction d = sum_t h_{t-1}^T @ dgates_t as one matmul.

    h_{t-1} in the forward's traversal order is y[t-1] for a forward layer
    and y[t+1] for a reversed one (zero at the traversal start, whose term
    is dropped).  y equals that carry wherever dgates is not zero."""
    T = y.shape[0]
    yd = y[..., H * d:H * (d + 1)]
    gd = dxp[..., 4 * H * d:4 * H * (d + 1)]
    h_prev, dg = (yd[1:], gd[:T - 1]) if layer_rev else (yd[:T - 1], gd[1:])
    return mm_f32(h_prev.reshape(-1, H).t(), dg.reshape(-1, 4 * H))


class _ProjGemm(torch.autograd.Function):
    """xp = x @ w through ``sru_proj_gemm``: f32 accumulation, xp in x's
    dtype.  w arrives in its parameter dtype and is cast inside, so dW stays
    in the parameter dtype (float32)."""

    @staticmethod
    def forward(ctx, x, w):
        T, B, D = x.shape
        w_c = w.to(x.dtype).contiguous()
        xp = sru_proj_gemm(x.reshape(T * B, D), w_c).reshape(T, B, -1)
        ctx.save_for_backward(x, w_c)
        ctx.w_dtype = w.dtype
        return xp

    @staticmethod
    def backward(ctx, g):
        x, w_c = ctx.saved_tensors
        T, B, D = x.shape
        g2 = g.to(x.dtype).reshape(T * B, -1)
        dx = dw = None
        # library matmuls, as the JAX package leaves them to XLA
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g2, w_c.t()).reshape(T, B, D).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(x.reshape(T * B, D).t(), g2).to(ctx.w_dtype)
        return dx, dw


class _LSTMScan(torch.autograd.Function):
    """y = the masked recurrence from xp, for ndir directions.  W_hh arrives
    in its parameter dtype and is cast to xp's inside, so dW_hh stays in the
    parameter dtype (float32)."""

    @staticmethod
    def forward(ctx, xp, whh, bias, lengths, reverse):
        whh_c = whh.to(xp.dtype).contiguous()
        y, c, g4 = lstm_fwd_scan(xp, whh_c, bias, lengths, reverse)
        ctx.save_for_backward(whh_c, lengths, y, c, g4)
        ctx.reverse, ctx.w_dtype = reverse, whh.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        whh_c, lengths, y, c, g4 = ctx.saved_tensors
        dxp, db = lstm_bwd_scan(whh_c, lengths, c, g4,
                                gy.to(g4.dtype).contiguous(), ctx.reverse)
        H = whh_c.shape[1]
        dwhh = torch.stack([_shifted_dwhh(y, dxp, d, H, rev)
                            for d, rev in enumerate(ctx.reverse)])
        return dxp, dwhh.to(ctx.w_dtype), db, None, None


def _lengths(lengths, device):
    return torch.as_tensor(lengths, device=device).to(torch.int32).contiguous()


def lstm_proj_layer(x, params, lengths, reverse, compute_dtype="float32"):
    """One LSTM layer, all its directions in one projection GEMM and one
    scan launch: x (T, B, D); ``params`` one dict per direction with
    ``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and ``bias`` (4H,), the summed
    b_ih + b_hh, in their parameter dtype; ``reverse`` one flag per
    direction.  Returns y (T, B, ndir*H) in the compute I/O dtype, the
    directions side by side, zero on padded frames.  dx comes back in x's
    dtype."""
    x = x.to(io_dtype(compute_dtype)).contiguous()
    w_ih = torch.cat([p["w_ih"] for p in params], dim=-1)
    xp = _ProjGemm.apply(x, w_ih)
    whh = torch.stack([p["w_hh"] for p in params])
    bias = torch.stack([p["bias"].float() for p in params])
    return _LSTMScan.apply(xp, whh, bias, _lengths(lengths, x.device),
                           tuple(bool(r) for r in reverse))


def fused_bilstm_proj_layer(x, params_fwd, params_bwd, lengths,
                            compute_dtype="float32"):
    """Both directions of one bidirectional layer in one launch each of the
    GEMM (over [W_ih_fwd | W_ih_bwd]) and the scan.  Returns (y_fwd, y_bwd),
    each (T, B, H) in the compute I/O dtype, views of one (T, B, 2H)."""
    y = lstm_proj_layer(x, [params_fwd, params_bwd], lengths, (False, True),
                        compute_dtype)
    H = params_fwd["w_hh"].shape[0]
    return y[..., :H], y[..., H:]


def fused_lstm_proj_layer(x, w_ih, w_hh, bias, lengths, reverse=False,
                          compute_dtype="float32"):
    """One LSTM layer direction from the raw input x (T, B, D).  Returns
    y (T, B, H) in the compute I/O dtype, zero on padded frames."""
    return lstm_proj_layer(x, [dict(w_ih=w_ih, w_hh=w_hh, bias=bias)],
                           lengths, (reverse,), compute_dtype)


def fused_lstm_layer(xp, w_hh, bias, lengths, reverse=False):
    """One LSTM layer direction from xp = x @ W_ih (T, B, 4H), float32 or
    bfloat16; w_hh (H, 4H) in its parameter dtype; bias (4H,) the summed
    b_ih + b_hh.  Returns y (T, B, H) in xp's dtype, zero on padded
    frames."""
    return _LSTMScan.apply(xp.contiguous(), w_hh[None], bias.float()[None],
                           _lengths(lengths, xp.device), (bool(reverse),))
