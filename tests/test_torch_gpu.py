"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the JAX package, so they run on a machine that has only PyTorch;
there, skip this directory's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Shapes are ragged on purpose: T=37 is not a multiple of the scans' unroll
or of the backward scan's 4-step runs and is shorter than its 64-step
window, B*H=240 lanes do not fill their last block, D is not a multiple of
the GEMM's K tile (the bf16 wrapper copies x with D=70 into rows 72 apart
for the TMA loads' 16-byte strides; D=64 goes in as it is), and T*B=185
rows do not fill their last 128-row tile.  Limits are those of
chip_smoke.py: max|kernel - plain| / max(max|plain|, 1) under 1e-4 in
float32 and 1e-2 in bfloat16 (one bf16 rounding of an output); the f32
bias gradient under 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from gantts_tpu_torch.kernels import linear_scan  # noqa: F401  (counters)
from gantts_tpu_torch.kernels import lstm_scan  # noqa: F401  (its counters)
from gantts_tpu_torch.kernels import sru_scan as K

pytestmark = pytest.mark.gpu

T, B, D, H = 37, 5, 70, 48
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def _inputs(dev, dt, seed=0, D=D):
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(T, B, D), dtype=dt, device=dev)
    w = torch.tensor(rs.randn(D, 4 * H) * 0.1, dtype=torch.float32,
                     device=dev)
    bias4 = torch.tensor(np.r_[np.zeros(H), rs.randn(2 * H) * 0.1,
                               np.zeros(H)], dtype=torch.float32, device=dev)
    lengths = torch.tensor(np.r_[rs.randint(5, T, B - 1), T],
                           dtype=torch.int32, device=dev)
    gh = torch.tensor(rs.randn(T, B, H), dtype=dt, device=dev)
    return x, w, bias4, lengths, gh


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
@pytest.mark.parametrize("D", [D, 64])
def test_kernels_match_plain_versions(cuda, dt, reverse, use_relu, D):
    x, w, bias4, lengths, gh = _inputs(cuda, dt, D=D)
    tol = TOL[dt]
    K.reset_launch_counts()
    x2, w_c = x.reshape(T * B, D), w.to(dt)
    u = K.sru_proj_gemm_plain(x2, w_c).reshape(T, B, 4 * H)
    assert _rel(K.sru_proj_gemm(x2, w_c).reshape(T, B, 4 * H), u) < tol
    h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, use_relu)
    h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu)
    assert h_k.dtype == dt and c_k.dtype == torch.float32
    assert _rel(h_k, h_p) < tol and _rel(c_k, c_p) < 1e-4
    du_k, db_k = K.sru_bwd_scan(u, bias4, lengths, c_p, gh, reverse,
                                use_relu)
    du_p, db_p = K.sru_bwd_scan_plain(u, bias4, lengths, c_p, gh, reverse,
                                      use_relu)
    assert _rel(du_k, du_p) < tol and _rel(db_k, db_p) < 1e-4
    torch.cuda.synchronize()
    assert dict(K.launch_counts) == {"sru_proj_gemm": 1, "sru_fwd_scan": 1,
                                     "sru_bwd_scan": 1, "lstm_fwd_scan": 0,
                                     "lstm_bwd_scan": 0,
                                     "linear_recurrence_fwd": 0,
                                     "linear_recurrence_bwd": 0}


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_on_card_matches_cpu(cuda, reverse):
    """fused_sru_proj_layer forward and backward, f32: the card's kernels
    against the CPU's plain versions."""
    results = []
    for dev in (torch.device("cpu"), cuda):
        x, w, bias4, lengths, gh = _inputs(dev, torch.float32, seed=1)
        args = [t.clone().requires_grad_(True) for t in (x, w, bias4)]
        h = K.fused_sru_proj_layer(args[0], args[1], lengths, bias4=args[2],
                                   reverse=reverse, use_relu=1)
        h.backward(gh)
        results.append([h] + [a.grad for a in args])
    for got, ref in zip(results[1], results[0]):
        assert _rel(got.cpu(), ref) < 1e-4


def test_srurnn_step_launches_every_kernel(cuda):
    """A 2-layer bidirectional SRURNN forward and backward on the card goes
    through each kernel once per layer and direction."""
    from gantts_tpu_torch.models import SRURNN

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = SRURNN(in_dim=D, out_dim=7, num_hidden=2, hidden_dim=H,
                   bidirectional=True, use_relu=1, rnn_dropout=0.2,
                   compute_dtype="bfloat16", generator=gen,
                   device=cuda).train()
    x, _, _, lengths, _ = _inputs(cuda, torch.float32)
    K.reset_launch_counts()
    y = model(x.transpose(0, 1), lengths, generator=gen)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert y.shape == (B, T, 7) and torch.isfinite(y).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert dict(K.launch_counts) == {"sru_proj_gemm": 4, "sru_fwd_scan": 4,
                                     "sru_bwd_scan": 4, "lstm_fwd_scan": 0,
                                     "lstm_bwd_scan": 0,
                                     "linear_recurrence_fwd": 0,
                                     "linear_recurrence_bwd": 0}


@pytest.mark.parametrize("K_, N_", [(425, 2048), (70, 180), (64, 192),
                                    (432, 4096), (1024, 4096), (1024, 2048)])
@pytest.mark.parametrize("M", [T * B, 10240 + 37])
def test_proj_gemm_pads_what_its_loads_cannot_take(cuda, K_, N_, M):
    """bf16 GEMM: a K that is not a multiple of 8 or an x that is not
    16-byte aligned (a view one element in) makes the wrapper copy x into
    rows 8-aligned apart, an N that is not a multiple of 8 makes it pad w;
    u keeps its (M, N) shape.  Neither M
    fills its last 128-row tile; the larger gives each of the persistent
    blocks several tiles, at the paths' widths (N = 4H, and 8H for both
    LSTM directions; K = 432, the first layer's 425 padded, and 2H)."""
    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(M, K_ + 1), dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rs.randn(K_, N_) * 0.1, dtype=torch.bfloat16,
                     device=cuda)
    for x2 in (x[:, :K_].contiguous(), x.reshape(-1)[1:M * K_ + 1]
               .view(M, K_)):
        u = K.sru_proj_gemm(x2, w)
        assert u.shape == (M, N_) and u.is_contiguous()
        assert _rel(u, K.sru_proj_gemm_plain(x2, w)) < TOL[torch.bfloat16]


def _f32_operands(dev, M, K_, N_, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x2 = torch.randn((M, K_), generator=gen, device=dev)
    w = (torch.rand((K_, N_), generator=gen, device=dev) * 2 - 1) / 512 ** .5
    return x2, w


@pytest.mark.parametrize("N_", [5, 187, 2048, 4096])
@pytest.mark.parametrize("K_", [1, 3, 177, 425, 1024])
@pytest.mark.parametrize("M", [1, 63, 65, 608, 10240])
def test_f32_gemm_at_edge_shapes(cuda, M, K_, N_):
    """f32 GEMM: one launch of the kernel (64- or 128-row tiles, split K
    where the plan says) for any M, K and N: ragged M against both tile
    heights, K under one 16-step stage or not a multiple of 4 (x read as it
    lies, 4 bytes a copy), N not a multiple of 4 (w padded, u sliced
    back)."""
    x2, w = _f32_operands(cuda, M, K_, N_, M * 7 + K_ * 3 + N_)
    K.reset_launch_counts()
    u = K.sru_proj_gemm(x2, w)
    torch.cuda.synchronize()
    assert K.launch_counts["sru_proj_gemm"] == 1
    assert u.shape == (M, N_) and u.is_contiguous()
    assert torch.isfinite(u).all()
    assert _rel(u, K.sru_proj_gemm_plain(x2, w)) < TOL[torch.float32]


@pytest.mark.parametrize("M,K_", [(608, 1024), (65, 425), (10240, 177)])
def test_f32_gemm_takes_a_misaligned_view(cuda, M, K_):
    """An x that starts one element into its storage is read as it lies
    (the f32 kernel copies x 4 bytes at a time)."""
    x2, w = _f32_operands(cuda, M, K_ + 1, 2048, M)
    x2 = x2.reshape(-1)[1:M * K_ + 1].view(M, K_)
    w = w[:K_].contiguous()
    assert x2.data_ptr() % 16
    assert _rel(K.sru_proj_gemm(x2, w),
                K.sru_proj_gemm_plain(x2, w)) < TOL[torch.float32]


@pytest.mark.parametrize("M,K_,N_", [(64, 1024, 2048), (608, 425, 2048),
                                     (480, 177, 2048), (1, 1024, 4096)])
def test_f32_gemm_split_k_is_bit_identical(cuda, M, K_, N_):
    """At shapes the plan splits over K, two launches give the same bits:
    the splits' partial tiles are added in a fixed order."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert K._f32_gemm_plan(M, N_, K_, sms).splits > 1
    x2, w = _f32_operands(cuda, M, K_, N_, 11)
    u1 = K.sru_proj_gemm(x2, w)
    u2 = K.sru_proj_gemm(x2, w)
    assert torch.equal(u1, u2)
    assert _rel(u1, K.sru_proj_gemm_plain(x2, w)) < TOL[torch.float32]


def _bwd_inputs(dev, dt, Tn, Bn, Hn, seed=6):
    """u, bias4, c (from the plain forward) and gh; lengths [1, T, then
    values that end inside a 4-step run and a 64-step window]."""
    rs = np.random.RandomState(seed)
    u = torch.tensor(rs.randn(Tn, Bn, 4 * Hn), dtype=dt, device=dev)
    bias4 = torch.tensor(np.r_[np.zeros(Hn), rs.randn(2 * Hn) * 0.1,
                               np.zeros(Hn)], dtype=torch.float32, device=dev)
    lengths = np.minimum(np.r_[1, Tn, rs.randint(1, Tn + 1, Bn)[:Bn - 2]],
                         Tn)[:Bn]
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gh = torch.tensor(rs.randn(Tn, Bn, Hn), dtype=dt, device=dev)
    return u, bias4, lengths, gh


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
@pytest.mark.parametrize("Tn,Bn,Hn", [(1, 3, 48), (3, 4, 50), (69, 3, 9),
                                      (130, 2, 50), (200, 5, 48)])
def test_bwd_scan_across_runs_and_windows(cuda, dt, reverse, use_relu, Tn,
                                          Bn, Hn):
    """The time-chunked backward scan against its plain version: T of one
    step, shorter than one 4-step run, not a multiple of the run or of the
    64-step window, and spanning several windows; lengths of 1 and ending
    inside a run; H odd (one lane a thread), and even but not a multiple of
    a block's 16 lanes; B of 2 to 5 partial bias gradients to join."""
    u, bias4, lengths, gh = _bwd_inputs(cuda, dt, Tn, Bn, Hn)
    _, c = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu)
    K.reset_launch_counts()
    du_k, db_k = K.sru_bwd_scan(u, bias4, lengths, c, gh, reverse, use_relu)
    du_p, db_p = K.sru_bwd_scan_plain(u, bias4, lengths, c, gh, reverse,
                                      use_relu)
    torch.cuda.synchronize()
    assert du_k.dtype == dt and du_k.shape == (Tn, Bn, 4 * Hn)
    assert db_k.dtype == torch.float32 and db_k.shape == (4 * Hn,)
    assert _rel(du_k, du_p) < TOL[dt] and _rel(db_k, db_p) < 1e-4
    assert (db_k[:Hn] == 0).all() and (db_k[3 * Hn:] == 0).all()
    pad = torch.arange(Tn, device=cuda)[:, None] >= lengths[None, :]
    assert (du_k[pad] == 0).all()
    assert K.launch_counts["sru_bwd_scan"] == 1


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
@pytest.mark.parametrize("Tn,Bn,Hn", [(1, 3, 48), (3, 4, 50), (69, 3, 9),
                                      (130, 2, 50), (200, 5, 48)])
def test_fwd_scan_across_runs_and_windows(cuda, dt, reverse, use_relu, Tn,
                                          Bn, Hn):
    """The time-chunked forward scan against its plain version, at the
    backward's shapes: T of one step, shorter than a 4-step run, not a
    multiple of the run or of the 64-step window, and several windows;
    lengths of 1 and T; H odd (one lane a thread) and even but not a
    multiple of a block's 16 lanes.  Padded frames: h = 0, and c the
    plain version's carried value (the last valid c going forward, 0 going
    backward, before the first valid frame)."""
    u, bias4, lengths, _ = _bwd_inputs(cuda, dt, Tn, Bn, Hn)
    K.reset_launch_counts()
    h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, use_relu)
    h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu)
    torch.cuda.synchronize()
    assert h_k.dtype == dt and h_k.shape == (Tn, Bn, Hn)
    assert c_k.dtype == torch.float32 and c_k.shape == (Tn, Bn, Hn)
    assert _rel(h_k, h_p) < TOL[dt] and _rel(c_k, c_p) < 1e-4
    pad = torch.arange(Tn, device=cuda)[:, None] >= lengths[None, :]
    assert (h_k[pad] == 0).all()
    if pad.any():
        assert _rel(c_k[pad], c_p[pad]) < 1e-4
    if reverse:
        assert (c_k[pad] == 0).all()
    assert K.launch_counts["sru_fwd_scan"] == 1


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_scan_at_the_step_shape(cuda, dt, reverse):
    """T=512, B=20, H=512, as the training step calls it."""
    u, bias4, lengths, _ = _bwd_inputs(cuda, dt, 512, 20, 512)
    h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, 1)
    h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, 1)
    torch.cuda.synchronize()
    assert _rel(h_k, h_p) < TOL[dt] and _rel(c_k, c_p) < 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_scan_at_the_step_shape(cuda, dt, reverse):
    """T=512 (eight 64-step windows), B=20, H=512, as the training step
    calls it; and the same inputs again, so that a second launch finds the
    kernel's bias-gradient tickets as the first left them."""
    u, bias4, lengths, gh = _bwd_inputs(cuda, dt, 512, 20, 512)
    _, c = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, 1)
    du_p, db_p = K.sru_bwd_scan_plain(u, bias4, lengths, c, gh, reverse, 1)
    for _ in range(2):
        du_k, db_k = K.sru_bwd_scan(u, bias4, lengths, c, gh, reverse, 1)
        torch.cuda.synchronize()
        assert _rel(du_k, du_p) < TOL[dt] and _rel(db_k, db_p) < 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Tn", [32, 64])
def test_sru_kernels_at_the_duration_step_shapes(cuda, dt, reverse, Tn):
    """The tts_duration step's shapes: B=32 utterances padded to T=32 or 64
    (half of one 64-step window, or one), H=512, and the first layer's
    K=416 phone features (a multiple of 8, so the bf16 GEMM reads x as it
    lies) beside the later layers' K=1024.  The GEMM, both scans and the
    backward's per-b bias-gradient join over 32 rows, the backward launched
    twice."""
    Bn, Hn = 32, 512
    rs = np.random.RandomState(Tn)
    for Kd in (416, 1024):
        x2 = torch.tensor(rs.randn(Tn * Bn, Kd), dtype=dt, device=cuda)
        w = torch.tensor(rs.randn(Kd, 4 * Hn) * 0.05, dtype=dt, device=cuda)
        u = K.sru_proj_gemm(x2, w)
        assert u.shape == (Tn * Bn, 4 * Hn)
        assert _rel(u, K.sru_proj_gemm_plain(x2, w)) < TOL[dt]
    u, bias4, lengths, gh = _bwd_inputs(cuda, dt, Tn, Bn, Hn)
    h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, 1)
    h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, 1)
    assert _rel(h_k, h_p) < TOL[dt] and _rel(c_k, c_p) < 1e-4
    du_p, db_p = K.sru_bwd_scan_plain(u, bias4, lengths, c_p, gh, reverse, 1)
    for _ in range(2):
        du_k, db_k = K.sru_bwd_scan(u, bias4, lengths, c_p, gh, reverse, 1)
        torch.cuda.synchronize()
        assert _rel(du_k, du_p) < TOL[dt] and _rel(db_k, db_p) < 1e-4


# ---------------------------------------------------------------------------
# LSTM kernels.  Shapes as tests/test_kernels.py's: T=21, B=3, H=9 with
# lengths [21, 13, 5] (one block per hidden unit, H not a multiple of
# anything), and the step's H=512 (the forward and the f32 backward: 64
# cooperative blocks per direction, 8 units each; the bf16 backward: one
# cluster of 16 blocks per direction, 32 units each).
# Limits as above; c is f32, but in bf16 I/O it is fed by the bf16-rounded h
# of earlier steps, so it is held to the bf16 limit there.
# ---------------------------------------------------------------------------

LSTM_CASES = [(False, True), (False,), (True,)]


def _lstm_inputs(dev, dt, ndir, Tn, Bn, Hn, seed=0):
    rs = np.random.RandomState(seed)
    bound = 1.0 / Hn ** 0.5
    xp = torch.tensor(rs.randn(Tn, Bn, ndir * 4 * Hn) * 0.5, dtype=dt,
                      device=dev)
    whh = torch.tensor(rs.uniform(-bound, bound, (ndir, Hn, 4 * Hn)),
                       dtype=dt, device=dev)
    bias = torch.tensor(rs.uniform(-bound, bound, (ndir, 4 * Hn)),
                        dtype=torch.float32, device=dev)
    lengths = (torch.tensor([21, 13, 5], dtype=torch.int32, device=dev)
               if Bn == 3 else torch.tensor(
                   np.r_[rs.randint(Tn // 2, Tn, Bn - 1), Tn],
                   dtype=torch.int32, device=dev))
    gy = torch.tensor(rs.randn(Tn, Bn, ndir * Hn), dtype=dt, device=dev)
    return xp, whh, bias, lengths, gy


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", LSTM_CASES)
@pytest.mark.parametrize("Tn,Bn,Hn", [(21, 3, 9), (64, 20, 512)])
def test_lstm_kernels_match_plain_versions(cuda, dt, reverse, Tn, Bn, Hn):
    from gantts_tpu_torch.kernels import lstm_scan as L

    xp, whh, bias, lengths, gy = _lstm_inputs(cuda, dt, len(reverse), Tn, Bn,
                                              Hn)
    tol = TOL[dt]
    L.reset_launch_counts()
    y_k, c_k, g4_k = L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
    y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    assert y_k.dtype == dt and g4_k.dtype == dt and c_k.dtype == torch.float32
    assert _rel(y_k, y_p) < tol and _rel(g4_k, g4_p) < tol
    assert _rel(c_k, c_p) < (1e-4 if dt == torch.float32 else tol)
    pad = (torch.arange(Tn, device=cuda)[:, None] >= lengths[None, :])
    assert (y_k[pad] == 0).all()
    dxp_k, db_k = L.lstm_bwd_scan(whh, lengths, c_p, g4_p, gy, reverse)
    dxp_p, db_p = L.lstm_bwd_scan_plain(whh, lengths, c_p, g4_p, gy, reverse)
    assert _rel(dxp_k, dxp_p) < tol and _rel(db_k, db_p) < 1e-3
    assert (dxp_k[pad] == 0).all()
    torch.cuda.synchronize()
    assert L.launch_counts["lstm_fwd_scan"] == 1
    assert L.launch_counts["lstm_bwd_scan"] == 1


def _traced(fn, tries=5):
    """fn()'s result and the names of the device kernels it ran, from
    torch.profiler.  A session that recorded no device event at all says
    nothing (on an H100 the profiler has been seen to drop whole sessions
    while the kernels ran), so fn is traced again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        if names:
            break
    return out, names


def _lstm_bwd_case(dev, dt, reverse, Tn, Bn, Hn):
    """whh, lengths, c, g4 and gy for the backward, c and g4 from the
    forward kernel."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    xp, whh, bias, lengths, gy = _lstm_inputs(dev, dt, len(reverse), Tn, Bn,
                                              Hn)
    _, c, g4 = L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
    return whh, lengths, c, g4, gy


@pytest.mark.parametrize("reverse", LSTM_CASES)
@pytest.mark.parametrize("Tn,Bn,Hn", [(64, 20, 512), (64, 1, 512),
                                      (64, 20, 256)])
def test_lstm_bwd_cluster_kernel(cuda, reverse, Tn, Bn, Hn):
    """The thread-block-cluster backward (bf16, H of 256 or 512, B up to
    24: 16 blocks a direction, of 32 or 16 units) against its plain
    version, one and two directions; then the same inputs again, which
    must give the same bits: the partial products are summed in a fixed
    order, and nothing the first launch leaves behind reaches the
    second."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    args = _lstm_bwd_case(cuda, torch.bfloat16, reverse, Tn, Bn, Hn)
    (dxp_k, db_k), names = _traced(lambda: L.lstm_bwd_scan(*args, reverse))
    assert any("lstm_bwd_cluster_kernel" in n for n in names), names
    dxp_p, db_p = L.lstm_bwd_scan_plain(*args, reverse)
    dxp_2, db_2 = L.lstm_bwd_scan(*args, reverse)
    torch.cuda.synchronize()
    assert _rel(dxp_k, dxp_p) < TOL[torch.bfloat16]
    assert _rel(db_k, db_p) < 1e-3
    lengths = args[1]
    pad = torch.arange(Tn, device=cuda)[:, None] >= lengths[None, :]
    assert (dxp_k[pad] == 0).all()
    assert torch.equal(dxp_2, dxp_k) and torch.equal(db_2, db_k)


@pytest.mark.parametrize("dt,Bn,Hn", [(torch.float32, 20, 64),
                                      (torch.bfloat16, 3, 9),
                                      (torch.bfloat16, 25, 256)])
def test_lstm_bwd_takes_the_cooperative_kernel_by_shape(cuda, dt, Bn, Hn):
    """An f32 H too small for the flag design (phase 5's 64), an H the
    cluster layout does not divide, and a B above its 24 rows take the
    cooperative kernel, and it still agrees."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    reverse = (False, True)
    Tn = 21 if Bn == 3 else 40
    args = _lstm_bwd_case(cuda, dt, reverse, Tn, Bn, Hn)
    assert L.bwd_design(Bn, Hn, dt) == "cooperative"
    (dxp_k, db_k), names = _traced(lambda: L.lstm_bwd_scan(*args, reverse))
    assert any("lstm_bwd_kernel" in n for n in names), names
    assert not any("lstm_bwd_cluster_kernel" in n for n in names)
    dxp_p, db_p = L.lstm_bwd_scan_plain(*args, reverse)
    torch.cuda.synchronize()
    assert _rel(dxp_k, dxp_p) < TOL[dt] and _rel(db_k, db_p) < 1e-3


def test_lstm_bwd_step_shape_takes_the_cluster_kernel(cuda):
    """The training steps' bf16 shape (B=20, H=512) takes the cluster
    kernel (f32 the flag design), and two of its 16-block clusters (one per
    direction) fit on the card at once."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    assert L.bwd_design(20, 512, torch.bfloat16) == "cluster"
    assert L.bwd_design(20, 512, torch.float32) == "flag"
    assert L.bwd_cluster_occupancy(512) >= 2
    assert L.bwd_cluster_occupancy(256) >= 2


@pytest.mark.parametrize("reverse", LSTM_CASES)
@pytest.mark.parametrize("Tn,Bn,Hn", [(64, 20, 512), (64, 1, 512),
                                      (64, 20, 256)])
def test_lstm_fwd_cluster_kernel(cuda, reverse, Tn, Bn, Hn):
    """The thread-block-cluster forward (bf16, H of 256 or 512, B up to 24:
    16 blocks a direction, of 32 or 16 units) against its plain version,
    one and two directions: y and g4 within one bf16 rounding, c (f32, fed
    by the bf16-rounded h of earlier steps) within 2e-3 of scale, y exactly
    0 on padding; then the same inputs again, which must give the same
    bits: the splits' partial sums are added in a fixed order."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    xp, whh, bias, lengths, _ = _lstm_inputs(cuda, torch.bfloat16,
                                             len(reverse), Tn, Bn, Hn)
    (y_k, c_k, g4_k), names = _traced(
        lambda: L.lstm_fwd_scan(xp, whh, bias, lengths, reverse))
    assert any("lstm_fwd_cluster_kernel" in n for n in names), names
    y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    y_2, c_2, g4_2 = L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
    torch.cuda.synchronize()
    assert _rel(y_k, y_p) < TOL[torch.bfloat16]
    assert _rel(g4_k, g4_p) < TOL[torch.bfloat16]
    assert _rel(c_k, c_p) < 2e-3
    pad = torch.arange(Tn, device=cuda)[:, None] >= lengths[None, :]
    assert (y_k[pad] == 0).all()
    assert torch.equal(y_2, y_k) and torch.equal(c_2, c_k)
    assert torch.equal(g4_2, g4_k)


@pytest.mark.parametrize("dt,Bn,Hn", [(torch.float32, 20, 64),
                                      (torch.bfloat16, 3, 9),
                                      (torch.bfloat16, 25, 256)])
def test_lstm_fwd_takes_the_cooperative_kernel_by_shape(cuda, dt, Bn, Hn):
    """An f32 H too small for the flag design (phase 5's 64), an H the
    cluster layout does not divide, and a B above its 24 rows take the
    cooperative forward, and it still agrees."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    reverse = (False, True)
    Tn = 21 if Bn == 3 else 40
    xp, whh, bias, lengths, _ = _lstm_inputs(cuda, dt, 2, Tn, Bn, Hn)
    assert L.fwd_design(Bn, Hn, dt) == "cooperative"
    (y_k, c_k, g4_k), names = _traced(
        lambda: L.lstm_fwd_scan(xp, whh, bias, lengths, reverse))
    assert any("lstm_fwd_kernel" in n for n in names), names
    assert not any("lstm_fwd_cluster_kernel" in n for n in names)
    y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    torch.cuda.synchronize()
    assert _rel(y_k, y_p) < TOL[dt] and _rel(g4_k, g4_p) < TOL[dt]
    assert _rel(c_k, c_p) < (1e-4 if dt == torch.float32 else TOL[dt])


def test_lstm_fwd_step_shape_takes_the_cluster_kernel(cuda):
    """The training steps' bf16 shape (B=20, H=512) takes the forward's
    cluster kernel too (f32 the flag design), and two of its 16-block
    clusters (one per direction) fit on the card at once."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    assert L.fwd_design(20, 512, torch.bfloat16) == "cluster"
    assert L.fwd_design(20, 512, torch.float32) == "flag"
    assert L.fwd_cluster_occupancy(512) >= 2
    assert L.fwd_cluster_occupancy(256) >= 2


# The f32 flag design (H / U blocks a direction, per-block step flags):
# limits of chip_smoke.py phase 3, 1e-5 of scale for every output.
FLAG_TOL = 1e-5
FLAG_LENGTHS = {1: [37], 3: [64, 0, 17],
                20: [64, 0, 33, 0, 0, 5, 64, 12, 1, 0, 50, 64, 2, 0, 40, 7,
                     0, 63, 28, 0]}


def _flag_case(dev, reverse, Bn, Tn=64, Hn=512):
    """Inputs at Tn x Bn x Hn with FLAG_LENGTHS' rows (zero-length rows
    among them), and c, g4 from the plain forward."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    xp, whh, bias, _, gy = _lstm_inputs(dev, torch.float32, len(reverse),
                                        Tn, Bn, Hn, seed=Bn)
    lengths = torch.tensor(FLAG_LENGTHS[Bn], dtype=torch.int32, device=dev)
    return xp, whh, bias, lengths, gy


@pytest.mark.parametrize("reverse", LSTM_CASES)
@pytest.mark.parametrize("Bn", [1, 3, 20])
def test_lstm_flag_kernels(cuda, reverse, Bn):
    """The f32 flag design at T=64, H=512 (one direction: 128 blocks of 4
    units; two: 64 a direction of 8), B of 1, 3 and 20 with zero-length
    rows, against the plain versions; padded frames exactly 0; the trace
    names both flag kernels; the same inputs again give the same bits (the
    partial sums are added in a fixed order)."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    xp, whh, bias, lengths, gy = _flag_case(cuda, reverse, Bn)
    nd = len(reverse)
    assert L.fwd_design(Bn, 512, torch.float32, nd) == "flag"
    assert L.bwd_design(Bn, 512, torch.float32, nd) == "flag"
    y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    dxp_p, db_p = L.lstm_bwd_scan_plain(whh, lengths, c_p, g4_p, gy, reverse)

    def both():
        return (L.lstm_fwd_scan(xp, whh, bias, lengths, reverse),
                L.lstm_bwd_scan(whh, lengths, c_p, g4_p, gy, reverse))
    ((y_k, c_k, g4_k), (dxp_k, db_k)), names = _traced(both)
    assert any("lstm_fwd_flag_kernel" in n for n in names), names
    assert any("lstm_bwd_flag_kernel" in n for n in names), names
    (y_2, c_2, g4_2), (dxp_2, db_2) = both()
    torch.cuda.synchronize()
    for got, ref in ((y_k, y_p), (c_k, c_p), (g4_k, g4_p), (dxp_k, dxp_p),
                     (db_k, db_p)):
        assert _rel(got, ref) <= FLAG_TOL
    pad = torch.arange(64, device=cuda)[:, None] >= lengths[None, :]
    assert (y_k[pad] == 0).all() and (dxp_k[pad] == 0).all()
    for a, b in ((y_2, y_k), (c_2, c_k), (g4_2, g4_k), (dxp_2, dxp_k),
                 (db_2, db_k)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Bn,Hn,nd", [(1, 512, 1), (20, 512, 1),
                                      (20, 512, 2), (24, 512, 2),
                                      (25, 512, 1), (20, 64, 1),
                                      (3, 9, 2), (20, 256, 2),
                                      (20, 1024, 1)])
def test_lstm_flag_plan_is_the_launchers(cuda, Bn, Hn, nd):
    """kernels/lstm_scan.py's ``_flag_plan`` on this card is the plan the
    launcher takes (its units a block), and the designs follow it: f32
    takes the flag design where there is a plan, the cooperative kernels
    where there is none, and the refused shapes still run there."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    f32 = torch.float32
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for i, way in enumerate(("fwd", "bwd")):
        plan = L._flag_plan(Bn, Hn, nd, f32, sms, way)
        assert L._lib().lstm_flag_units(Bn, Hn, nd, 0, i) == (
            plan.units if plan else 0)
        want = "flag" if plan else "cooperative"
        assert getattr(L, f"{way}_design")(Bn, Hn, f32, nd) == want
        assert (plan is not None) == ((Bn, Hn) in ((1, 512), (20, 512),
                                                   (24, 512), (20, 256)))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_layer_on_card_matches_cpu(cuda, bidirectional):
    """lstm_proj_layer forward and backward, f32: the card's kernels against
    the CPU's plain versions, every gradient."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    reverse = (False, True) if bidirectional else (True,)
    results = []
    for dev in (torch.device("cpu"), cuda):
        rs = np.random.RandomState(3)
        x = torch.tensor(rs.randn(21, 3, D), dtype=torch.float32, device=dev,
                         requires_grad=True)
        params = [{k: torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32,
                                   device=dev, requires_grad=True)
                   for k, s in (("w_ih", (D, 36)), ("w_hh", (9, 36)),
                                ("bias", (36,)))} for _ in reverse]
        lengths = torch.tensor([21, 13, 5], dtype=torch.int32)
        y = L.lstm_proj_layer(x, params, lengths, reverse)
        gy = torch.tensor(rs.randn(*y.shape), dtype=torch.float32, device=dev)
        y.backward(gy)
        results.append([y, x.grad] + [p[k].grad for p in params
                                      for k in ("w_ih", "w_hh", "bias")])
    for got, ref in zip(results[1], results[0]):
        assert _rel(got.cpu(), ref) < 1e-4


def test_lstmrnn_step_launches_every_kernel(cuda):
    """A 2-layer bidirectional LSTMRNN forward and backward on the card
    goes through the GEMM and each scan once per layer, both directions in
    one launch."""
    from gantts_tpu_torch.models import LSTMRNN

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = LSTMRNN(in_dim=D, out_dim=7, num_hidden=2, hidden_dim=H,
                    bidirectional=True, dropout=0.2,
                    compute_dtype="bfloat16", generator=gen,
                    device=cuda).train()
    x, _, _, lengths, _ = _inputs(cuda, torch.float32)
    K.reset_launch_counts()
    y = model(x.transpose(0, 1), lengths, generator=gen)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert y.shape == (B, T, 7) and torch.isfinite(y).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert dict(K.launch_counts) == {
        "sru_proj_gemm": 2, "sru_fwd_scan": 0, "sru_bwd_scan": 0,
        "lstm_fwd_scan": 2, "lstm_bwd_scan": 2, "linear_recurrence_fwd": 0,
        "linear_recurrence_bwd": 0}


def test_lstm_forward_matches_cudnn(cuda):
    """An extra oracle, f32: one bidirectional layer against torch.nn.LSTM
    over pack_padded_sequence (cuDNN), with the weights transposed and the
    two biases kept."""
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    from gantts_tpu_torch.kernels import lstm_scan as L

    rs = np.random.RandomState(4)
    Hn, Tn = 32, 40
    ref = torch.nn.LSTM(D, Hn, bidirectional=True).to(cuda)
    x = torch.tensor(rs.randn(Tn, B, D), dtype=torch.float32, device=cuda)
    lengths = torch.tensor(np.r_[rs.randint(5, Tn, B - 1), Tn],
                           dtype=torch.int32)
    params = []
    for sfx in ("", "_reverse"):
        g = {n: getattr(ref, f"{n}_l0{sfx}").detach()
             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        params.append(dict(w_ih=g["weight_ih"].t().contiguous(),
                           w_hh=g["weight_hh"].t().contiguous(),
                           bias=g["bias_ih"] + g["bias_hh"]))
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            y = L.lstm_proj_layer(x, params, lengths, (False, True))
            packed = pack_padded_sequence(x, lengths, enforce_sorted=False)
            y_ref, _ = pad_packed_sequence(ref(packed)[0], total_length=Tn)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    assert _rel(y, y_ref) < 1e-5


# ---------------------------------------------------------------------------
# The linear recurrence of the k=3 SRU layer.  The kernels round each product
# and sum on its own, as the plain version does, from carries composed across
# chunks (16 steps forward, 32 backward), so the two agree to rounding,
# exactly only in the chunk a traversal starts with.  The limit is 1e-6 of
# scale.  T=37 is not a multiple of either chunk and B*H=240 lanes do not
# fill a block; the second shape is the step's.
# ---------------------------------------------------------------------------


def _linear_inputs(dev, Tn, Bn, Hn, seed=0):
    rs = np.random.RandomState(seed)
    lengths = np.r_[rs.randint(1, Tn, Bn - 1), Tn]
    m = (np.arange(Tn)[:, None] < lengths[None, :])[..., None]
    f = np.where(m, 1 / (1 + np.exp(-rs.randn(Tn, Bn, Hn))), 1.0)
    b = np.where(m, rs.randn(Tn, Bn, Hn) * 0.5, 0.0)
    g = rs.randn(Tn, Bn, Hn)
    return [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (f, b, g)]


@pytest.mark.parametrize("Tn,Bn,Hn", [(T, B, H), (512, 20, 512)])
def test_linear_recurrence_kernels_match_plain_versions(cuda, Tn, Bn, Hn):
    L = linear_scan
    f, b, g = _linear_inputs(cuda, Tn, Bn, Hn)
    K.reset_launch_counts()
    c_k = L.linear_recurrence_fwd(f, b)
    c_p = L.linear_recurrence_fwd_plain(f, b)
    df_k, db_k = L.linear_recurrence_bwd(g, f, c_p)
    df_p, db_p = L.linear_recurrence_bwd_plain(g, f, c_p)
    torch.cuda.synchronize()
    for got, ref in ((c_k, c_p), (df_k, df_p), (db_k, db_p)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _rel(got, ref) <= 1e-6
    assert L.launch_counts["linear_recurrence_fwd"] == 1
    assert L.launch_counts["linear_recurrence_bwd"] == 1


@pytest.mark.parametrize("Tn", [1, 15, 16, 17, 31, 32, 33, 37, 130, 512])
@pytest.mark.parametrize("Bn,Hn", [(3, 9), (7, 300), (20, 512)])
def test_linear_recurrence_bwd_chunked(cuda, Tn, Bn, Hn):
    """The time-chunked backward against its plain version: T of one step,
    shorter than one 32-step chunk, one chunk and one step either side, and
    several chunks (the last partial); 27 lanes (blocks of 16 lanes, the
    last of 11; at T=512, 16 chunks a block), 2100 and the step's 10,240.
    The chunk that starts the traversal (t >= T - 32) has carry 0 and is
    exact; the rest is held to 1e-6 of scale."""
    L = linear_scan
    rs = np.random.RandomState(Tn)
    g, f, c = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rs.randn(Tn, Bn, Hn), 1 / (1 + np.exp(-rs.randn(Tn, Bn, Hn))),
        rs.randn(Tn, Bn, Hn)))
    df_k, db_k = L.linear_recurrence_bwd(g, f, c)
    df_p, db_p = L.linear_recurrence_bwd_plain(g, f, c)
    torch.cuda.synchronize()
    assert _rel(db_k, db_p) <= 1e-6 and _rel(df_k, df_p) <= 1e-6
    top = slice(max(0, Tn - 32), Tn)
    assert torch.equal(db_k[top], db_p[top])
    assert torch.equal(df_k[top], df_p[top])


@pytest.mark.parametrize("Tn,Bn,Hn", [
    (Tn, Bn, Hn)
    for Tn in (1, 15, 16, 17, 31, 32, 33, 69, 255, 256, 257, 512)
    for Bn, Hn in ((3, 9), (7, 300), (20, 512))]
    + [(9000, 3, 9), (1100, 2, 300)])
def test_linear_recurrence_fwd_chunked(cuda, Tn, Bn, Hn):
    """The time-chunked forward against its plain version: T of one step,
    one and two 16-step chunks and one step either side, a partial last
    chunk, one 256-step window (16 chunks) and one step either side, and
    the step's 512 (two windows); 27 lanes (a block of 32 lanes, part
    empty), 2100 and the step's 10,240.  T=9000 and 1100 take many windows
    (past the backward's MAX_BWD_STEPS, both ending in a partial window),
    the lane's c carried from one to the next.  The first chunk (carry 0)
    is exact."""
    L = linear_scan
    f, b, _ = (a[:Tn] for a in _linear_inputs(cuda, max(Tn, 2), Bn, Hn,
                                               seed=Tn))
    K.reset_launch_counts()
    c_k = L.linear_recurrence_fwd(f, b)
    c_p = L.linear_recurrence_fwd_plain(f, b)
    torch.cuda.synchronize()
    assert c_k.shape == (Tn, Bn, Hn) and c_k.dtype == torch.float32
    assert _rel(c_k, c_p) <= 1e-6
    assert torch.equal(c_k[:16], c_p[:16])
    assert L.launch_counts["linear_recurrence_fwd"] == 1


def test_linear_recurrence_fwd_identity_and_repeat(cuda):
    """f = 1 everywhere (every chunk's product is 1, the carries a running
    sum), and lanes of length 1 whose padding (f = 1, b = 0) must hold the
    first c exactly; two launches on the same inputs give the same bits."""
    L = linear_scan
    rs = np.random.RandomState(4)
    Tn, Bn, Hn = 300, 4, 40
    b = torch.tensor(rs.randn(Tn, Bn, Hn), dtype=torch.float32, device=cuda)
    ones = torch.ones_like(b)
    c_k = L.linear_recurrence_fwd(ones, b)
    assert _rel(c_k, L.linear_recurrence_fwd_plain(ones, b)) <= 1e-6
    f, b, _ = _linear_inputs(cuda, Tn, Bn, Hn, seed=4)
    valid = torch.ones(Tn, Bn, 1, device=cuda)
    valid[1:, :2] = 0  # lanes of batch rows 0 and 1 have length 1
    f, b = f * valid + (1 - valid), b * valid
    c1 = L.linear_recurrence_fwd(f, b)
    c2 = L.linear_recurrence_fwd(f, b)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)
    assert _rel(c1, L.linear_recurrence_fwd_plain(f, b)) <= 1e-6
    assert torch.equal(c1[:, :2], c1[:1, :2].expand(Tn, 2, Hn))
    assert torch.equal(c1[0, :2], b[0, :2])


def test_linear_recurrence_refuses_what_it_does_not_take(cuda):
    L = linear_scan
    f, b, g = _linear_inputs(cuda, T, B, H)
    for args in ((f.double(), b.double()), (f, b.cpu()),
                 (f.transpose(1, 2), b.transpose(1, 2)), (f, b[:, :, :-1]),
                 (f[:0], b[:0])):
        with pytest.raises(ValueError):
            L.linear_recurrence_fwd(*args)
    with pytest.raises(ValueError):
        L.linear_recurrence_bwd(g.bfloat16(), f, f)
    long = torch.zeros((L.MAX_BWD_STEPS + 1, 1, 4), device=cuda)
    with pytest.raises(ValueError):
        L.linear_recurrence_bwd(long, long, long)


@pytest.mark.parametrize("reverse", [False, True])
def test_k3_layer_on_card_matches_cpu(cuda, reverse):
    """The k=3 SRULayer forward and backward, f32: the card (cuBLAS without
    TF32, the linear-recurrence kernels) against the CPU's plain versions,
    every gradient, to 1e-4 of scale as the other layers."""
    from gantts_tpu_torch.models.sru import SRULayer

    results = []
    for dev in (torch.device("cpu"), cuda):
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        layer = SRULayer(H, H, use_relu=1, reverse=reverse, generator=gen,
                         device=dev)
        x, _, _, lengths, gh = _inputs(dev, torch.float32, seed=5, D=H)
        if dev.type == "cpu":
            state = {k: v.clone() for k, v in layer.state_dict().items()}
        else:
            layer.load_state_dict(state)
        x.requires_grad_(True)
        h = layer(x, lengths)
        h.backward(gh)
        results.append([h, x.grad] + [p.grad for p in layer.parameters()])
    for got, ref in zip(results[1], results[0]):
        assert _rel(got.cpu(), ref) < 1e-4


def test_unidirectional_srurnn_launches_every_kernel(cuda):
    """A 3-layer unidirectional SRURNN forward and backward on the card:
    layer 0 through the SRU kernels, layers 1-2 (k=3) through the
    linear-recurrence kernels, once per layer each way."""
    from gantts_tpu_torch.models import SRURNN

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = SRURNN(in_dim=D, out_dim=7, num_hidden=3, hidden_dim=H,
                   bidirectional=False, use_relu=1, rnn_dropout=0.2,
                   dropout=0.2, compute_dtype="bfloat16", generator=gen,
                   device=cuda).train()
    x, _, _, lengths, _ = _inputs(cuda, torch.float32)
    K.reset_launch_counts()
    y = model(x.transpose(0, 1), lengths, generator=gen)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert y.shape == (B, T, 7) and torch.isfinite(y).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert dict(K.launch_counts) == {
        "sru_proj_gemm": 1, "sru_fwd_scan": 1, "sru_bwd_scan": 1,
        "lstm_fwd_scan": 0, "lstm_bwd_scan": 0, "linear_recurrence_fwd": 2,
        "linear_recurrence_bwd": 2}


# ---------------------------------------------------------------------------
# The voice-conversion path: In2OutRNNHighwayNet runs a unidirectional 3x512
# LSTM on 177 inputs (59 mel-cepstra with deltas) at B=20, one direction a
# launch, and synthesis applies the stencil MLPG at any length.
# ---------------------------------------------------------------------------

VC_DIM, VC_STATIC = 177, 59


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [(False,), (True,)])
def test_one_direction_lstm_kernels_at_the_vc_shapes(cuda, dt, reverse):
    """K = 177 (the wrapper copies bf16 x into rows 184 wide), B = 20,
    H = 512, one direction: the GEMM and both scans against their plain
    versions, the scans fed the kernel GEMM's own xp; bf16 takes the
    cluster kernels, f32 the flag design."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    Tn, Bn, Hn = 96, 20, 512
    rs = np.random.RandomState(8)
    bound = 1.0 / Hn ** 0.5
    x2 = torch.tensor(rs.randn(Tn * Bn, VC_DIM), dtype=dt, device=cuda)
    w_ih = torch.tensor(rs.uniform(-bound, bound, (VC_DIM, 4 * Hn)),
                        dtype=dt, device=cuda)
    _, whh, bias, lengths, gy = _lstm_inputs(cuda, dt, 1, Tn, Bn, Hn)
    assert L.fwd_design(Bn, Hn, dt) == L.bwd_design(Bn, Hn, dt) == (
        "cluster" if dt == torch.bfloat16 else "flag")
    L.reset_launch_counts()
    xp = L.sru_proj_gemm(x2, w_ih)
    assert _rel(xp, K.sru_proj_gemm_plain(x2, w_ih)) < TOL[dt]
    xp = xp.reshape(Tn, Bn, 4 * Hn)
    y_k, c_k, g4_k = L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
    y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    assert _rel(y_k, y_p) < TOL[dt] and _rel(g4_k, g4_p) < TOL[dt]
    assert _rel(c_k, c_p) < (1e-4 if dt == torch.float32 else 2e-3)
    dxp_k, db_k = L.lstm_bwd_scan(whh, lengths, c_p, g4_p, gy, reverse)
    dxp_p, db_p = L.lstm_bwd_scan_plain(whh, lengths, c_p, g4_p, gy, reverse)
    assert _rel(dxp_k, dxp_p) < TOL[dt] and _rel(db_k, db_p) < 1e-3
    torch.cuda.synchronize()
    assert (L.launch_counts["sru_proj_gemm"], L.launch_counts["lstm_fwd_scan"],
            L.launch_counts["lstm_bwd_scan"]) == (1, 1, 1)


def test_in2out_rnn_highway_net_on_card_matches_cpu(cuda):
    """The vc bundle's full-width In2OutRNNHighwayNet (177 -> 177, 3x512
    unidirectional LSTM, static 59), f32, dropout off: output and every
    gradient on the card against the CPU's plain versions, to 1e-4 of
    scale; 3 launches of the GEMM and of each scan."""
    from gantts_tpu_torch.core.windows import (
        DEFAULT_WINDOWS,
        unit_variance_mlpg_matrix,
    )
    from gantts_tpu_torch.models import In2OutRNNHighwayNet

    Tn, Bn = 64, 3
    rs = np.random.RandomState(9)
    x_np = rs.randn(Bn, Tn, VC_DIM).astype(np.float32)
    g_np = rs.randn(Bn, Tn, VC_STATIC).astype(np.float32)
    R_np = unit_variance_mlpg_matrix(DEFAULT_WINDOWS, Tn)
    results, state = [], None
    for dev in (torch.device("cpu"), cuda):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = In2OutRNNHighwayNet(
            in_dim=VC_DIM, out_dim=VC_DIM, static_dim=VC_STATIC,
            num_hidden=3, hidden_dim=512, dropout=0.0, generator=gen,
            device=dev)
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        x = torch.tensor(x_np, device=dev)
        lengths = torch.tensor([Tn, 40, 17], dtype=torch.int32, device=dev)
        K.reset_launch_counts()
        _, y = model(x, torch.tensor(R_np, device=dev), lengths)
        y.backward(torch.tensor(g_np, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = dict(K.launch_counts)
        results.append([y] + [p.grad for p in model.parameters()])
    assert (counts["sru_proj_gemm"], counts["lstm_fwd_scan"],
            counts["lstm_bwd_scan"]) == (3, 3, 3)
    for got, ref in zip(results[1], results[0]):
        assert torch.isfinite(got).all()
        assert _rel(got.cpu(), ref) < 1e-4


@pytest.mark.parametrize("Tn", [98, 512, 4096])
def test_stencil_mlpg_on_card_matches_dense_r(cuda, Tn):
    """The stencil MLPG on the card (exact f32: TF32 off) against the dense
    R product at the same length, under 2e-5 absolute, as the CPU tests; and
    the length-general operator at ragged lengths, padding zero."""
    from gantts_tpu_torch.core.fast_mlpg import (
        MLPGStencil,
        unit_variance_mlpg_stencil,
    )
    from gantts_tpu_torch.core.paramgen import unit_variance_mlpg
    from gantts_tpu_torch.core.windows import (
        DEFAULT_WINDOWS,
        unit_variance_mlpg_matrix,
    )

    assert not torch.backends.cuda.matmul.allow_tf32
    rs = np.random.RandomState(Tn)
    means = torch.tensor(rs.randn(2, Tn, 3 * VC_STATIC), dtype=torch.float32,
                         device=cuda)
    R = torch.tensor(unit_variance_mlpg_matrix(DEFAULT_WINDOWS, Tn),
                     device=cuda)
    dense = unit_variance_mlpg(R, means)
    got = unit_variance_mlpg_stencil(means, DEFAULT_WINDOWS)
    assert float((got - dense).abs().max()) < 2e-5
    op = MLPGStencil.create(DEFAULT_WINDOWS, device=cuda)
    short = Tn - Tn // 3
    lengths = torch.tensor([Tn, short], dtype=torch.int32, device=cuda)
    masked = means.clone()
    masked[1, short:] = 0
    dyn = unit_variance_mlpg(op, masked, lengths)
    R_s = torch.tensor(unit_variance_mlpg_matrix(DEFAULT_WINDOWS, short),
                       device=cuda)
    ref_s = unit_variance_mlpg(R_s, masked[1, :short])
    assert float((dyn[0] - dense[0]).abs().max()) < 2e-5
    assert float((dyn[1, :short] - ref_s).abs().max()) < 2e-5
    assert (dyn[1, short:] == 0).all()


# TTS synthesis's shapes: one utterance (B=1) in the bundles' float32,
# padded to the bucket multiple of 32 with its true length, for the
# duration model (phones) and the acoustic model (frames), each layer width.
SYNTH_CASES = [(64, 57, 416), (64, 57, 1024), (608, 597, 425),
               (608, 597, 1024)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Tn,length,Dn", SYNTH_CASES)
def test_sru_forward_kernels_at_synthesis_shapes(cuda, Tn, length, Dn,
                                                 reverse):
    rs = np.random.RandomState(Dn)
    Hn = 512
    x2 = torch.tensor(rs.randn(Tn, Dn), dtype=torch.float32, device=cuda)
    w = torch.tensor(rs.uniform(-1, 1, (Dn, 4 * Hn)) / Hn ** 0.5,
                     dtype=torch.float32, device=cuda)
    bias4 = torch.tensor(np.r_[np.zeros(Hn), rs.randn(2 * Hn) * 0.1,
                               np.zeros(Hn)], dtype=torch.float32,
                         device=cuda)
    lengths = torch.tensor([length], dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    u_p = K.sru_proj_gemm_plain(x2, w)
    assert _rel(K.sru_proj_gemm(x2, w), u_p) < 1e-4
    u = u_p.reshape(Tn, 1, 4 * Hn)
    h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, 1)
    h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, 1)
    assert _rel(h_k, h_p) < 1e-4 and _rel(c_k, c_p) < 1e-4
    assert (h_k[length:] == 0).all()
    torch.cuda.synchronize()
    assert (K.launch_counts["sru_proj_gemm"],
            K.launch_counts["sru_fwd_scan"]) == (1, 1)


@pytest.mark.parametrize("bundle", ["tts_duration", "tts_acoustic"])
def test_tts_generator_forward_on_card_matches_cpu(cuda, bundle):
    """The bundle's full-width generator (6x512 bidirectional relu SRU,
    float32) through synthesis.model_forward on one utterance, on the card
    against a CPU copy: within 2e-5 of scale, 12 + 12 launches and no
    backward."""
    import copy

    from gantts_tpu_torch import hparams, synthesis
    from gantts_tpu_torch.models import create_model

    hp = getattr(hparams, bundle).copy()
    in_dim, out_dim, Tn = ((416, 5, 37) if bundle == "tts_duration"
                           else (425, 187, 450))
    hp.generator_params.update(in_dim=in_dim, out_dim=out_dim)
    torch.manual_seed(0)
    model = create_model(hp.generator, compute_dtype=hp.compute_dtype,
                         device="cpu", **hp.generator_params)
    x = np.random.RandomState(1).rand(Tn, in_dim).astype(np.float32)
    y_cpu = synthesis.model_forward(model, x, hp)
    model_card = copy.deepcopy(model).to(cuda)
    K.reset_launch_counts()
    y_card = synthesis.model_forward(model_card, x, hp)
    torch.cuda.synchronize()
    assert {k: K.launch_counts[k] for k in ("sru_proj_gemm", "sru_fwd_scan",
                                            "sru_bwd_scan")} == {
        "sru_proj_gemm": 12, "sru_fwd_scan": 12, "sru_bwd_scan": 0}
    assert y_card.shape == y_cpu.shape == (Tn, out_dim)
    assert np.abs(y_card - y_cpu).max() <= 2e-5 * np.abs(y_cpu).max()


@pytest.mark.parametrize("Tx,Ty", [(1, 7), (120, 97), (400, 520)])
def test_feature_engine_on_card_machine_matches_numpy(cuda, Tx, Ty):
    """The host engine's DTW and banded Cholesky solve, built by the port's
    loader on the card's machine, against their NumPy and scipy versions."""
    import scipy.linalg

    from gantts_tpu_torch.frontend import native
    from gantts_tpu_torch.preprocessing import alignment

    assert native.available(), native.engine()
    rs = np.random.RandomState(Tx)
    x = np.cumsum(rs.randn(Tx, 6), axis=0)
    y = np.cumsum(rs.randn(Ty, 6), axis=0)
    for got, ref in zip(native.dtw_path(x, y),
                        alignment._dtw_path_numpy(x, y)):
        np.testing.assert_array_equal(got, ref)
    b = 2
    ab = np.zeros((b + 1, Ty))
    ab[-1] = 4.0 + rs.rand(Ty)
    ab[:-1] = rs.uniform(-0.5, 0.5, size=(b, Ty))
    rhs = rs.randn(Ty, 3)
    ref = scipy.linalg.solveh_banded(ab, rhs, lower=False)
    got = native.banded_cholesky_solve(ab, rhs, bandwidth=b)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("generator", ["SRURNN", "In2OutRNNHighwayNet"])
def test_jax_format_file_loads_onto_card_as_pth(cuda, tmp_path, generator):
    """A JAX-format checkpoint (written by flax_msgpack.packb from the
    port's state, as the JAX package's save_checkpoint lays it out) loaded
    onto the card: the full-width float32 generator (tts_acoustic's 6x512
    SRU, the vc bundle's 3x512 LSTM) and its Adagrad state restore bit for
    bit as from the .pth, and its forward gives the same bits."""
    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.train import TrainState
    from gantts_tpu_torch.train import checkpoint as ckpt
    from gantts_tpu_torch.train.flax_msgpack import packb
    from gantts_tpu_torch.train.optim import create_optimizer

    hp = (hparams.tts_acoustic if generator == "SRURNN"
          else hparams.vc).copy()
    hp.generator = generator
    dims = (425, 187) if generator == "SRURNN" else (177, 177)
    hp.generator_params.update(in_dim=dims[0], out_dim=dims[1])

    def state():
        model = create_model(generator, compute_dtype="float32",
                             device=cuda, **hp.generator_params)
        return TrainState(model, create_optimizer(
            hp.optimizer_g, hp.optimizer_g_params, model.parameters()))
    torch.manual_seed(0)
    src = state()
    for p in src.model.parameters():
        p.grad = torch.randn_like(p) * 1e-2
    src.optimizer.step()
    payload = {"state_dict": {k: v.cpu() for k, v in
                              src.model.state_dict().items()},
               "optimizer": src.optimizer.state_dict(), "global_epoch": 4}
    pth = str(tmp_path / "g.pth")
    torch.save(payload, pth)
    jax_file = tmp_path / "g_jax.pth"
    jax_file.write_bytes(packb(ckpt.jax_payload(
        payload, hp.optimizer_g, hp.optimizer_g_params)))
    a, b = state(), state()
    assert ckpt.restore(a, pth) == ckpt.restore(b, str(jax_file)) == 4
    for k, v in a.model.state_dict().items():
        assert v.device == cuda and torch.equal(b.model.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sb["state"][i][k], v), (i, k)
    T = 300
    x = torch.tensor(np.random.RandomState(2).rand(2, T, dims[0]),
                     dtype=torch.float32, device=cuda)
    lengths = torch.tensor([T, T - 41], dtype=torch.int32, device=cuda)
    args = (x, lengths)
    if generator != "SRURNN":
        R = torch.tensor(unit_variance_mlpg_matrix(hp.windows, T),
                         device=cuda)
        args = (x, R, lengths)
    with torch.no_grad():
        ya, yb = (s.model.eval()(*args) for s in (a, b))
    ya, yb = (y if isinstance(y, tuple) else (y,) for y in (ya, yb))
    for u, v in zip(ya, yb):
        assert torch.isfinite(u).all() and torch.equal(u, v)


# ---- K training steps as one CUDA graph replay (train/graphs.py) -----------

GRAPH_K, GRAPH_B, GRAPH_T = 4, 4, 64


def _graph_hp(generator, dtype, **gp):
    """A small tts_acoustic configuration (30 -> 67 dims, stream sizes
    [60, 3, 1, 3]) with dropout on, so that the replay must draw the masks
    the eager steps draw."""
    from gantts_tpu_torch import hparams

    hp = hparams.tts_acoustic.copy()
    hp.compute_dtype = dtype
    hp.stream_sizes = [60, 3, 1, 3]
    hp.order = 20
    hp.generator = generator
    base = dict(in_dim=30, out_dim=67, num_hidden=2, hidden_dim=64,
                dropout=0.2)
    if generator == "SRURNN":
        base.update(rnn_dropout=0.2, bidirectional=True)
    else:
        base.update(bidirectional=True)
    hp.generator_params = dict(base, **gp)
    hp.discriminator_params = dict(hp.discriminator_params,
                                   in_dim=20 - 2 + 30, num_hidden=1,
                                   hidden_dim=16)
    return hp


# case -> (hparams, the LSTM design its steps take or None)
GRAPH_CASES = {
    "bidirectional SRU": lambda: (_graph_hp("SRURNN", "bfloat16"), None),
    "k=3 unidirectional SRU": lambda: (_graph_hp(
        "SRURNN", "bfloat16", num_hidden=3, bidirectional=False), None),
    "bf16 cluster LSTM": lambda: (_graph_hp(
        "LSTMRNN", "bfloat16", num_hidden=1, hidden_dim=256), "cluster"),
    "f32 flag LSTM": lambda: (_graph_hp(
        "LSTMRNN", "float32", num_hidden=1, hidden_dim=256), "flag"),
    "f32 cooperative LSTM": lambda: (_graph_hp(
        "LSTMRNN", "float32", num_hidden=1, hidden_dim=64), "cooperative"),
}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_is_eager(cuda, case):
    """1 + K steps eager against 1 eager step and one K-step dispatch
    (capture and replay) from the same states and batches: the same bits
    in every step's scalars, parameters, optimizer state and the dropout
    generator's state; the replay's launch counters read K x the eager
    step's."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp, design = GRAPH_CASES[case]()
    if design is not None:
        gp = hp.generator_params
        dt = torch.bfloat16 if hp.compute_dtype == "bfloat16" else \
            torch.float32
        for way in (lstm_scan.fwd_design, lstm_scan.bwd_design):
            assert way(GRAPH_B, gp["hidden_dim"], dt, 2) == design
    rs = np.random.RandomState(4)
    n = GRAPH_K + 1
    xs = torch.tensor(rs.rand(n, GRAPH_B, GRAPH_T, 30), dtype=torch.float32,
                      device=cuda)
    ys = torch.tensor(rs.randn(n, GRAPH_B, GRAPH_T, 67),
                      dtype=torch.float32, device=cuda)
    ls = torch.tensor(np.stack([np.r_[rs.randint(20, GRAPH_T, GRAPH_B - 1),
                                      GRAPH_T] for _ in range(n)]),
                      dtype=torch.int32, device=cuda)
    R = torch.tensor(unit_variance_mlpg_matrix(hp.windows, GRAPH_T),
                     device=cuda)
    adv_w = torch.tensor(0.8, device=cuda)
    y_mean = np.zeros(67, np.float32)
    y_mean[63] = 2.0
    runs = []
    for fused in (False, True):
        _, _, _, _, gstate, dstate = init_models_and_states(
            hp, seed=0, device=cuda)
        trainer = GanTrainer(StepConfig.from_hparams(
            hp, 1.0, 0.0, 1.0, True, True), y_mean,
            np.ones(67, np.float32), cuda)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(3)
        outs = []
        for i in range(1 if fused else n):
            K.reset_launch_counts()
            outs.append(trainer.step(gstate, dstate, xs[i], ys[i], ls[i], R,
                                     adv_w, gen)[2])
            per_step = dict(K.launch_counts)
        if fused:
            K.reset_launch_counts()
            got = trainer.multi_step(gstate, dstate, xs[1:], ys[1:], ls[1:],
                                     R, adv_w, gen)[2]
            replay = dict(K.launch_counts)
            outs += [{k: v[j] for k, v in got.items()}
                     for j in range(GRAPH_K)]
        torch.cuda.synchronize()
        runs.append((gstate, dstate, gen, outs, per_step))
    (g1, d1, gen1, o1, per_step), (g2, d2, gen2, o2, _) = runs
    assert any(per_step.values())
    assert replay == {k: GRAPH_K * v for k, v in per_step.items()}
    for a, b in zip(o1, o2):
        for k in a:
            assert torch.equal(a[k], b[k]) or (
                torch.isnan(a[k]) and torch.isnan(b[k])), k
    for sa, sb in ((g1, g2), (d1, d2)):
        for (name, p), q in zip(sa.model.named_parameters(),
                                sb.model.parameters()):
            assert torch.equal(p, q), name
        oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
        for i, st in oa["state"].items():
            for k, v in st.items():
                assert torch.equal(ob["state"][i][k], v), (i, k)
    assert torch.equal(gen1.get_state(), gen2.get_state())


def test_graph_replay_traced(cuda, tmp_path):
    """A replay inside a profiled phase of the loop is the span
    ``graphs.replay``: in the record on the loop's thread, and a host range
    of the trace that pairs with it (tracing.py)."""
    from gantts_tpu_torch import tracing
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.setup import init_models_and_states
    from torch.profiler import ProfilerActivity, profile

    hp, _ = GRAPH_CASES["bidirectional SRU"]()
    rs = np.random.RandomState(5)
    xs = torch.tensor(rs.rand(GRAPH_K, GRAPH_B, GRAPH_T, 30),
                      dtype=torch.float32, device=cuda)
    ys = torch.tensor(rs.randn(GRAPH_K, GRAPH_B, GRAPH_T, 67),
                      dtype=torch.float32, device=cuda)
    ls = torch.full((GRAPH_K, GRAPH_B), GRAPH_T, dtype=torch.int32,
                    device=cuda)
    R = torch.tensor(unit_variance_mlpg_matrix(hp.windows, GRAPH_T),
                     device=cuda)
    adv_w = torch.tensor(0.8, device=cuda)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=0,
                                                        device=cuda)
    trainer = GanTrainer(StepConfig.from_hparams(
        hp, 1.0, 0.0, 1.0, True, True), np.zeros(67, np.float32),
        np.ones(67, np.float32), cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    trainer.step(gstate, dstate, xs[0], ys[0], ls[0], R, adv_w, gen)
    trainer.multi_step(gstate, dstate, xs, ys, ls, R, adv_w, gen)  # capture
    record = tracing.Record()
    saved, tracing.RECORD = tracing.RECORD, record
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with tracing.phase("train"):
                trainer.multi_step(gstate, dstate, xs, ys, ls, R, adv_w, gen)
            torch.cuda.synchronize()
    finally:
        tracing.RECORD = saved
    replays = tracing.spans("graphs.replay", "train", record)
    assert len(replays) == 1 and replays[0].tid == record.loop_tid
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "graphs.replay"] == ["graphs.replay"]
    assert tracing.clock_offset(events, record)[2] == 1


def test_graph_replay_refuses_other_states(cuda):
    """A graph replays only with what it captured: other states, another
    generator or an optimizer state loaded since raise."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = _graph_hp("SRURNN", "bfloat16", num_hidden=1)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=0,
                                                        device=cuda)
    trainer = GanTrainer(StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True,
                                                 True), np.zeros(67),
                         np.ones(67), cuda)
    gen = torch.Generator(device=cuda)
    xs = torch.rand(2, GRAPH_B, GRAPH_T, 30, device=cuda)
    ys = torch.rand(2, GRAPH_B, GRAPH_T, 67, device=cuda)
    ls = torch.full((2, GRAPH_B), GRAPH_T, dtype=torch.int32, device=cuda)
    R = torch.tensor(unit_variance_mlpg_matrix(hp.windows, GRAPH_T),
                     device=cuda)
    trainer.step(gstate, dstate, xs[0], ys[0], ls[0], R, 1.0, gen)
    trainer.multi_step(gstate, dstate, xs, ys, ls, R, 1.0, gen)
    with pytest.raises(ValueError, match="generator it was captured"):
        trainer.multi_step(gstate, dstate, xs, ys, ls, R, 1.0,
                           torch.Generator(device=cuda))
    gstate.optimizer.load_state_dict(gstate.optimizer.state_dict())
    with pytest.raises(ValueError, match="loaded after"):
        trainer.multi_step(gstate, dstate, xs, ys, ls, R, 1.0, gen)



def _small_graph_run(cuda, hp, seed, inside=None):
    """A trainer of ``hp`` that took one eager step and one 2-step
    dispatch (a capture and a replay), ``inside()`` called before each
    step that the capture records; returns the trainer."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.setup import init_models_and_states

    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=seed,
                                                        device=cuda)
    trainer = GanTrainer(StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True,
                                                 True), np.zeros(67),
                         np.ones(67), cuda)
    if inside is not None:
        def step(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                inside()
            return type(trainer).step(trainer, *args, **kwargs)
        trainer.step = step
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    xs = torch.rand(2, GRAPH_B, GRAPH_T, 30, device=cuda)
    ys = torch.rand(2, GRAPH_B, GRAPH_T, 67, device=cuda)
    ls = torch.full((2, GRAPH_B), GRAPH_T, dtype=torch.int32, device=cuda)
    R = torch.tensor(unit_variance_mlpg_matrix(hp.windows, GRAPH_T),
                     device=cuda)
    trainer.step(gstate, dstate, xs[0], ys[0], ls[0], R, 1.0, gen)
    trainer.multi_step(gstate, dstate, xs, ys, ls, R, 1.0, gen)
    torch.cuda.synchronize()
    return trainer


def test_graph_capture_after_dropped_trainers(cuda):
    """Trainers whose graphs only a reference cycle keeps alive are
    collected before the next capture, not inside it, where destroying a
    graph invalidates the capture: with a collection forced inside the
    capture, a capture after two such trainers were dropped succeeds, and
    their graphs are gone before it begins."""
    import gc
    import weakref

    hp = _graph_hp("SRURNN", "bfloat16", num_hidden=1)
    collecting = gc.isenabled()
    gc.disable()  # the dropped graphs wait for a collection
    try:
        trainers = [_small_graph_run(cuda, hp, seed) for seed in range(2)]
        dropped = []
        for trainer in trainers:
            (sg,) = trainer._graphs.graphs.values()
            sg.cycle = trainer  # trainer -> its graphs -> this graph
            dropped.append(weakref.ref(sg))
        del trainers, trainer, sg
        assert all(ref() is not None for ref in dropped)
        alive = []
        _small_graph_run(cuda, hp, 2, inside=lambda: alive.append(
            [ref() is not None for ref in dropped]) or gc.collect())
    finally:
        if collecting:
            gc.enable()
    assert alive and not any(any(a) for a in alive)
    assert all(ref() is None for ref in dropped)


def test_graph_kernel_nodes_are_its_launches(cuda):
    """The launches a replay adds to the counters are the captured
    graph's kernel nodes, read from the graph: one sru_fwd_scan_kernel
    node for each of 3 calls, and as many again of another graph."""
    from gantts_tpu_torch.train.graphs import kernel_nodes

    u = torch.randn(GRAPH_T, GRAPH_B, 4 * 64, device=cuda)
    bias4 = torch.zeros(4 * 64, device=cuda)
    lengths = torch.full((GRAPH_B,), GRAPH_T, dtype=torch.int32,
                         device=cuda)
    K.sru_fwd_scan(u, bias4, lengths, False, False)
    torch.cuda.synchronize()
    for calls in (3, 5):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            for _ in range(calls):
                K.sru_fwd_scan(u, bias4, lengths, False, False)
        graph.instantiate()
        assert kernel_nodes(graph) == {"sru_fwd_scan": calls}


GRAPH_DESTROYED_INSIDE = """
import gc, sys
import torch
x = torch.zeros(1 << 20, device="cuda")
gc.disable()
class Holder:
    pass
for _ in range(2):
    h = Holder()
    h.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(h.graph):
        h.y = x * 2
    if sys.argv[1] == "cycle":
        h.me = h
    del h
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        z = x + 1
        gc.collect()
        z += 1
    graph.replay()
    torch.cuda.synchronize()
    print("captured", float(z[0]))
except Exception as e:
    print("failed:", e)
"""


@pytest.mark.parametrize("cycle", [True, False])
def test_graph_destroyed_inside_a_capture(cuda, cycle):
    """Why a capture collects first and pauses the collector
    (train/graphs.py): a CUDA graph that only a reference cycle keeps
    alive, destroyed by a collection inside another graph's capture,
    invalidates that capture; without the cycle it went at once, and the
    same capture succeeds.  In a process of its own, since the failed
    capture is the point."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", GRAPH_DESTROYED_INSIDE,
         "cycle" if cycle else "none"], capture_output=True, text=True,
        timeout=300).stdout
    if cycle:
        assert "failed:" in out and "capture" in out, out
    else:
        assert "captured 2.0" in out, out


# Data parallelism on the one card (gantts_tpu_torch/parallel/): spawned
# rank processes run tests/torch_parallel_workers.py's programs.  NCCL takes
# one rank per GPU, so a one-card machine checks NCCL at world size 1 and
# the sharded math with two gloo ranks on the same card.

SRU_LAUNCHES = {"sru_proj_gemm": 2, "sru_fwd_scan": 2, "sru_bwd_scan": 2}


def test_dp_one_nccl_rank_is_the_plain_trainer(cuda, tmp_path):
    """A one-rank NCCL group: DataParallelGanTrainer and GanTrainer from the
    same states, 3 steps of a bidirectional SRU step with dropout on, give
    the same bits in every scalar, parameter, optimizer value and the
    dropout generator's state, with the same SRU launches; the time-sharded
    MLPG at world size 1 matches the stencil."""
    import torch_parallel_workers as W

    from gantts_tpu_torch.core.fast_mlpg import unit_variance_mlpg_stencil
    from gantts_tpu_torch.hparams import vc

    u = np.random.RandomState(0).randn(2, 512, 15).astype(np.float32)
    (res,) = W.run_session(1, dict(device="cuda:0",
                                   world_one=W.port_case("sru", 6, T=96),
                                   mlpg={512: u}),
                           str(tmp_path), device="cuda")
    got = res["world_one"]
    assert got["backend"] == "nccl"
    assert got["scalars"] and got["states"] and got["generator"]
    dp, plain = got["launches"]
    assert dp == plain
    assert {k: dp[k] for k in SRU_LAUNCHES} == {
        k: 3 * n for k, n in SRU_LAUNCHES.items()}
    ref = unit_variance_mlpg_stencil(torch.as_tensor(u), vc.windows)
    assert float((torch.as_tensor(res["mlpg512"]) - ref).abs().max()) < 5e-5


def test_dp_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks with their tensors on cuda:0 (the collectives staged
    through the host) against one process on the whole batch, on the card:
    tests/test_parallel.py's scalar limits, the summed gradients within
    1e-5 of each tensor's largest entry, and both ranks' parameters the same
    bits, for the SRU step and the vc step padded with a zero-length row."""
    import torch_parallel_workers as W

    cases = {"sru": W.port_case("sru", 8), "vc15": W.port_case("vc", 15)}
    ranks = W.run_session(2, dict(device="cuda:0", steps=cases),
                          str(tmp_path))
    for name in cases:
        single = ranks[0][name]["single"]
        for res in ranks:
            dp = res[name]["dp"]
            for k, v in single["out"].items():
                assert np.isclose(dp["out"][k], v, rtol=2e-4, atol=1e-5,
                                  equal_nan=True), (name, k)
            for which in ("grads_g", "grads_d"):
                for k, g in single[which].items():
                    err = float(np.abs(dp[which][k] - g).max())
                    assert err <= 1e-5 * float(np.abs(g).max()), (name, k)
            for which in ("g", "d"):
                for k, v in ranks[0][name]["dp"][which].items():
                    assert (dp[which][k] == v).all(), (name, k)
