"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the JAX package, so they run on a machine that has only PyTorch;
there, skip this directory's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Shapes are ragged on purpose: T=37 is not a multiple of the scans' unroll,
B*H=240 lanes do not fill their last block, D is not a multiple of the
GEMM's K tile (the bf16 wrapper zero-pads D=70 to 72 for the kernel's
16-byte loads; D=64 goes in as it is), and T*B=185 rows do not fill their
last row tile.  Limits
are those of chip_smoke.py: max|kernel - plain| / max(max|plain|, 1) under
1e-4 in float32 and 1e-2 in bfloat16 (one bf16 rounding of an output).
"""

import numpy as np
import pytest
import torch

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
                                     "sru_bwd_scan": 1}


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
                                     "sru_bwd_scan": 4}


@pytest.mark.parametrize("K_, N_", [(425, 2048), (70, 180), (64, 192)])
def test_proj_gemm_pads_what_its_loads_cannot_take(cuda, K_, N_):
    """bf16 GEMM: a K or N that is not a multiple of 8, or an operand that
    is not 16-byte aligned (a view one element in), is zero-padded by the
    wrapper into fresh allocations; u keeps its (M, N) shape."""
    rs = np.random.RandomState(2)
    M = T * B
    x = torch.tensor(rs.randn(M, K_ + 1), dtype=torch.bfloat16, device=cuda)
    w = torch.tensor(rs.randn(K_, N_) * 0.1, dtype=torch.bfloat16,
                     device=cuda)
    for x2 in (x[:, :K_].contiguous(), x.reshape(-1)[1:M * K_ + 1]
               .view(M, K_)):
        u = K.sru_proj_gemm(x2, w)
        assert u.shape == (M, N_) and u.is_contiguous()
        assert _rel(u, K.sru_proj_gemm_plain(x2, w)) < TOL[torch.bfloat16]
