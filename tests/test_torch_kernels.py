"""The port's SRU layer functions (their plain versions, which CPU tensors
take) against the JAX package's Pallas kernels, run in interpret mode on the
CPU as tests/test_kernels.py runs them.

Inputs come from one numpy seed and feed both packages.  Tolerances are
those of tests/test_kernels.py: f32 forward atol 2e-5 and gradients
< 2e-5 * max(|ref|, 1); bf16 dx 1e-2, dW and db 1e-4 (relative to scale),
since dx leaves the layer in bf16 while dW and db stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gantts_tpu.kernels import fused_sru_layer as jax_sru_layer
from gantts_tpu.kernels import fused_sru_proj_layer as jax_proj_layer
from gantts_tpu_torch.kernels import sru_scan as K

torch.set_num_threads(1)


def _inputs(seed, T, B, D, H):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, B, D).astype(np.float32)
    w = (rs.randn(D, 4 * H) * 0.1).astype(np.float32)
    z = np.zeros(H, np.float32)
    bias4 = np.concatenate([z, (rs.randn(H) * 0.1).astype(np.float32),
                            (rs.randn(H) * 0.1).astype(np.float32), z])
    lengths = np.r_[rs.randint(5, T, B - 1), T].astype(np.int32)
    return x, w, bias4, lengths


def _grads(loss, fn, *arrays):
    """(output, grads of loss(output) w.r.t. arrays) on the torch side."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    h = fn(*ts)
    return h.detach(), torch.autograd.grad(loss(h), ts)


def _close(name, a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1.0)
    err = np.abs(a - b).max()
    assert err < tol * scale, (name, err, scale)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
def test_proj_layer_f32_matches_jax(reverse, use_relu):
    """fused_sru_proj_layer, f32: h, dx, dW, db of sum(sin(h)); ragged
    lengths, D and H not multiples of anything."""
    x, w, bias4, lengths = _inputs(3, 37, 5, 70, 48)

    def jfn(x, w, b):
        return jax_proj_layer(x, w, jnp.asarray(lengths), bias4=b,
                              reverse=reverse, use_relu=use_relu,
                              compute_dtype="float32")

    h_ref = np.asarray(jfn(x, w, bias4))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))),
                     argnums=(0, 1, 2))(x, w, bias4)
    h, g = _grads(lambda h: torch.sin(h).sum(),
                  lambda x, w, b: K.fused_sru_proj_layer(
                      x, w, torch.tensor(lengths), bias4=b, reverse=reverse,
                      use_relu=use_relu, compute_dtype="float32"),
                  x, w, bias4)
    assert h.dtype == torch.float32
    assert np.abs(h.numpy() - h_ref).max() < 2e-5
    for name, a, b in zip(("dx", "dW", "db"), g, g_ref):
        _close(name, a.numpy(), b, 2e-5)


def test_proj_layer_bf16_matches_jax():
    """bf16 I/O: h in bf16 (one bf16 rounding apart at most), dx in the
    caller's f32 but quantized through bf16, dW and db f32."""
    x, w, bias4, lengths = _inputs(4, 40, 4, 96, 64)

    def jfn(x, w, b):
        return jax_proj_layer(x, w, jnp.asarray(lengths), bias4=b,
                              reverse=True, use_relu=0,
                              compute_dtype="bfloat16")

    h_ref = jfn(x, w, bias4)
    g_ref = jax.grad(lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) ** 2),
                     argnums=(0, 1, 2))(x, w, bias4)
    h, g = _grads(lambda h: (h.float() ** 2).sum(),
                  lambda x, w, b: K.fused_sru_proj_layer(
                      x, w, torch.tensor(lengths), bias4=b, reverse=True,
                      use_relu=0, compute_dtype="bfloat16"),
                  x, w, bias4)
    assert h.dtype == torch.bfloat16
    _close("h", h.float().numpy(), np.asarray(h_ref, np.float32), 1e-2)
    for (name, tol), a, b in zip((("dx", 1e-2), ("dW", 1e-4), ("db", 1e-4)),
                                 g, g_ref):
        _close(name, a.numpy(), b, tol)


@pytest.mark.parametrize("reverse,use_relu", [(False, 1), (True, 0)])
def test_u_layer_matches_jax(reverse, use_relu):
    """fused_sru_layer from a precomputed u (f32): h, du and dbias, whose
    x~ and x' blocks are structurally zero."""
    _, _, bias4, lengths = _inputs(5, 29, 3, 8, 40)
    u = np.random.RandomState(6).randn(29, 3, 160).astype(np.float32)

    def jfn(u, b):
        return jax_sru_layer(u, jnp.asarray(lengths), bias4=b,
                             reverse=reverse, use_relu=use_relu)

    h_ref = np.asarray(jfn(u, bias4))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))),
                     argnums=(0, 1))(u, bias4)
    h, g = _grads(lambda h: torch.sin(h).sum(),
                  lambda u, b: K.fused_sru_layer(
                      u, torch.tensor(lengths), bias4=b, reverse=reverse,
                      use_relu=use_relu),
                  u, bias4)
    assert np.abs(h.numpy() - h_ref).max() < 2e-5
    for name, a, b in zip(("du", "db"), g, g_ref):
        _close(name, a.numpy(), b, 2e-5)
    H = 40
    assert (g[1][:H] == 0).all() and (g[1][3 * H:] == 0).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
def test_plain_forward_padding_contract(reverse, use_relu):
    """What the chunked forward kernel's shortcut for runs of padded frames
    must reproduce, pinned on ``sru_fwd_scan_plain``: h = 0 at padded
    frames; c holds the last valid c through the padding in the forward
    traversal and is 0 before the first valid frame in the reversed one.
    h and c are held to the JAX package's ``_fused_fwd_call`` (the Pallas
    kernel in interpret mode, which exposes c), f32, at shapes that need
    no tile padding (B=8, H=128, T=32); the padding properties are checked
    on the plain version alone, exactly."""
    from gantts_tpu.kernels.sru_scan import _fused_fwd_call

    T, B, H = 32, 8, 128
    rs = np.random.RandomState(8)
    u = rs.randn(T, B, 4 * H).astype(np.float32)
    bias4 = np.r_[np.zeros(H), rs.randn(2 * H) * 0.3,
                  np.zeros(H)].astype(np.float32)
    lengths = np.array([32, 1, 5, 16, 17, 31, 9, 2], np.int32)
    len_bc = np.broadcast_to(lengths[:, None].astype(np.float32), (B, H))
    b2d = np.broadcast_to(bias4[None, :], (8, 4 * H))
    h_ref, c_ref, _ = _fused_fwd_call(jnp.asarray(u), jnp.asarray(b2d),
                                      jnp.asarray(len_bc), reverse,
                                      bool(use_relu))
    h, c = K.sru_fwd_scan_plain(torch.tensor(u), torch.tensor(bias4),
                                torch.tensor(lengths), reverse, use_relu)
    _close("h", h.numpy(), np.asarray(h_ref), 2e-5)
    _close("c", c.numpy(), np.asarray(c_ref), 2e-5)
    for b, n in enumerate(lengths):
        assert (h[n:, b] == 0).all()
        if reverse:
            assert (c[n:, b] == 0).all()
        else:
            assert (c[n:, b] == c[n - 1, b]).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
def test_plain_backward_is_autograd_of_plain_forward(reverse, use_relu):
    """The hand-written backward scan (what sru_bwd_scan computes) equals
    autograd through the differentiable plain forward scan; both run in
    f32, in different orders of operations."""
    rs = np.random.RandomState(7)
    T, B, H = 23, 4, 6
    u = torch.tensor(rs.randn(T, B, 4 * H).astype(np.float32),
                     requires_grad=True)
    bias4 = torch.tensor(np.r_[np.zeros(H), rs.randn(2 * H) * 0.3,
                               np.zeros(H)].astype(np.float32),
                         requires_grad=True)
    lengths = torch.tensor([23, 17, 9, 1], dtype=torch.int32)
    gh = torch.tensor(rs.randn(T, B, H).astype(np.float32))
    h, c = K.sru_fwd_scan_plain(u, bias4, lengths, reverse, use_relu)
    du_ref, db_ref = torch.autograd.grad(h, (u, bias4), gh)
    du, db = K.sru_bwd_scan_plain(u.detach(), bias4.detach(), lengths,
                                  c.detach(), gh, reverse, use_relu)
    _close("du", du.numpy(), du_ref.numpy(), 1e-6)
    _close("db", db.numpy(), db_ref.numpy(), 1e-6)
    # padded frames: h is zero there and du carries nothing
    pad = torch.arange(T)[:, None] >= lengths[None, :]
    assert (h[pad] == 0).all() and (du[pad] == 0).all()
