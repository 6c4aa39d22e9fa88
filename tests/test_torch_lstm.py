"""The port's LSTM family against the JAX package's, on the CPU.

Kernels: the port's layer functions (their plain versions, which CPU tensors
take) against the JAX package's Pallas LSTM kernels, run in interpret mode on
the CPU as tests/test_kernels.py runs them, on the same numpy inputs:
y and the gradients of a scalar loss with respect to x (or xp), w_ih, w_hh
and the bias.  Tolerances are those of tests/test_kernels.py for the
bidirectional kernel: f32 forward 5e-6 and gradients 5e-5 of scale, bf16
forward 1/128 and gradients 3e-2 of scale.  Padded frames must be exactly
zero.

Models: ``LSTMRNN`` and ``GRURNN`` (2 layers, H=32, acoustic widths) from
weights converted out of the JAX ``init``, dropout off: f32 against the JAX
CPU scan, bf16 against the JAX Pallas path (interpret mode).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gantts_tpu.kernels as jax_kernels
from gantts_tpu.kernels import lstm_scan as JL
from gantts_tpu.models import GRURNN as JaxGRURNN
from gantts_tpu.models import LSTMRNN as JaxLSTMRNN
from gantts_tpu_torch import convert
from gantts_tpu_torch.kernels import lstm_scan as L
from gantts_tpu_torch.models import GRURNN, LSTMRNN, _dropout

torch.set_num_threads(1)

T, B, D, H = 21, 3, 11, 9
LENGTHS = np.array([21, 13, 5], np.int32)
TOL = {"float32": (5e-6, 5e-5), "bfloat16": (1 / 128, 3e-2)}


def _params(rs, D):
    return dict(w_ih=(rs.randn(D, 4 * H) * 0.3).astype(np.float32),
                w_hh=(rs.randn(H, 4 * H) * 0.3).astype(np.float32),
                bias=(rs.randn(4 * H) * 0.1).astype(np.float32))


def _close(name, a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1.0)
    err = np.abs(a - b).max()
    assert err <= tol * scale, (name, err, scale)


def _padded_zero(y):
    pad = np.arange(T)[:, None] >= LENGTHS[None, :]
    assert (np.asarray(y, np.float32)[pad] == 0).all()


def _loss_jax(y):
    y = y.astype(jnp.float32)
    return jnp.sum(y ** 2) + jnp.sum(y[:, :, ::2] ** 3)


def _loss_torch(y):
    y = y.float()
    return (y ** 2).sum() + (y[:, :, ::2] ** 3).sum()


def _both(jfn, tfn, arrays):
    """Output and gradients of the loss for the JAX and the torch function
    of the same numpy ``arrays`` (a flat list)."""
    y_ref = jfn(*arrays)
    g_ref = jax.grad(lambda *a: _loss_jax(jfn(*a)),
                     argnums=tuple(range(len(arrays))))(*arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = tfn(*ts)
    g = torch.autograd.grad(_loss_torch(y), ts)
    return (np.asarray(y_ref, np.float32), [np.asarray(a) for a in g_ref]), \
        (y.detach().float().numpy(), [t.numpy() for t in g])


def _check(names, ref, got, cd):
    fwd_tol, g_tol = TOL[cd]
    (y_ref, g_ref), (y, g) = ref, got
    _close("y", y, y_ref, fwd_tol)
    _padded_zero(y)
    for name, a, b in zip(names, g, g_ref):
        _close(name, a, b, g_tol)


@pytest.mark.parametrize("cd,Din", [("float32", D), ("bfloat16", D),
                                    ("float32", 425), ("bfloat16", 425)])
def test_bilstm_proj_layer_matches_jax(cd, Din):
    rs = np.random.RandomState(7)
    x = rs.randn(T, B, Din).astype(np.float32)
    pf, pb = _params(rs, Din), _params(rs, Din)
    keys = ("w_ih", "w_hh", "bias")
    arrays = [x] + [pf[k] for k in keys] + [pb[k] for k in keys]

    def jfn(x, a, b, c, d, e, f):
        yf, yb = JL.fused_bilstm_proj_layer(
            x, dict(w_ih=a, w_hh=b, bias=c), dict(w_ih=d, w_hh=e, bias=f),
            jnp.asarray(LENGTHS), compute_dtype=cd)
        return jnp.concatenate([yf, yb], -1)

    def tfn(x, a, b, c, d, e, f):
        yf, yb = L.fused_bilstm_proj_layer(
            x, dict(w_ih=a, w_hh=b, bias=c), dict(w_ih=d, w_hh=e, bias=f),
            torch.tensor(LENGTHS), compute_dtype=cd)
        assert yf.dtype == L.io_dtype(cd)
        return torch.cat([yf, yb], -1)

    ref, got = _both(jfn, tfn, arrays)
    _check(("dx", "dw_ih_f", "dw_hh_f", "db_f", "dw_ih_b", "dw_hh_b",
            "db_b"), ref, got, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_proj_layer_matches_jax(cd, reverse):
    rs = np.random.RandomState(5)
    x = rs.randn(T, B, D).astype(np.float32)
    p = _params(rs, D)
    arrays = [x, p["w_ih"], p["w_hh"], p["bias"]]

    def jfn(x, wi, wh, b):
        return JL.fused_lstm_proj_layer(x, wi, wh, b, jnp.asarray(LENGTHS),
                                        reverse=reverse, compute_dtype=cd)

    def tfn(x, wi, wh, b):
        return L.fused_lstm_proj_layer(x, wi, wh, b, torch.tensor(LENGTHS),
                                       reverse=reverse, compute_dtype=cd)

    ref, got = _both(jfn, tfn, arrays)
    _check(("dx", "dw_ih", "dw_hh", "db"), ref, got, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(cd, reverse):
    """From xp in the I/O dtype: y, dxp, dW_hh and the bias gradient."""
    rs = np.random.RandomState(3)
    xp = np.asarray(jnp.asarray(rs.randn(T, B, 4 * H) * 0.5, cd), np.float32)
    p = _params(rs, D)
    arrays = [xp, p["w_hh"], p["bias"]]
    dt = L.io_dtype(cd)

    def jfn(xp, wh, b):
        return JL.fused_lstm_layer(xp.astype(cd), wh, b, jnp.asarray(LENGTHS),
                                   reverse=reverse)

    def tfn(xp, wh, b):
        y = L.fused_lstm_layer(xp.to(dt), wh, b, torch.tensor(LENGTHS),
                               reverse=reverse)
        assert y.dtype == dt
        return y

    ref, got = _both(jfn, tfn, arrays)
    _check(("dxp", "dw_hh", "db"), ref, got, cd)


@pytest.mark.parametrize("reverse", [(False, True), (False,), (True,)])
def test_plain_backward_is_autograd_of_plain_forward(reverse):
    """The hand-written backward scan (what lstm_bwd_scan computes) equals
    autograd through the differentiable plain forward scan, in f32: dxp, the
    bias gradient, and dW_hh from the shifted outputs."""
    rs = np.random.RandomState(8)
    nd, Tn, Bn, Hn = len(reverse), 23, 4, 6
    xp = torch.tensor(rs.randn(Tn, Bn, nd * 4 * Hn).astype(np.float32),
                      requires_grad=True)
    whh = torch.tensor((rs.randn(nd, Hn, 4 * Hn) * 0.3).astype(np.float32),
                       requires_grad=True)
    bias = torch.tensor((rs.randn(nd, 4 * Hn) * 0.3).astype(np.float32),
                        requires_grad=True)
    lengths = torch.tensor([23, 17, 9, 1], dtype=torch.int32)
    gy = torch.tensor(rs.randn(Tn, Bn, nd * Hn).astype(np.float32))
    y, c, g4 = L.lstm_fwd_scan_plain(xp, whh, bias, lengths, reverse)
    dxp_ref, dwhh_ref, db_ref = torch.autograd.grad(y, (xp, whh, bias), gy)
    dxp, db = L.lstm_bwd_scan_plain(whh.detach(), lengths, c.detach(),
                                    g4.detach(), gy, reverse)
    dwhh = torch.stack([L._shifted_dwhh(y.detach(), dxp, d, Hn, r)
                        for d, r in enumerate(reverse)])
    _close("dxp", dxp.numpy(), dxp_ref.numpy(), 1e-6)
    _close("db", db.numpy(), db_ref.numpy(), 1e-6)
    _close("dw_hh", dwhh.numpy(), dwhh_ref.numpy(), 1e-6)
    pad = torch.arange(Tn)[:, None] >= lengths[None, :]
    assert (y[pad] == 0).all() and (dxp[pad] == 0).all()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_forward_matches_jax_fwd_call(cd, reverse):
    """What the forward kernels write and the backward reads, pinned on
    ``lstm_fwd_scan_plain``: y, c and g4 against the JAX package's
    ``_fwd_call`` (the Pallas kernel in interpret mode, which exposes c and
    g4), at shapes that need no tile padding (B=8, H=128, T=32) with
    lengths of 1 to T.  Limits as the layer tests' forward: 5e-6 of scale
    in f32, and 1/128 in bf16 (one bf16 rounding of y or g4, and c fed by
    the bf16-rounded h).  Then, exactly, on the plain version: y = 0 at
    padded frames; c holds the last valid c through the padding in the
    forward traversal and is 0 before the first valid frame in the
    reversed one, where h is 0 too: the gates there are those of xp + b
    alone."""
    Tn, Bn, Hn = 32, 8, 128
    rs = np.random.RandomState(9)
    xp = np.asarray(jnp.asarray(rs.randn(Tn, Bn, 4 * Hn) * 0.5, cd),
                    np.float32)
    whh = (rs.randn(Hn, 4 * Hn) * 0.1).astype(np.float32)
    bias = (rs.randn(4 * Hn) * 0.1).astype(np.float32)
    lengths = np.array([32, 1, 5, 16, 17, 31, 9, 2], np.int32)
    len_bc = np.broadcast_to(lengths[:, None].astype(np.float32), (Bn, Hn))
    b2d = np.broadcast_to(bias[None, :], (8, 4 * Hn))
    refs = JL._fwd_call(jnp.asarray(xp, cd), jnp.asarray(whh),
                        jnp.asarray(b2d), jnp.asarray(len_bc), reverse)
    dt = L.io_dtype(cd)
    xp_t = torch.tensor(xp).to(dt)
    y, c, g4 = L.lstm_fwd_scan_plain(xp_t, torch.tensor(whh).to(dt)[None],
                                     torch.tensor(bias)[None],
                                     torch.tensor(lengths), (reverse,))
    assert y.dtype == dt and g4.dtype == dt and c.dtype == torch.float32
    tol = TOL[cd][0]
    for name, got, ref in zip(("y", "c", "g4"), (y, c, g4), refs):
        _close(name, got.float().numpy(), np.asarray(ref, np.float32), tol)
    pre = xp_t.float() + torch.tensor(bias)
    alone = torch.cat([torch.sigmoid(pre[..., :2 * Hn]),
                       torch.tanh(pre[..., 2 * Hn:3 * Hn]),
                       torch.sigmoid(pre[..., 3 * Hn:])], -1).to(dt)
    for b, n in enumerate(lengths):
        assert (y[n:, b] == 0).all()
        if reverse:
            assert (c[n:, b] == 0).all()
            assert torch.equal(g4[n:, b], alone[n:, b])
        else:
            assert (c[n:, b] == c[n - 1, b]).all()


def _model_case(jcls, cls, bidirectional, cd, seed):
    kw = dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
              bidirectional=bidirectional, compute_dtype=cd)
    rs = np.random.RandomState(seed)
    Bm, Tm = 3, 40
    x = rs.rand(Bm, Tm, 425).astype(np.float32)
    lengths = np.r_[rs.randint(Tm // 2, Tm, Bm - 1), Tm].astype(np.int32)
    gy = rs.randn(Bm, Tm, 187).astype(np.float32)
    jm = jcls(**kw)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(lengths))
    model = cls(**kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    model.eval()
    with mock.patch.object(jax_kernels, "default_use_pallas",
                           lambda: cd == "bfloat16"):
        y_ref, vjp = jax.vjp(
            lambda v, a: jm.apply(v, a, jnp.asarray(lengths)), variables,
            jnp.asarray(x))
        gv, dx_ref = vjp(jnp.asarray(gy))
    tx = torch.tensor(x, requires_grad=True)
    y = model(tx, torch.tensor(lengths))
    y.backward(torch.tensor(gy))
    return (np.asarray(y_ref), np.asarray(dx_ref),
            convert.flax_to_torch(gv)), (y.detach(), tx.grad, model)


@pytest.mark.parametrize("name", ["LSTMRNN", "GRURNN"])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_models_match_jax(name, bidirectional, cd):
    """Output, dx and every parameter gradient for one output cotangent.
    f32: atol 1e-5 forward (as the SRU model test), dx and gradients 1e-5
    of scale (two layers of scans and 425 inputs summed in other orders;
    the largest reading was 1.0e-6).  bf16: output and dx 1e-2 of scale, as
    the bf16 SRURNN test; parameter gradients 5e-3 of scale.  y and dxp are
    stored in bf16 by both, and here a dxp that rounds one bf16 step apart
    also feeds the recurrence's dh, so a lower layer's gradient carries
    more such steps than the SRU's: the largest reading was 1.6e-3
    (GRURNN, bidirectional, layer 0's bias), under the kernel tests'
    3e-2."""
    jcls, cls = ((JaxLSTMRNN, LSTMRNN) if name == "LSTMRNN"
                 else (JaxGRURNN, GRURNN))
    (y_ref, dx_ref, g_ref), (y, dx, model) = _model_case(
        jcls, cls, bidirectional, cd, 21)
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == \
        {cls.scope, "hidden2out"}
    assert y.dtype == torch.float32 and y.shape == (3, 40, 187)
    if cd == "float32":
        assert np.abs(y.numpy() - y_ref).max() < 1e-5
        tol, g_tol = 1e-5, 1e-5
    else:
        _close("y", y.numpy(), y_ref, 1e-2)
        tol, g_tol = 1e-2, 5e-3
    _close("dx", dx.numpy(), dx_ref, tol)
    for n, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, n
        _close(n, p.grad.numpy(), g_ref[n].numpy(), g_tol)


def test_lstm_dropout_is_per_element():
    """Between layers the mask is drawn per element (not shared across time
    as the SRU's variational mask is), from the caller's generator, and off
    in eval."""
    model = LSTMRNN(in_dim=6, out_dim=2, num_hidden=2, hidden_dim=5,
                    dropout=0.5)
    seen = []
    with mock.patch("gantts_tpu_torch.models.recurrent._dropout",
                    side_effect=lambda *a: seen.append(a) or _dropout(*a)):
        gen = torch.Generator()
        gen.manual_seed(0)
        x = torch.rand(2, 30, 6)
        model.train()(x, generator=gen)
        model.eval()(x, generator=gen)
    assert len(seen) == 2  # one application between the two layers, per call
    (out, rate, training, _), (_, _, eval_training, _) = seen
    assert rate == 0.5 and training and not eval_training
    gen.manual_seed(1)
    d = _dropout(torch.ones_like(out), 0.5, True, gen)
    assert set(d.unique().tolist()) == {0.0, 2.0}
    assert not torch.equal(d, d[:1].expand_as(d))
    assert torch.equal(_dropout(out, 0.5, False, gen), out)
