"""The k=3 SRU path: the linear recurrence (kernel table row 4), the k=3
``SRULayer`` and the unidirectional ``SRURNN``, against the JAX package.

The JAX side runs ``linear_recurrence_pallas`` in interpret mode on the CPU,
as tests/test_kernels.py runs it, and its associative-scan oracle
``gantts_tpu.models.sru.linear_recurrence``; the port's CPU tensors take the
kernels' plain versions.  Shapes are ragged: T=37 is not a multiple of the
Pallas chunk, B=3 and H=20 are not tile multiples (the JAX wrapper pads them,
the port does not).

Tolerances, those of tests/test_kernels.py for the recurrence (values atol
1e-5, gradients atol 1e-4 on O(1) inputs) and of tests/test_torch_models.py
for the layers and the stack in float32 (forward atol 1e-5, gradients 1e-5
of each tensor's scale).  bfloat16 stacks: the JAX package's Pallas path in
interpret mode; the k=4 first layer stores u and h in bf16, so as in
test_torch_models.py the output is held to 1e-2 of scale and the parameter
gradients to 1e-3 of scale.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gantts_tpu.kernels as jax_kernels
from gantts_tpu.kernels import linear_recurrence_pallas
from gantts_tpu.models import SRURNN as JaxSRURNN
from gantts_tpu.models.sru import SRULayer as JaxSRULayer
from gantts_tpu.models.sru import linear_recurrence as jax_oracle
from gantts_tpu_torch import convert
from gantts_tpu_torch.kernels import linear_scan as L
from gantts_tpu_torch.models import SRURNN
from gantts_tpu_torch.models.sru import SRULayer

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _fb(seed, T, B, H):
    """Time-major f in (0.05, 0.95), b in (-0.5, 0.5), cotangent w."""
    rs = np.random.RandomState(seed)
    f = (rs.rand(T, B, H) * 0.9 + 0.05).astype(np.float32)
    b = (rs.rand(T, B, H) - 0.5).astype(np.float32)
    w = rs.rand(T, B, H).astype(np.float32)
    return f, b, w


def _bm(a):
    """Time-major numpy -> batch-major jax array (the JAX wrapper's layout)."""
    return jnp.asarray(np.swapaxes(a, 0, 1))


SHAPES = [(37, 3, 20), (16, 2, 8), (5, 1, 1)]


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_linear_recurrence_matches_pallas_and_oracle(T, B, H):
    f, b, _ = _fb(0, T, B, H)
    got = L.linear_recurrence_fwd(torch.tensor(f), torch.tensor(b)).numpy()
    for ref in (linear_recurrence_pallas(_bm(f), _bm(b)),
                jax_oracle(_bm(f), _bm(b))):
        ref = np.swapaxes(np.asarray(ref), 0, 1)
        assert got.shape == ref.shape == (T, B, H)
        assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_linear_recurrence_gradients_match_pallas_and_oracle(T, B, H):
    f, b, w = _fb(1, T, B, H)
    tf = torch.tensor(f, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    (L.linear_recurrence(tf, tb) * torch.tensor(w)).sum().backward()
    for fn in (linear_recurrence_pallas, jax_oracle):
        gf, gb = jax.grad(lambda f_, b_: jnp.sum(fn(f_, b_) * _bm(w)),
                          argnums=(0, 1))(_bm(f), _bm(b))
        for got, ref in ((tf.grad, gf), (tb.grad, gb)):
            ref = np.swapaxes(np.asarray(ref), 0, 1)
            assert np.abs(got.numpy() - ref).max() < 1e-4


def test_linear_recurrence_plain_backward_gradcheck():
    """float64 gradcheck of the autograd Function on CPU tensors (its plain
    forward and backward), f near 1 included."""
    rs = np.random.RandomState(2)
    f = torch.tensor(rs.rand(9, 2, 3) * 0.5 + 0.5, dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(rs.randn(9, 2, 3), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(L.linear_recurrence, (f, b))


def test_linear_recurrence_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; any other
    device, an empty tensor or a mismatched shape raises."""
    L.launch_counts.update(linear_recurrence_fwd=0, linear_recurrence_bwd=0)
    f, b, w = (torch.tensor(a) for a in _fb(3, 6, 2, 4))
    c = L.linear_recurrence_fwd(f, b)
    df, db = L.linear_recurrence_bwd(w, f, c)
    assert df.shape == db.shape == c.shape == (6, 2, 4)
    assert torch.equal(df[0], torch.zeros_like(df[0]))  # c_{-1} = 0
    assert L.launch_counts["linear_recurrence_fwd"] == 0
    assert L.launch_counts["linear_recurrence_bwd"] == 0
    meta = torch.empty(6, 2, 4, device="meta")
    with pytest.raises(ValueError, match="expected"):
        L.linear_recurrence_fwd(meta, meta)
    with pytest.raises(ValueError, match="expected"):
        L.linear_recurrence_bwd(meta, meta, torch.empty(6, 2, 5,
                                                        device="meta"))
    with pytest.raises(ValueError, match="non-empty"):
        L.linear_recurrence_fwd(meta[:0], meta[:0])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_relu", [0, 1])
def test_k3_sru_layer_matches_jax(reverse, use_relu):
    """One D == H layer, time-major, from converted weights: h and the
    gradients of x, w, bf and br for one cotangent."""
    T, B, H = 37, 3, 20
    rs = np.random.RandomState(4)
    x = rs.randn(T, B, H).astype(np.float32)
    lengths = np.array([37, 21, 9], np.int32)
    gh = rs.randn(T, B, H).astype(np.float32)
    jm = JaxSRULayer(hidden_dim=H, use_relu=use_relu, reverse=reverse)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(x),
                        jnp.asarray(lengths))
    assert variables["params"]["w"].shape == (H, 3 * H)
    h_ref, vjp = jax.vjp(
        lambda v, a: jm.apply(v, a, jnp.asarray(lengths)), variables,
        jnp.asarray(x))
    gv, dx_ref = vjp(jnp.asarray(gh))

    layer = SRULayer(H, H, use_relu=use_relu, reverse=reverse)
    layer.load_state_dict(convert.flax_to_torch(variables), strict=True)
    assert layer.k == 3
    tx = torch.tensor(x, requires_grad=True)
    h = layer(tx, torch.tensor(lengths))
    h.backward(torch.tensor(gh))
    assert h.dtype == torch.float32
    assert np.abs(h.detach().numpy() - np.asarray(h_ref)).max() < 1e-5
    pad = np.arange(T)[:, None] >= lengths[None, :]
    assert (h.detach().numpy()[pad] == 0).all()
    ref = convert.flax_to_torch(gv)
    grads = dict(layer.named_parameters())
    for name, g, r in [("x", tx.grad, np.asarray(dx_ref))] + [
            (n, p.grad, ref[n].numpy()) for n, p in grads.items()]:
        assert _rel(g.numpy(), r) < 1e-5, name


def _uni_kw(**kw):
    return dict(in_dim=425, out_dim=187, num_hidden=3, hidden_dim=32,
                bidirectional=False, **kw)


@pytest.mark.parametrize("use_relu", [0, 1])
def test_unidirectional_srurnn_matches_jax(use_relu):
    """3-layer unidirectional SRURNN (layer 0 k=4, layers 1-2 k=3) with the
    acoustic widths, float32: output and every parameter gradient of a
    scalar loss."""
    kw = _uni_kw(use_relu=use_relu)
    rs = np.random.RandomState(5)
    x = rs.rand(3, 40, 425).astype(np.float32)
    lengths = np.array([40, 27, 33], np.int32)
    jm = JaxSRURNN(**kw)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(x),
                        jnp.asarray(lengths))
    assert variables["params"]["gru"]["l1_fwd"]["w"].shape == (32, 96)

    def jloss(v):
        return jnp.sum(jnp.sin(jm.apply(v, jnp.asarray(x),
                                        jnp.asarray(lengths))))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(variables)
    model = SRURNN(**kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    model.eval()
    loss = torch.sin(model(torch.tensor(x), torch.tensor(lengths))).sum()
    loss.backward()
    lv = float(loss.detach())
    assert abs(lv - float(ref_loss)) < 1e-5 * max(abs(lv), 1)
    ref = convert.flax_to_torch(ref_grads)
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), ref[name].numpy()) < 1e-5, name


def test_unidirectional_srurnn_bf16_matches_jax():
    """The same stack with bf16 compute against the JAX package's Pallas
    path in interpret mode (the k=4 layer's fused kernel, the k=3 layers'
    ``linear_recurrence_pallas``): output and every parameter gradient."""
    kw = _uni_kw(use_relu=1, compute_dtype="bfloat16")
    rs = np.random.RandomState(6)
    x = rs.rand(3, 40, 425).astype(np.float32)
    lengths = np.array([40, 27, 33], np.int32)
    gy = rs.randn(3, 40, 187).astype(np.float32)
    jm = JaxSRURNN(**kw)
    variables = jm.init(jax.random.PRNGKey(6), jnp.asarray(x),
                        jnp.asarray(lengths))
    with mock.patch.object(jax_kernels, "default_use_pallas", lambda: True):
        y_ref, vjp = jax.vjp(
            lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(lengths)),
            variables)
        (gv,) = vjp(jnp.asarray(gy))
    model = SRURNN(**kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    model.eval()
    y = model(torch.tensor(x), torch.tensor(lengths))
    y.backward(torch.tensor(gy))
    assert y.dtype == torch.float32
    assert _rel(y.detach().numpy(), np.asarray(y_ref)) < 1e-2
    ref = convert.flax_to_torch(gv)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        assert _rel(p.grad.numpy(), ref[name].numpy()) < 1e-3, name
