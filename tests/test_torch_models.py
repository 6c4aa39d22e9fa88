"""The port's models against the JAX package's, from weights converted out of
JAX ``init``, with dropout off; and the converter's round trip.

float32: JAX runs its CPU path (the associative-scan SRU, its own
reference); the port's CPU tensors take the kernels' plain versions.
Forward outputs agree to atol 1e-5 (different summation orders over <= 425
inputs and 40 scan steps); gradients of the D == H layer to 1e-5 relative
to scale.

bfloat16: ``matmul_cast``, the MLP discriminator and the SRU generator
against the JAX package's bf16 contract: bf16 operands with f32 output, bf16
cotangents in the backward, dW in f32.  The JAX SRU's bf16 path is its
Pallas kernels (u and h stored in bf16), which run here in interpret mode;
its CPU fallback keeps u in f32 and so is not that contract.  Tolerances
are in each test.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gantts_tpu.kernels as jax_kernels
from gantts_tpu.models import MLP as JaxMLP
from gantts_tpu.models import SRURNN as JaxSRURNN
from gantts_tpu.models.common import matmul_cast as jax_matmul_cast
from gantts_tpu_torch import convert
from gantts_tpu_torch.models import MLP, SRURNN, create_model
from gantts_tpu_torch.models.common import matmul_cast
from gantts_tpu_torch.models.sru import SRU

torch.set_num_threads(1)


def _rel(a, b):
    """max|a - b| / max(max|b|, 1), both taken in float32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _vjp_both(jfn, tfn, jargs, targs, cotangent):
    """Output and input cotangents of ``jfn`` (JAX) and ``tfn`` (torch) for
    the same output cotangent; the torch arguments must require grad."""
    y_ref, vjp = jax.vjp(jfn, *jargs)
    g_ref = vjp(jnp.asarray(cotangent))
    y = tfn(*targs)
    y.backward(torch.tensor(cotangent))
    return (y_ref, g_ref), (y.detach(), [t.grad for t in targs])


def _batch(seed, B, T, D):
    rs = np.random.RandomState(seed)
    x = rs.rand(B, T, D).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    return x, lengths


def _port(cls, variables, **kw):
    model = cls(**kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("use_relu", [0, 1])
def test_srurnn_forward_matches_jax(use_relu):
    """2-layer bidirectional SRU (H=32) with the acoustic in/out widths."""
    kw = dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
              bidirectional=True, use_relu=use_relu)
    x, lengths = _batch(0, 3, 40, 425)
    jm = JaxSRURNN(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(lengths))
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x),
                                       jnp.asarray(lengths)))
    got = _port(SRURNN, variables, **kw)(torch.tensor(x),
                                         torch.tensor(lengths))
    assert got.shape == (3, 40, 187)
    assert np.abs(got.detach().numpy() - ref).max() < 1e-5


def test_mlp_forward_matches_jax():
    kw = dict(in_dim=483, out_dim=1, num_hidden=3, hidden_dim=16,
              dropout=0.5, last_sigmoid=True)
    x, _ = _batch(1, 4, 30, 483)
    jm = JaxMLP(**kw)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = _port(MLP, variables, **kw)(torch.tensor(x))
    assert np.abs(got.detach().numpy() - ref).max() < 1e-5


def test_k3_layer_matches_jax_with_gradients():
    """D == H selects the k=3 highway (x' is the raw input), whose
    recurrence is ``LinearRecurrence`` (its plain versions on CPU tensors):
    forward and parameter gradients."""
    kw = dict(in_dim=24, out_dim=5, num_hidden=2, hidden_dim=24,
              bidirectional=False, use_relu=0)
    x, lengths = _batch(2, 3, 33, 24)
    jm = JaxSRURNN(**kw)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(lengths))
    assert variables["params"]["gru"]["l0_fwd"]["w"].shape == (24, 72)

    def jloss(v):
        return jnp.sum(jnp.sin(jm.apply(v, jnp.asarray(x),
                                        jnp.asarray(lengths))))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(variables)
    model = _port(SRURNN, variables, **kw)
    loss = torch.sin(model(torch.tensor(x), torch.tensor(lengths))).sum()
    loss.backward()
    lv = float(loss.detach())
    assert abs(lv - float(ref_loss)) < 1e-5 * max(abs(lv), 1)
    ref = convert.flax_to_torch(ref_grads)
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        scale = max(np.abs(r).max(), 1.0)
        assert np.abs(p.grad.numpy() - r).max() < 1e-5 * scale, name


def test_variational_dropout_mask_is_shared_across_time():
    """SRU dropout: one (1, B, D) mask per application, the same at every
    t, drawn from the caller's generator; MLP dropout is per element."""
    sru = SRU(8, 8, 1, rnn_dropout=0.5).train()
    x = torch.ones(50, 6, 40)
    gen = torch.Generator()
    gen.manual_seed(0)
    y = sru._vdrop(x, 0.5, gen)
    assert torch.equal(y, y[:1].expand_as(y))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    gen.manual_seed(0)
    assert torch.equal(sru._vdrop(x, 0.5, gen), y)
    assert torch.equal(sru.eval()._vdrop(x, 0.5, gen), x)

    from gantts_tpu_torch.models import _dropout

    d = _dropout(torch.ones(50, 6, 40), 0.5, True, gen)
    assert set(d.unique().tolist()) == {0.0, 2.0}
    assert not torch.equal(d, d[:1].expand_as(d))


@pytest.mark.parametrize("name,kw", [
    ("SRURNN", dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
                    bidirectional=True, use_relu=1)),
    ("MLP", dict(in_dim=483, out_dim=1, num_hidden=3, hidden_dim=16)),
    ("LSTMRNN", dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
                     bidirectional=True)),
    ("GRURNN", dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=16,
                    bidirectional=False)),
])
def test_converter_round_trip_is_bit_exact(name, kw):
    from gantts_tpu.models import create_model as jax_create_model

    T = 16
    x = jnp.zeros((1, T, kw["in_dim"]), jnp.float32)
    variables = jax_create_model(name, **kw).init(
        jax.random.PRNGKey(3), x, jnp.full((1,), T, jnp.int32))
    model = create_model(name, **kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    back = convert.torch_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_registry_builds_every_model():
    """No model is left unported: every name of the registry builds a
    module, the In2Out generators too (they apply MLPG themselves), and an
    unknown name is refused."""
    from gantts_tpu_torch.models import (
        MODEL_REGISTRY,
        include_parameter_generation,
    )

    for name in MODEL_REGISTRY:
        model = create_model(name, in_dim=6, out_dim=6)
        assert isinstance(model, torch.nn.Module), name
        assert include_parameter_generation(model) == name.startswith(
            "In2Out"), name
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("Nope")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_matmul_cast_bf16_matches_jax(x_dtype):
    """bf16 operands, f32 output; dx in x's dtype, dW in f32.  The products
    of bf16 operands are exact in f32, so only the summation order differs:
    1e-6 of scale.  A bf16 dx is one rounding of those sums, which agrees
    unless a sum lands within its last bits of a rounding boundary: one
    bf16 step, 2^-8, of scale."""
    rs = np.random.RandomState(8)
    x = rs.randn(3, 7, 40).astype(np.float32)
    w = (rs.randn(40, 24) * 0.2).astype(np.float32)
    gy = rs.randn(3, 7, 24).astype(np.float32)
    jx = jnp.asarray(x, x_dtype)
    tx = torch.tensor(np.asarray(jx, np.float32)).to(getattr(torch, x_dtype))
    (y_ref, (dx_ref, dw_ref)), (y, (dx, dw)) = _vjp_both(
        lambda a, b: jax_matmul_cast(a, b, "bfloat16"),
        lambda a, b: matmul_cast(a, b, "bfloat16"),
        (jx, jnp.asarray(w)),
        (tx.requires_grad_(True), torch.tensor(w, requires_grad=True)), gy)
    assert y_ref.dtype == jnp.float32 and y.dtype == torch.float32
    assert dx_ref.dtype == jnp.dtype(x_dtype)
    assert dx.dtype == getattr(torch, x_dtype)
    assert dw_ref.dtype == jnp.float32 and dw.dtype == torch.float32
    assert _rel(y, y_ref) < 1e-6
    assert _rel(dx.float(), dx_ref) < (2.0 ** -8 if x_dtype == "bfloat16"
                                       else 1e-6)
    assert _rel(dw, dw_ref) < 1e-6


def test_mlp_bf16_matches_jax():
    """The 3x256 discriminator on the acoustic D input width (483), bf16
    matmuls: output and every gradient.  Each hidden activation is cast to
    bf16 before the next matmul; where the two f32 sums before it differ in
    their last bits the cast can land one bf16 step (2^-8) apart for an
    element, and that element's share reaches the sums after it.  Limits:
    output 1e-4 of scale, gradients 1e-3 of each tensor's scale."""
    kw = dict(in_dim=483, out_dim=1, num_hidden=3, hidden_dim=256,
              dropout=0.5, last_sigmoid=True, compute_dtype="bfloat16")
    x, _ = _batch(9, 4, 30, 483)
    jm = JaxMLP(**kw)
    variables = jm.init(jax.random.PRNGKey(9), jnp.asarray(x))
    gy = np.random.RandomState(10).randn(4, 30, 1).astype(np.float32)
    model = _port(MLP, variables, **kw)
    tx = torch.tensor(x, requires_grad=True)
    (y_ref, (gv, dx_ref)), (y, (dx,)) = _vjp_both(
        lambda v, a: jm.apply(v, a), lambda a: model(a),
        (variables, jnp.asarray(x)), (tx,), gy)
    assert y.dtype == torch.float32
    assert _rel(y, y_ref) < 1e-4
    assert _rel(dx, dx_ref) < 1e-3
    ref = convert.flax_to_torch(gv)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        assert _rel(p.grad, ref[name]) < 1e-3, name


def test_srurnn_bf16_matches_jax():
    """2-layer bidirectional relu SRU (H=32, acoustic in/out widths) with
    bf16 compute against the JAX package's bf16 path, its Pallas kernels in
    interpret mode: output, dx and every parameter gradient for one output
    cotangent.  u, h and du are stored in bf16 by both, so a value whose f32
    sum differs in the last bits can round one bf16 step (2^-8) apart.
    Limits, as tests/test_kernels.py's for one bf16 layer: output and dx
    1e-2 of scale; parameter gradients 1e-3 of scale, ten times that file's
    1e-4, because the lower layer's cotangent arrives through the upper
    layer's bf16 dx.  The JAX CPU fallback, which keeps u in f32, is
    2e-3 to 8e-2 of scale away on these gradients."""
    kw = dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
              bidirectional=True, use_relu=1, compute_dtype="bfloat16")
    x, lengths = _batch(11, 3, 40, 425)
    jm = JaxSRURNN(**kw)
    variables = jm.init(jax.random.PRNGKey(11), jnp.asarray(x),
                        jnp.asarray(lengths))
    gy = np.random.RandomState(12).randn(3, 40, 187).astype(np.float32)
    model = _port(SRURNN, variables, **kw)
    tx = torch.tensor(x, requires_grad=True)
    with mock.patch.object(jax_kernels, "default_use_pallas", lambda: True):
        (y_ref, (gv, dx_ref)), (y, (dx,)) = _vjp_both(
            lambda v, a: jm.apply(v, a, jnp.asarray(lengths)),
            lambda a: model(a, torch.tensor(lengths)),
            (variables, jnp.asarray(x)), (tx,), gy)
    assert y.dtype == torch.float32 and dx.dtype == torch.float32
    assert _rel(y, y_ref) < 1e-2
    assert _rel(dx, dx_ref) < 1e-2
    ref = convert.flax_to_torch(gv)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        assert _rel(p.grad, ref[name]) < 1e-3, name


def test_bf16_compute_tracks_f32():
    """The same weights with bf16 matmuls (f32 accumulation, f32 recurrence
    state) stay within bf16 rounding of the f32 model.  A coarse bound on
    the port against itself; the bf16 tests above hold it to JAX."""
    kw = dict(in_dim=425, out_dim=187, num_hidden=2, hidden_dim=32,
              bidirectional=True, use_relu=1)
    x, lengths = _batch(4, 2, 24, 425)
    gen = torch.Generator()
    gen.manual_seed(4)
    m32 = SRURNN(generator=gen, **kw).eval()
    m16 = SRURNN(compute_dtype="bfloat16", **kw).eval()
    m16.load_state_dict(m32.state_dict())
    y32 = m32(torch.tensor(x), torch.tensor(lengths)).detach()
    y16 = m16(torch.tensor(x), torch.tensor(lengths)).detach()
    assert y16.dtype == torch.float32
    assert (y16 - y32).abs().max() < 0.05 * max(y32.abs().max(), 1)
