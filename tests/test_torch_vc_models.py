"""The port's In2Out generators (the VC bundle's) against the JAX package's,
from weights converted out of JAX ``init``, dropout off.

Configuration: the delta windows of the vc bundle, S = 8 static dims (in =
out = 24), two hidden layers of 16 (the MLP trunk) or a 2x16
unidirectional LSTM trunk, B = 3.  R is either the dense matrix at T = 40
with ragged lengths, or the ``MLPGStencil`` operator at T = 128 with lengths
of at least 98 (4*24+2) and zero padding past them.  Both returns and every
parameter gradient are compared for one cotangent per return.

Tolerances, those of the JAX package's own model tests and of
tests/test_torch_lstm.py for the LSTM trunk: float32 outputs atol 1e-5,
input and parameter gradients 1e-5 of scale; bfloat16 (JAX runs its Pallas
LSTM kernels in interpret mode, as tests/test_kernels.py does) outputs and
dx 1e-2 of scale, parameter gradients 5e-3 of scale.  The stencil and the
dense R agree to about 1e-6 (tests/test_torch_fast_mlpg.py), under these.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gantts_tpu.kernels as jax_kernels
from gantts_tpu import hparams as jax_hparams
from gantts_tpu.core.fast_mlpg import MLPGStencil as JaxStencil
from gantts_tpu.models import create_model as jax_create
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.core.fast_mlpg import MLPGStencil
from gantts_tpu_torch.core.masking import masked_mse_loss
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.models import MLP, create_model

torch.set_num_threads(1)

S, Bm = 8, 3
WINDOWS = hparams.vc.windows
KW = {"In2OutHighwayNet": dict(num_hidden=2, hidden_dim=16),
      "In2OutRNNHighwayNet": dict(num_hidden=2, hidden_dim=16,
                                  bidirectional=False)}
CASES = {"dense": (40, [40, 31, 22]), "stencil": (128, [128, 113, 98])}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _case(name, cd, mode, seed=3):
    T, lengths = CASES[mode]
    lengths = np.asarray(lengths, np.int32)
    kw = dict(in_dim=3 * S, out_dim=3 * S, static_dim=S, dropout=0.0,
              compute_dtype=cd, **KW[name])
    rs = np.random.RandomState(seed)
    x = rs.randn(Bm, T, 3 * S).astype(np.float32)
    x *= (np.arange(T)[None, :, None] < lengths[:, None, None])
    g1 = rs.randn(Bm, T, 3 * S).astype(np.float32)
    g2 = rs.randn(Bm, T, S).astype(np.float32)
    if mode == "dense":
        R = unit_variance_mlpg_matrix(WINDOWS, T)
        jR, tR = jnp.asarray(R), torch.tensor(R)
    else:
        jR = JaxStencil.create(jax_hparams.vc.windows)
        tR = MLPGStencil.create(WINDOWS)
    jm = jax_create(name, **kw)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jR,
                        jnp.asarray(lengths))
    with mock.patch.object(jax_kernels, "default_use_pallas",
                           lambda: cd == "bfloat16"):
        (f_ref, y_ref), vjp = jax.vjp(
            lambda v, a: jm.apply(v, a, jR, jnp.asarray(lengths)),
            variables, jnp.asarray(x))
        gv, dx_ref = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    model = create_model(name, **kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    model.eval()
    tx = torch.tensor(x, requires_grad=True)
    first, y = model(tx, tR, torch.tensor(lengths))
    torch.autograd.backward((first, y), (torch.tensor(g1), torch.tensor(g2)))
    return ((np.asarray(f_ref), np.asarray(y_ref), np.asarray(dx_ref),
             convert.flax_to_torch(gv)), (first, y, tx, model, lengths))


@pytest.mark.parametrize("mode", ["dense", "stencil"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["In2OutHighwayNet", "In2OutRNNHighwayNet"])
def test_in2out_models_match_jax(name, cd, mode):
    (f_ref, y_ref, dx_ref, g_ref), (first, y, tx, model, lengths) = _case(
        name, cd, mode)
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    if cd == "float32":
        out_tol, g_tol = 1e-5, 1e-5
        assert np.abs(y.detach().numpy() - y_ref).max() < out_tol
        assert np.abs(first.detach().float().numpy() - f_ref).max() < out_tol
    else:
        out_tol, g_tol = 1e-2, 5e-3
        assert _rel(y.detach().numpy(), y_ref) < out_tol
        assert _rel(first.detach().float().numpy(), f_ref) < out_tol
    assert _rel(tx.grad.numpy(), dx_ref) < out_tol
    for n, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, n
        assert _rel(p.grad.numpy(), g_ref[n].numpy()) < g_tol, n
    if mode == "stencil":  # the operator zeroes the padding
        T = y.shape[1]
        pad = np.arange(T)[None, :] >= lengths[:, None]
        assert (y.detach().numpy()[pad] == 0).all()


def test_in2out_first_returns_keep_the_reference_quirks():
    """In2OutHighwayNet returns its pre-MLPG ``last_linear`` output first
    (recomputed by hand here); In2OutRNNHighwayNet returns its input, the
    very tensor."""
    (_, _, _, _), (first, _, tx, model, _) = _case(
        "In2OutHighwayNet", "float32", "dense")
    h = tx.detach()
    for i in range(2):
        layer = getattr(model, f"H_{i}")
        h = torch.nn.functional.leaky_relu(h @ layer.kernel + layer.bias,
                                           0.01)
    h = h @ model.last_linear.kernel + model.last_linear.bias
    assert torch.allclose(first.detach(), h, atol=1e-6)
    (_, _, _, _), (first, _, tx, _, _) = _case(
        "In2OutRNNHighwayNet", "float32", "dense")
    assert first is tx


def test_in2out_mse_term_gradient_semantics():
    """An MSE term on the first return trains the MLP variant's trunk and
    gives the RNN variant's parameters no gradient at all."""
    T, lengths = CASES["dense"]
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.rand(Bm, T, 3 * S).astype(np.float32))
    y_tgt = torch.tensor(rs.rand(Bm, T, 3 * S).astype(np.float32))
    R = torch.tensor(unit_variance_mlpg_matrix(WINDOWS, T))
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None])
    norms = {}
    for name in KW:
        model = create_model(name, in_dim=3 * S, out_dim=3 * S,
                             static_dim=S, **KW[name])
        y_hat, _ = model(x, R, torch.tensor(lengths))
        loss = masked_mse_loss(y_hat, y_tgt, mask=mask[..., None])
        params = list(model.parameters())
        if not loss.requires_grad:
            norms[name] = 0.0
            continue
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        norms[name] = sum(float(g.abs().sum()) for g in grads
                          if g is not None)
    assert norms["In2OutHighwayNet"] > 0
    assert norms["In2OutRNNHighwayNet"] == 0.0


def test_in2out_dropout_is_per_element_between_trunk_layers():
    """Training mode draws per-element masks from the caller's generator
    after every hidden layer of the MLP trunk; eval mode draws none, and
    the same generator state gives the same output."""
    model = create_model("In2OutHighwayNet", in_dim=3 * S, out_dim=3 * S,
                         static_dim=S, num_hidden=2, hidden_dim=16,
                         dropout=0.5)
    T = 20
    x = torch.rand(2, T, 3 * S)
    R = torch.tensor(unit_variance_mlpg_matrix(WINDOWS, T))
    gen = torch.Generator()
    outs = []
    for _ in range(2):
        gen.manual_seed(0)
        outs.append(model.train()(x, R, generator=gen)[1])
    assert torch.equal(outs[0], outs[1])
    gen.manual_seed(1)
    assert not torch.equal(model(x, R, generator=gen)[1], outs[0])
    ev1 = model.eval()(x, R, generator=gen)[1]
    assert torch.equal(ev1, model(x, R)[1])


def test_vc_bundle_parameter_counts():
    """The vc bundle at full width (in = out = 177, static 59, 3 x 512,
    the 59 -> 2x256 -> 1 discriminator), counted from the modules."""
    hp = hparams.vc.copy()
    gp = dict(hp.generator_params, in_dim=177, out_dim=177)

    def count(m):
        return sum(p.numel() for p in m.parameters())
    assert count(create_model("In2OutHighwayNet", **gp)) == 710_789
    rnn = dict(gp, bidirectional=False)
    assert count(create_model("In2OutRNNHighwayNet", **rnn)) == 5_712_005
    assert count(MLP(**hp.discriminator_params)) == 81_409
