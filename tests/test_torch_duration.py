"""The tts_duration stage on the port: its Adam against the JAX package's
optax chain, and one tts_duration GAN training step in both packages from
identical converted states on the same numpy batch.

Small tts_duration: the bundle's stream layout (5 durations, static only:
one window, so MLPG passes the stream through and no R is built), a 2x32
bidirectional relu SRU generator on 416 phone-level inputs, a 2x16 MLP
discriminator conditioned on them (416 + 5 = 421 inputs), Adam (lr 1e-3,
betas (0.5, 0.9)) after the global-norm clip, B=3, T=40, dropout off.  Each
comparison runs in float32 and in bfloat16 compute (the JAX package's
Pallas kernels in interpret mode) through tests/test_torch_step.py's
helpers, at that file's tolerances; the distortion metric is ``dur_rmse``.

Adam.  torch's rule and the package's are the same, eps after the square
root: lr m_hat / (sqrt(v_hat) + eps).  What differs is the clip: torch
scales by 1 / (||g|| + 1e-6), optax by 1 / ||g||, about 1e-6 relative on a
clipped step, which Adam's update, nearly invariant to the gradient's
scale, carries at most as lr 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_step import (
    B,
    T,
    _check_gradients,
    _check_outputs,
    _run_both,
)

from gantts_tpu import hparams as jax_hparams
from gantts_tpu.train import optim as jax_optim
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.train.optim import create_optimizer

torch.set_num_threads(1)

PHONE_DIM, DUR_DIM = 416, 5


def _dur_hp(module, compute_dtype="float32"):
    hp = module.tts_duration.copy()
    hp.compute_dtype = compute_dtype
    hp.generator_params.update(in_dim=PHONE_DIM, out_dim=DUR_DIM,
                               num_hidden=2, hidden_dim=32, dropout=0.0,
                               rnn_dropout=0.0)
    hp.discriminator_params.update(in_dim=PHONE_DIM + DUR_DIM, num_hidden=2,
                                   hidden_dim=16, dropout=0.0)
    return hp


def _dur_batch():
    """Phone features in [0, 1), normalized durations, ragged lengths, and
    duration stats with the scale of frame counts; no R."""
    rs = np.random.RandomState(0)
    x = rs.rand(B, T, PHONE_DIM).astype(np.float32)
    y = rs.randn(B, T, DUR_DIM).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    Y_mean = (rs.rand(DUR_DIM) * 4 + 2).astype(np.float32)
    Y_std = (rs.rand(DUR_DIM) + 0.5).astype(np.float32)
    return x, y, lengths, None, Y_mean, Y_std


def test_duration_bundle_is_the_packages():
    """The configuration under test: static durations, one window, Adam with
    the bundle's betas, a conditioned discriminator, in both packages."""
    for mod in (hparams, jax_hparams):
        hp = _dur_hp(mod)
        assert hp.name == "duration" and list(hp.stream_sizes) == [5]
        assert list(hp.has_dynamic_features) == [False]
        assert len(hp.windows) == 1 and hp.discriminator_linguistic_condition
        assert hp.optimizer_g == hp.optimizer_d == "Adam"
        assert tuple(hp.optimizer_g_params["betas"]) == (0.5, 0.9)
        assert hp.batch_size == 32


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_adam_matches_jax(weight_decay):
    """Adam behind the global-norm clip: three steps from the same gradients
    (norms about 0.45, 13 and 2.2: the clip idle, then engaged twice) agree
    with the JAX package's optax chain to f32 rounding (atol 1e-7, as
    SGD's)."""
    rs = np.random.RandomState(3)
    p0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) * s for s in (0.1, 3.0, 0.5)]
    norms = [float(np.linalg.norm(g)) for g in grads]
    assert norms[0] < 1.0 < min(norms[1:])
    kw = dict(lr=1e-3, betas=(0.5, 0.9), weight_decay=weight_decay)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = create_optimizer("Adam", kw, [p])
    tx = jax_optim.create_optimizer("Adam", kw)
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        upd, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = jp + upd
        assert np.abs(p.detach().numpy() - np.asarray(jp)).max() < 1e-7
    # Adam moves an element by up to about lr a step: atol 1e-7 is 1e-4 of
    # what the rule moves
    assert np.abs(p.detach().numpy() - p0).max() > 2e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_duration_step_outputs_match_jax(compute_dtype):
    """Losses, counts and ``dur_rmse`` (the duration model's distortion
    metric, in frames) at rtol 1e-5; the adversarial loss through the
    discriminator that both packages' Adam just updated."""
    (_, _, jout), (_, _, out), _, n = _run_both(
        "torch_rule", compute_dtype, _dur_hp, _dur_batch)
    assert float(out["num_frames"]) == n
    assert {"dur_rmse", "loss_adv", "discriminator"} <= set(out)
    assert not {"mcd", "f0_rmse"} & set(out)
    _check_outputs(jout, out, n)
    assert float(out["dur_rmse"]) > 0.1


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_duration_step_gradients_match_jax(compute_dtype):
    """G and D gradients before the clip, at 1e-4 of each tensor's
    largest entry."""
    _check_gradients(compute_dtype, _dur_hp, _dur_batch)


def _adam_moments(opt_state):
    """The first moment in the JAX package's Adam state."""
    found = [s.mu for s in opt_state.inner_state if hasattr(s, "mu")]
    assert len(found) == 1
    return convert.flax_to_torch(found[0])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_duration_step_updates_match_jax(compute_dtype, noise_level=1e-5):
    """Clip + Adam against the JAX package's own optimizer, in a step with
    adv_w = 0 (D still takes its full update).

    After one step Adam's first moment is (1 - b1) g, so the clipped
    gradient g is read from the package's state, and both packages move
    each parameter by lr g / (|g| + eps), about lr sign(g).  Where
    |g| > 1e-3 the parameters must agree to 1e-6.  Wherever g is not
    rounding noise (|g| > 1e-5 max|g|: a noise-level gradient may take the
    other sign) the limit is 1e-6 plus what a gradient difference at the
    noise level moves the update by, its slope in g being
    lr eps / (|g| + eps)^2."""
    (jg, jd, _), (tg, td, _), (g0, d0), _ = _run_both(
        "package", compute_dtype, _dur_hp, _dur_batch)
    hp = _dur_hp(hparams)
    lr, (b1, _) = hp.optimizer_g_params["lr"], hp.optimizer_g_params["betas"]
    assert hp.optimizer_d_params["lr"] == lr
    eps, n_far = 1e-8, 0
    for jstate, p0, tstate in ((jg, g0, tg), (jd, d0, td)):
        ref = convert.flax_to_torch(jstate.params)
        start = convert.flax_to_torch(p0)
        grads = {k: v.numpy() / (1 - b1)
                 for k, v in _adam_moments(jstate.opt_state).items()}
        for name, p in tstate.model.named_parameters():
            g, r = grads[name], ref[name].numpy()
            diff = p.detach().numpy() - r
            moved = start[name].numpy() - r
            g_abs = np.abs(g)
            far = g_abs > 1e-3
            n_far += int(far.sum())
            if far.any():
                assert np.abs(diff[far]).max() <= 1e-6, name
                assert np.abs(moved[far] - lr * np.sign(g[far])).max() \
                    <= 1e-6, name
            noise = noise_level * g_abs.max()
            sel = g_abs > noise
            assert sel.mean() > 0.5, name
            slope = lr * eps / (g_abs + eps) ** 2
            assert (np.abs(diff) <= 1e-6 + slope * noise)[sel].all(), name
    assert n_far > 1000
