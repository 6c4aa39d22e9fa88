"""The slice as a whole: one tts_acoustic GAN training step in both packages
from identical converted states, on the same numpy batch.

Small tts_acoustic: the real stream layout [180, 3, 1, 3], a 2x32
bidirectional relu SRU generator, a 2x16 MLP discriminator on
[linguistic | mgc statics 2..59], B=3, T=40, dropout off, adv_w = w_d =
mge_w = mse_w = 1, Adagrad (lr 0.01, weight decay 1e-7) after the
global-norm clip at 1.0.  Each comparison runs in float32 and in bfloat16
compute; the JAX package's bf16 path is its Pallas kernels (u and h stored
in bf16), run here in interpret mode, since its CPU fallback keeps u in f32.

Optimizer.  The port runs torch.optim's Adagrad, the reference's optimizer:
lr g / (sqrt(sum g^2) + eps).  The JAX package's own (optax
``scale_by_rss``) puts eps inside the square root, lr g / sqrt(sum g^2 +
eps).  The two agree where |g| >> sqrt(eps) = 1e-5 and part where |g| is
near or below it, as many clipped gradients of this step are: there the
first step differs by up to lr.  ``test_step_updates_match_jax`` takes the
step with the package's own optimizer and holds the port to it, gap
included.  The loss comparison gives the JAX step torch's rule instead
(written here as an optax transformation), because the adversarial loss is
taken through the just-updated discriminator and so would carry the gap.

Tolerances:
  * every loss and count at rtol 1e-5 (different summation orders; in bf16
    both store the same roundings of u and h, and a value that rounds one
    bf16 step apart moves a loss averaged over its frames by far less);
    ``vuv_err`` and ``f0_rmse`` threshold at 0.5, so they may differ by
    one frame's share when a decision flips on rounding;
  * gradients before the optimizer at 1e-4 of each tensor's largest entry:
    they pass through two scans, MLPG and the discriminator, summed in
    other orders;
  * updated parameters: see ``test_step_updates_match_jax``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import gantts_tpu.kernels as jax_kernels
from gantts_tpu import hparams as jax_hparams
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train.setup import init_models_and_states as jax_init
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert
from gantts_tpu_torch import hparams
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.train import GanTrainer, StepConfig, TrainState
from gantts_tpu_torch.train.setup import init_models_and_states

torch.set_num_threads(1)

B, T, LIN = 3, 40, 425
STEP_KW = dict(w_d=1.0, mse_w=1.0, mge_w=1.0, update_d=True, update_g=True)


def _hp(module, compute_dtype="float32"):
    hp = module.tts_acoustic.copy()
    hp.compute_dtype = compute_dtype
    hp.generator_params.update(in_dim=LIN, out_dim=187, num_hidden=2,
                               hidden_dim=32, dropout=0.0, rnn_dropout=0.0)
    hp.discriminator_params.update(in_dim=60 - 2 + LIN, num_hidden=2,
                                   hidden_dim=16, dropout=0.0)
    return hp


def _batch():
    rs = np.random.RandomState(0)
    x = rs.rand(B, T, LIN).astype(np.float32)
    y = rs.randn(B, T, 187).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    Y_mean = (rs.randn(187) * 0.1).astype(np.float32)
    Y_std = (rs.rand(187) + 0.5).astype(np.float32)
    Y_mean[183], Y_std[183] = 2.0, 1.0  # mostly voiced: f0_rmse is defined
    R = unit_variance_mlpg_matrix(_hp(hparams).windows, T)
    return x, y, lengths, R, Y_mean, Y_std


def _grad_capture():
    """optax transformation that leaves the parameters alone and keeps the
    incoming gradients as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def _torch_adagrad(lr, weight_decay):
    """torch.optim.Adagrad's rule (accumulator from 0, eps after the square
    root) after the clip and the non-decoupled weight decay."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, sum_sq, params=None):
        sum_sq = jax.tree_util.tree_map(lambda g, s: s + g * g, grads, sum_sq)
        return jax.tree_util.tree_map(
            lambda g, s: g / (jnp.sqrt(s) + 1e-10), grads, sum_sq), sum_sq
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.add_decayed_weights(weight_decay),
                       optax.GradientTransformation(init, update),
                       optax.scale(-lr))


def _torch_rule(name, params, package_tx):
    """The JAX-side optimizer that follows torch's rule: Adagrad written
    out by ``_torch_adagrad``; the package's own Adam already is torch's
    (eps after the square root), so ``package_tx`` is kept."""
    return _torch_adagrad(**params) if name == "Adagrad" else package_tx


class _GradCapture:
    """torch counterpart: ``step`` records the gradients, updates nothing."""

    def __init__(self, module):
        self.module, self.grads = module, None

    def zero_grad(self):
        self.module.zero_grad(set_to_none=True)

    def step(self):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.module.named_parameters()}


_CACHE = {}


def _run_both(optimizer, compute_dtype="float32", hp_fn=_hp,
              batch_fn=_batch):
    """Both packages take one training step; cached per case because the
    JAX step compiles for each.  ``optimizer``: "capture" (no update, the
    gradients kept), "torch_rule" (JAX with torch's rule, see
    ``_torch_rule``) or "package" (JAX with its own ``create_optimizer``,
    adv_w = 0).  ``hp_fn(hparams_module, compute_dtype)`` gives the
    configuration, ``batch_fn()`` its batch (R is None where no stream has
    dynamic features)."""
    key = (optimizer, compute_dtype, hp_fn, batch_fn)
    if key not in _CACHE:
        _CACHE[key] = _step_both(optimizer, compute_dtype, hp_fn, batch_fn)
    return _CACHE[key]


def _step_both(optimizer, compute_dtype, hp_fn, batch_fn):
    x, y, lengths, R, Y_mean, Y_std = batch_fn()
    jhp = hp_fn(jax_hparams, compute_dtype)
    model_g, model_d, tx_g, tx_d, jg, jd = jax_init(jhp, seed=0)
    if optimizer == "capture":
        tx_g, tx_d = _grad_capture(), _grad_capture()
    elif optimizer == "torch_rule":
        tx_g = _torch_rule(jhp.optimizer_g, jhp.optimizer_g_params, tx_g)
        tx_d = _torch_rule(jhp.optimizer_d, jhp.optimizer_d_params, tx_d)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    jtr = JaxTrainer(model_g, model_d, tx_g, tx_d,
                     JaxConfig.from_hparams(jhp, **STEP_KW), Y_mean, Y_std,
                     windows=jhp.windows)
    # host copies: the JAX step donates its input states
    g0, d0 = jax.tree_util.tree_map(np.array, (jg.params, jd.params))

    hp = hp_fn(hparams, compute_dtype)
    mg, md, _, _, tg, td = init_models_and_states(hp, seed=0, device="cpu")
    mg.load_state_dict(convert.flax_to_torch(g0), strict=True)
    md.load_state_dict(convert.flax_to_torch(d0), strict=True)
    if optimizer == "capture":
        tg, td = TrainState(mg, _GradCapture(mg)), TrainState(md,
                                                              _GradCapture(md))
    tr = GanTrainer(StepConfig.from_hparams(hp, **STEP_KW), Y_mean, Y_std,
                    "cpu", windows=hp.windows)

    # The package's optimizer updates D differently from torch's (see the
    # module docstring); with adv_w = 0 G's gradient does not pass through
    # the updated D, so both G updates start from the same gradient.
    adv_w = 0.0 if optimizer == "package" else 1.0
    pallas = compute_dtype == "bfloat16"
    with mock.patch.object(jax_kernels, "default_use_pallas",
                           lambda: pallas):
        jg, jd, jout, _ = jtr.step_fn(True)(
            jg, jd, None, jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(lengths), None if R is None else jnp.asarray(R),
            None, jnp.float32(adv_w), jax.random.PRNGKey(0))
    tg, td, out = tr.step(tg, td, torch.tensor(x), torch.tensor(y),
                          torch.tensor(lengths),
                          None if R is None else torch.tensor(R), adv_w)
    return (jg, jd, jout), (tg, td, out), (g0, d0), int(lengths.sum())


def _check_outputs(jout, out, n_frames):
    """Every output within 1e-5 of the JAX step's, but where a V/UV
    decision flipped: vuv_err then differs by at most one frame's share,
    and f0_rmse, taken over other frames, is excused.  An f0_rmse gap with
    vuv_err equal on both sides is a fault."""
    assert set(out) == set(jout)
    flipped = "vuv_err" in jout and abs(
        float(out["vuv_err"]) - float(jout["vuv_err"])) > 1e-5 * abs(
            float(jout["vuv_err"]))
    for k in jout:
        a, b = float(out[k]), float(jout[k])
        assert np.isfinite(b), k
        if flipped and k == "vuv_err":
            assert abs(a - b) <= 1.0 / n_frames + 1e-6, k
            continue
        if flipped and k == "f0_rmse":
            continue
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-3), (k, a, b)


def test_step_outputs_match_jax():
    (_, _, jout), (_, _, out), _, n = _run_both("torch_rule")
    assert float(out["num_frames"]) == n
    _check_outputs(jout, out, n)


def test_step_bf16_outputs_match_jax():
    (_, _, jout), (_, _, out), _, n = _run_both("torch_rule", "bfloat16")
    assert float(out["num_frames"]) == n
    _check_outputs(jout, out, n)


def test_eval_step_updates_nothing():
    """``train=False``: same pre-update losses as the training step, no
    gradient, parameters untouched."""
    x, y, lengths, R, Y_mean, Y_std = _batch()
    hp = _hp(hparams)
    mg, md, _, _, tg, td = init_models_and_states(hp, seed=0, device="cpu")
    before = {k: v.clone() for k, v in mg.state_dict().items()}
    tr = GanTrainer(StepConfig.from_hparams(hp, **STEP_KW), Y_mean, Y_std,
                    "cpu")
    args = (torch.tensor(x), torch.tensor(y), torch.tensor(lengths),
            torch.tensor(R), 1.0)
    _, _, ev = tr.step(tg, td, *args, train=False)
    assert all(torch.equal(v, before[k]) for k, v in mg.state_dict().items())
    assert all(p.grad is None for p in mg.parameters())
    _, _, out = tr.step(tg, td, *args)
    for k in ("discriminator", "mge", "mse", "mcd", "vuv_err"):
        assert float(ev[k]) == float(out[k]), k


def _check_gradients(compute_dtype, hp_fn=_hp, batch_fn=_batch,
                     tol=lambda name: 1e-4):
    """``tol(name)``: the limit of a parameter's gradient, as a share of
    its largest entry."""
    (jg, jd, jout), (tg, td, out), _, n = _run_both("capture", compute_dtype,
                                                    hp_fn, batch_fn)
    _check_outputs(jout, out, n)
    for jstate, tstate in ((jg, tg), (jd, td)):
        ref = convert.flax_to_torch(jstate.opt_state)
        got = tstate.optimizer.grads
        assert set(got) == set(ref)
        for name, g in got.items():
            assert g.dtype == torch.float32, name
            r = ref[name].numpy()
            scale = np.abs(r).max()
            assert scale > 0, name
            assert np.abs(g.numpy() - r).max() <= tol(name) * scale, name


def test_step_gradients_match_jax():
    """G and D gradients before the optimizer (and before the clip)."""
    _check_gradients("float32")


def test_step_bf16_gradients_match_jax():
    _check_gradients("bfloat16")


def _sum_of_squares(opt_state):
    """The Adagrad accumulator in the JAX package's optimizer state."""
    found = [s.sum_of_squares for s in opt_state.inner_state
             if hasattr(s, "sum_of_squares")]
    assert len(found) == 1
    return convert.flax_to_torch(found[0])


def _check_updates(compute_dtype, hp_fn=_hp, noise_level=1e-5,
                   batch_fn=_batch):
    """Clip + weight decay + Adagrad against the JAX package's own optimizer,
    in a step with adv_w = 0 (D still takes its full update).

    After one step the package's accumulator holds g^2 of the clipped,
    decayed gradient g, so |g| is read from it and sign(g) from the
    package's own update.  Where |g| > 1e-3 = 100 sqrt(eps) the two rules
    agree to lr eps / (2 g^2) <= 5e-7, and the parameters must agree to
    1e-6.  Wherever g is not rounding noise (|g| > 1e-5 max|g|; Adagrad's
    first step is about +-lr whatever |g|, so a noise-level gradient may
    move the other way) the difference must be the eps-placement gap
    lr sign(g) (|g| / sqrt(g^2 + eps) - |g| / (|g| + eps)).  Its limit is
    1e-6 plus what a gradient difference at the noise level, 1e-5 max|g|
    (``noise_level``), moves the package's update by: its slope in g is
    lr eps / (g^2 + eps)^(3/2), up to lr / sqrt(eps) near g = 0, while
    torch's rule is flat there.  The gap is at most lr, and at this step it
    reaches more than half of lr."""
    (jg, jd, _), (tg, td, _), (g0, d0), _ = _run_both(
        "package", compute_dtype, hp_fn, batch_fn)
    lr = hp_fn(hparams, "float32").optimizer_g_params["lr"]
    assert lr == hp_fn(hparams, "float32").optimizer_d_params["lr"]
    eps, largest_gap, n_far = 1e-10, 0.0, 0
    for jstate, p0, tstate in ((jg, g0, tg), (jd, d0, td)):
        ref = convert.flax_to_torch(jstate.params)
        start = convert.flax_to_torch(p0)
        g_abs = {k: np.sqrt(v.numpy())
                 for k, v in _sum_of_squares(jstate.opt_state).items()}
        for name, p in tstate.model.named_parameters():
            g, r = g_abs[name], ref[name].numpy()
            diff = p.detach().numpy() - r
            sign = np.sign(start[name].numpy() - r)
            gap = lr * sign * (g / np.sqrt(g * g + eps) - g / (g + eps))
            far = g > 1e-3
            n_far += int(far.sum())
            if far.any():
                assert np.abs(diff[far]).max() <= 1e-6, name
            noise = noise_level * g.max()
            sel = g > noise
            assert sel.mean() > 0.5, name
            slope = lr * eps / (g * g + eps) ** 1.5
            assert (np.abs(diff - gap) <= 1e-6 + slope * noise)[sel].all(), \
                name
            largest_gap = max(largest_gap, float(np.abs(gap[sel]).max()))
    assert n_far > 1000
    assert largest_gap > 0.5 * lr


def test_step_updates_match_jax():
    _check_updates("float32")


def test_step_bf16_updates_match_jax():
    _check_updates("bfloat16")
