"""The GAN training step of the vc bundle, with both In2Out generators, and
a generic generator's step with ``mlpg_impl="stencil"``: each package takes
one step from identical converted states on the same numpy batch.

vc configuration: the bundle's windows, streams and 1-stream adversarial
loss at S = 8 static dims (in = out = 24, order 8), an In2Out generator
with two hidden layers of 32 (the MLP trunk, or a 2x32 unidirectional LSTM
trunk), the unconditioned MLP discriminator on the 8 statics (2x16), B=3,
T=40, dense R, dropout off, Adagrad lr 0.01 after the global-norm clip; and
mse_w = mge_w = w_d = 1, so In2OutHighwayNet's MSE term trains its trunk
and In2OutRNNHighwayNet's has no gradient.  float32 runs JAX's CPU path,
bfloat16 its Pallas LSTM kernels in interpret mode.  The tolerances and the
optimizer comparison are tests/test_torch_step.py's, whose helpers run both
steps.

Stencil: that file's small tts_acoustic (2x32 bidirectional SRU, the real
stream layout) at T = 112, past the stencil's 98-frame floor, where both
trainers take ``multi_stream_mlpg_stencil`` from their windows.

``has_ref``: the vc bundle's discriminator reads the static mel-cepstra
alone, so a reference discriminator (other weights, converted) gives the
spoofing count exactly as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step import (
    STEP_KW,
    _check_gradients,
    _check_outputs,
    _check_updates,
    _hp,
    _run_both,
    _torch_adagrad,
)

from gantts_tpu import hparams as jax_hparams
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train.setup import init_models_and_states as jax_init
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.models import MLP
from gantts_tpu_torch.train import GanTrainer, StepConfig
from gantts_tpu_torch.train.setup import init_models_and_states

torch.set_num_threads(1)

S, B, T = 8, 3, 40
GENERATORS = ["In2OutHighwayNet", "In2OutRNNHighwayNet"]


def _vc_hp(generator):
    def hp_fn(module, compute_dtype="float32"):
        hp = module.vc.copy()
        hp.compute_dtype = compute_dtype
        hp.order = S
        hp.stream_sizes = [3 * S]
        hp.generator = generator
        hp.generator_params = dict(in_dim=3 * S, out_dim=3 * S, static_dim=S,
                                   num_hidden=2, hidden_dim=32, dropout=0.0)
        hp.discriminator_params.update(in_dim=S, num_hidden=2, hidden_dim=16,
                                       dropout=0.0)
        return hp
    hp_fn.__name__ = f"vc_{generator}"
    return hp_fn


HP = {g: _vc_hp(g) for g in GENERATORS}


def _vc_batch():
    rs = np.random.RandomState(4)
    x = rs.randn(B, T, 3 * S).astype(np.float32)
    y = rs.randn(B, T, 3 * S).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    Y_mean = (rs.randn(3 * S) * 0.1).astype(np.float32)
    Y_std = (rs.rand(3 * S) + 0.5).astype(np.float32)
    R = unit_variance_mlpg_matrix(hparams.vc.windows, T)
    return x, y, lengths, R, Y_mean, Y_std


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("generator", GENERATORS)
def test_vc_step_outputs_match_jax(generator, cd):
    (_, _, jout), (tg, _, out), _, n = _run_both("torch_rule", cd,
                                                 HP[generator], _vc_batch)
    assert type(tg.model).__name__ == generator
    assert float(out["num_frames"]) == n and "mcd" in out
    _check_outputs(jout, out, n)
    if generator == "In2OutRNNHighwayNet":  # its first return is the input
        x, y, lengths = _vc_batch()[:3]
        mask = np.arange(T)[None, :] < lengths[:, None]
        mse = ((x - y) ** 2)[mask].sum() / mask.sum()  # per valid frame
        assert abs(float(out["mse"]) - mse) <= 1e-5 * mse


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("generator", GENERATORS)
def test_vc_step_gradients_match_jax(generator, cd):
    """At test_torch_step.py's 1e-4 of scale, but the LSTM trunk's
    parameters in bf16 at tests/test_torch_lstm.py's 5e-3 (its bf16 model
    gradients): a dxp that rounds one bf16 step apart feeds the recurrence,
    and layer 0 gathers the most such steps (readings 1.3e-4 for its w_ih,
    7.6e-5 for its w_hh; every other parameter under 1e-6)."""
    def tol(name):
        return 5e-3 if cd == "bfloat16" and name.startswith("lstm.") else 1e-4
    _check_gradients(cd, HP[generator], _vc_batch, tol)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("generator", GENERATORS)
def test_vc_step_updates_match_jax(generator, cd):
    _check_updates(cd, HP[generator], batch_fn=_vc_batch)


def _stencil_hp(module, compute_dtype="float32"):
    hp = _hp(module, compute_dtype)
    hp.mlpg_impl = "stencil"
    return hp


def _long_batch():
    rs = np.random.RandomState(6)
    Tl = 112
    x = rs.rand(B, Tl, 425).astype(np.float32)
    y = rs.randn(B, Tl, 187).astype(np.float32)
    lengths = np.r_[rs.randint(Tl // 2, Tl, B - 1), Tl].astype(np.int32)
    Y_mean = (rs.randn(187) * 0.1).astype(np.float32)
    Y_std = (rs.rand(187) + 0.5).astype(np.float32)
    Y_mean[183], Y_std[183] = 2.0, 1.0
    R = unit_variance_mlpg_matrix(hparams.tts_acoustic.windows, Tl)
    return x, y, lengths, R, Y_mean, Y_std


def test_stencil_mlpg_step_matches_jax():
    """Outputs and gradients of the step with the stencil MLPG; the port's
    trainer must take the stencil (its output differs from the dense R's
    only by the stencil's own error)."""
    from unittest import mock

    from gantts_tpu_torch.train import step as port_step

    calls = []
    real = port_step.multi_stream_mlpg_stencil
    with mock.patch.object(port_step, "multi_stream_mlpg_stencil",
                           lambda *a, **k: calls.append(1) or real(*a, **k)):
        _check_gradients("float32", _stencil_hp, _long_batch)
    assert calls
    (_, _, jout), (_, _, out), _, n = _run_both("torch_rule", "float32",
                                                _stencil_hp, _long_batch)
    _check_outputs(jout, out, n)


def test_vc_has_ref_spoofing_count_matches_jax():
    hp_fn = HP["In2OutRNNHighwayNet"]
    x, y, lengths, R, Y_mean, Y_std = _vc_batch()
    jhp = hp_fn(jax_hparams)
    assert not jhp.discriminator_linguistic_condition
    model_g, model_d, _, _, jg, jd = jax_init(jhp, seed=0)
    ref_params = jax_init(jhp, seed=7)[5].params
    tx_g = _torch_adagrad(**jhp.optimizer_g_params)
    tx_d = _torch_adagrad(**jhp.optimizer_d_params)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    g0, d0 = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    jtr = JaxTrainer(model_g, model_d, tx_g, tx_d,
                     JaxConfig.from_hparams(jhp, **STEP_KW, has_ref=True),
                     Y_mean, Y_std)
    _, _, jout, _ = jtr.step_fn(True)(
        jg, jd, ref_params, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(lengths), jnp.asarray(R), None, jnp.float32(1.0),
        jax.random.PRNGKey(0))

    hp = hp_fn(hparams)
    mg, md, _, _, tg, td = init_models_and_states(hp, seed=0, device="cpu")
    mg.load_state_dict(convert.flax_to_torch(g0), strict=True)
    md.load_state_dict(convert.flax_to_torch(d0), strict=True)
    model_ref = MLP(**hp.discriminator_params)
    model_ref.load_state_dict(convert.flax_to_torch(ref_params), strict=True)
    tr = GanTrainer(StepConfig.from_hparams(hp, **STEP_KW, has_ref=True),
                    Y_mean, Y_std, "cpu", model_ref=model_ref,
                    windows=hp.windows)
    _, _, out = tr.step(tg, td, torch.tensor(x), torch.tensor(y),
                        torch.tensor(lengths), torch.tensor(R), 1.0)
    n = int(lengths.sum())
    assert 0 < float(out["regard_fake_as_natural"]) <= n
    _check_outputs(jout, out, n)
