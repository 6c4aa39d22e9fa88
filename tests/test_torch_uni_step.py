"""The GAN training step with a unidirectional SRURNN generator, whose layers
after the first are k=3 layers (the linear-recurrence kernel's path), and the
step's two options that feed the generator or read a reference
discriminator: ``add_noise`` and ``has_ref``.  Both packages take one step
from identical converted states on the same numpy batch.

The configuration is tests/test_torch_step.py's small tts_acoustic (B=3,
T=40, the real stream layout, a 2x16 MLP discriminator, dropout off) with a
3x32 unidirectional relu SRU generator: layer 0 k=4, layers 1-2 k=3.  Each
comparison runs in float32 (the JAX package's CPU scans) and in bfloat16
(its Pallas kernels in interpret mode, ``linear_recurrence_pallas`` for the
k=3 layers); the tolerances and the optimizer comparison are those of
test_torch_step.py, whose helpers run both steps.

``add_noise``: the generator reads [x | z] with z (B, T, 8) from numpy,
handed to both.  ``has_ref``: a reference discriminator with other weights
(the JAX package's init from another seed, converted) gives the spoofing
count ``regard_fake_as_natural``; as in the JAX package it reads the selected
static stream alone, so the configuration turns the linguistic condition
off.  Both are compared in float32 at test_torch_step.py's output
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step import (
    STEP_KW,
    _batch,
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
from gantts_tpu_torch.models import MLP
from gantts_tpu_torch.train import GanTrainer, StepConfig
from gantts_tpu_torch.train.setup import init_models_and_states

torch.set_num_threads(1)

NOISE_DIM = 8


def _uni_hp(module, compute_dtype="float32"):
    hp = _hp(module, compute_dtype)
    hp.generator_params.update(num_hidden=3, bidirectional=False)
    return hp


def test_uni_step_outputs_match_jax():
    (_, _, jout), (tg, _, out), _, n = _run_both("torch_rule", "float32",
                                                 _uni_hp)
    layers = [getattr(tg.model.gru, f"l{i}_fwd") for i in range(3)]
    assert [m.k for m in layers] == [4, 3, 3]
    assert float(out["num_frames"]) == n
    _check_outputs(jout, out, n)


def test_uni_step_bf16_outputs_match_jax():
    (_, _, jout), (_, _, out), _, n = _run_both("torch_rule", "bfloat16",
                                                _uni_hp)
    _check_outputs(jout, out, n)


def test_uni_step_gradients_match_jax():
    _check_gradients("float32", _uni_hp)


def test_uni_step_bf16_gradients_match_jax():
    _check_gradients("bfloat16", _uni_hp)


def test_uni_step_updates_match_jax():
    _check_updates("float32", _uni_hp)


def test_uni_step_bf16_updates_match_jax():
    _check_updates("bfloat16", _uni_hp)


def _noise_hp(module, compute_dtype="float32"):
    hp = _uni_hp(module, compute_dtype)
    hp.generator_add_noise = True
    hp.generator_noise_dim = NOISE_DIM
    hp.generator_params.update(in_dim=425 + NOISE_DIM)
    return hp


def _ref_hp(module, compute_dtype="float32"):
    hp = _uni_hp(module, compute_dtype)
    hp.discriminator_linguistic_condition = False
    hp.discriminator_params.update(in_dim=60 - 2)
    return hp


def _option_step_both(hp_fn, has_ref):
    """One training step of each package (JAX with torch's Adagrad rule),
    with a reference discriminator when ``has_ref`` and the generator's
    input noise when the configuration adds it."""
    x, y, lengths, R, Y_mean, Y_std = _batch()
    jhp = hp_fn(jax_hparams)
    model_g, model_d, _, _, jg, jd = jax_init(jhp, seed=0)
    ref_params = jax_init(jhp, seed=7)[5].params if has_ref else None
    tx_g = _torch_adagrad(**jhp.optimizer_g_params)
    tx_d = _torch_adagrad(**jhp.optimizer_d_params)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    g0, d0 = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    jcfg = JaxConfig.from_hparams(jhp, **STEP_KW, has_ref=has_ref)
    z = (np.random.RandomState(1).rand(*x.shape[:2], NOISE_DIM)
         .astype(np.float32) if jcfg.add_noise else None)
    jtr = JaxTrainer(model_g, model_d, tx_g, tx_d, jcfg, Y_mean, Y_std)
    _, _, jout, _ = jtr.step_fn(True)(
        jg, jd, ref_params, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(lengths), jnp.asarray(R),
        None if z is None else jnp.asarray(z), jnp.float32(1.0),
        jax.random.PRNGKey(0))

    hp = hp_fn(hparams)
    mg, md, _, _, tg, td = init_models_and_states(hp, seed=0, device="cpu")
    mg.load_state_dict(convert.flax_to_torch(g0), strict=True)
    md.load_state_dict(convert.flax_to_torch(d0), strict=True)
    model_ref = None
    if has_ref:
        model_ref = MLP(**hp.discriminator_params)
        model_ref.load_state_dict(convert.flax_to_torch(ref_params),
                                  strict=True)
    cfg = StepConfig.from_hparams(hp, **STEP_KW, has_ref=has_ref)
    tr = GanTrainer(cfg, Y_mean, Y_std, "cpu", model_ref=model_ref)
    _, _, out = tr.step(tg, td, torch.tensor(x), torch.tensor(y),
                        torch.tensor(lengths), torch.tensor(R), 1.0,
                        z=None if z is None else torch.tensor(z))
    return jout, out, int(lengths.sum())


def test_add_noise_step_matches_jax():
    jout, out, n = _option_step_both(_noise_hp, has_ref=False)
    _check_outputs(jout, out, n)
    hp = _noise_hp(hparams)
    tr = GanTrainer(StepConfig.from_hparams(hp, **STEP_KW), np.zeros(187),
                    np.ones(187), "cpu")
    with pytest.raises(ValueError, match="noise"):
        tr.step(None, None, None, None, None, None, 1.0)


def test_has_ref_spoofing_count_matches_jax():
    jout, out, n = _option_step_both(_ref_hp, has_ref=True)
    assert "regard_fake_as_natural" in out
    assert 0 < float(out["regard_fake_as_natural"]) <= n
    _check_outputs(jout, out, n)
    with pytest.raises(ValueError, match="model_ref"):
        GanTrainer(StepConfig.from_hparams(_ref_hp(hparams), **STEP_KW,
                                           has_ref=True),
                   np.zeros(187), np.ones(187), "cpu")
