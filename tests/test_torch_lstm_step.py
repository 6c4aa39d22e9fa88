"""One tts_acoustic GAN training step with an LSTMRNN generator in both
packages, from identical converted states, on the same numpy batch.

The configuration is tests/test_torch_step.py's small tts_acoustic (B=3,
T=40, the real stream layout, a 2x16 MLP discriminator, dropout off) with
the generator of bench.py's LSTM configuration cut to 2 bidirectional
layers of H=32.  Each comparison runs in float32 (the JAX package's CPU
scan) and in bfloat16 (its Pallas LSTM kernels, in interpret mode); the
tolerances and the optimizer comparison are those of test_torch_step.py,
whose helpers run both steps.
"""

import torch
from test_torch_step import (
    _check_gradients,
    _check_outputs,
    _check_updates,
    _hp,
    _run_both,
)

torch.set_num_threads(1)


def _lstm_hp(module, compute_dtype="float32"):
    hp = _hp(module, compute_dtype)
    hp.generator = "LSTMRNN"
    hp.generator_params = dict(in_dim=425, out_dim=187, num_hidden=2,
                               hidden_dim=32, bidirectional=True, dropout=0.0)
    return hp


def test_lstm_step_outputs_match_jax():
    (_, _, jout), (tg, _, out), _, n = _run_both("torch_rule", "float32",
                                                 _lstm_hp)
    assert type(tg.model).__name__ == "LSTMRNN"
    assert float(out["num_frames"]) == n
    _check_outputs(jout, out, n)


def test_lstm_step_bf16_outputs_match_jax():
    (_, _, jout), (_, _, out), _, n = _run_both("torch_rule", "bfloat16",
                                                _lstm_hp)
    _check_outputs(jout, out, n)


def test_lstm_step_gradients_match_jax():
    _check_gradients("float32", _lstm_hp)


def test_lstm_step_bf16_gradients_match_jax():
    _check_gradients("bfloat16", _lstm_hp)


def test_lstm_step_updates_match_jax():
    _check_updates("float32", _lstm_hp)


def test_lstm_step_bf16_updates_match_jax():
    """The noise level is 1e-4 of max|g|, the limit the bf16 gradients are
    held to above, not 1e-5: in bf16 the LSTM's dxp that rounds one step
    apart also feeds the recurrence, and two elements of layer 0's w_ih with
    |g| at 1.1e-5 of max|g| took their first Adagrad step the other way."""
    _check_updates("bfloat16", _lstm_hp, noise_level=1e-4)
