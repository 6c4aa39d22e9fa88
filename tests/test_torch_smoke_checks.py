"""The F0 error's checks, on the CPU: chip_smoke.py phases 5-5c and the
step tests' ``_check_outputs``.

The F0 error is taken over frames voiced in both the target and the
prediction.  With no such frame it is NaN, and a comparison that scores NaN
against NaN as agreement holds nothing.  Phases 5-5c denormalize V/UV
around 2, so that their small acoustic steps give a number on the CPU, and
``loss_gap`` fails a NaN on one side alone.  ``_check_outputs`` excuses an
f0_rmse gap only together with a vuv_err gap (a V/UV decision flipped).
"""

import math

import numpy as np
import pytest
import torch
from test_torch_step import _check_outputs

import chip_smoke

torch.set_num_threads(1)


@pytest.mark.parametrize("a,b,want", [
    (math.nan, math.nan, 0.0),
    (math.nan, 1.0, math.inf),
    (1.0, math.nan, math.inf),
    (1.5, 1.0, 0.5),
])
def test_loss_gap(a, b, want):
    assert chip_smoke.loss_gap(a, b) == want


@pytest.mark.parametrize("tag", sorted(chip_smoke.SMALL_ACOUSTIC_STEPS))
def test_small_acoustic_step_f0_rmse_is_a_number(tag):
    """Phase 5-5c's step, as the phase runs it on the CPU side (the same
    configuration, batch and statistics), gives a finite f0_rmse and, every
    target and prediction being voiced, vuv_err 0."""
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = chip_smoke.SMALL_ACOUSTIC_STEPS[tag]()
    hp.discriminator_params.update(dropout=0.0)
    cpu = torch.device("cpu")
    batch, R = chip_smoke.small_step_batch(hp, 64, 4)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=1,
                                                        device=cpu)
    x, y, lengths = (torch.as_tensor(a) for a in batch)
    _, _, out = chip_smoke.make_trainer(hp, cpu).step(
        gstate, dstate, x, y, lengths, torch.as_tensor(R), 1.0)
    assert math.isfinite(float(out["f0_rmse"])) and float(out["f0_rmse"]) > 0
    assert float(out["vuv_err"]) == 0.0


def _outputs(f0, vuv):
    return {"mcd": np.float32(5.0), "f0_rmse": np.float32(f0),
            "vuv_err": np.float32(vuv)}


@pytest.mark.parametrize("f0,vuv,ok", [
    (100.0, 0.1, True),           # equal
    (100.5, 0.1, False),          # an F0 gap with V/UV the same: a fault
    (100.5, 0.1 + 1 / 400, True),  # a V/UV decision flipped
    (100.0, 0.1 + 2 / 400, False),  # more than one frame flipped
])
def test_check_outputs_excuses_f0_only_with_a_vuv_flip(f0, vuv, ok):
    jout = _outputs(100.0, 0.1)
    if ok:
        _check_outputs(jout, _outputs(f0, vuv), 400)
    else:
        with pytest.raises(AssertionError):
            _check_outputs(jout, _outputs(f0, vuv), 400)
