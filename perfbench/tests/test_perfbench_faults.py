"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped (the CPU), the rest of a run driven at a
small size, once for each fault a one-chip training cell can have."""

import pytest

from perfbench.tests.test_perfbench_reference import run


def unchanged_state(monkeypatch):
    """Every optimizer step returns the state unchanged."""
    from gantts_tpu_torch.train import optim

    monkeypatch.setattr(optim.ClippedOptimizer, "step", lambda self: None)


def half_batch(monkeypatch):
    """Each step takes the first half of its batch's rows, the mean over
    them."""
    from gantts_tpu_torch.train.step import GanTrainer

    step = GanTrainer.step

    def halved(self, gstate, dstate, x, y, lengths, *args, **kwargs):
        h = x.shape[0] // 2
        return step(self, gstate, dstate, x[:h], y[:h], lengths[:h], *args,
                    **kwargs)

    monkeypatch.setattr(GanTrainer, "step", halved)


def altered_output(monkeypatch):
    """The generator's parameter generation returns its answer altered by
    one part in a hundred where it is produced."""
    from gantts_tpu_torch import models
    from gantts_tpu_torch.core import paramgen

    mlpg = paramgen.unit_variance_mlpg

    def altered(*args, **kwargs):
        return mlpg(*args, **kwargs) * 1.01

    for module in (paramgen, models):  # the TTS step's, the In2Out model's
        monkeypatch.setattr(module, "unit_variance_mlpg", altered)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_output])
@pytest.mark.parametrize("config", ["tiny_tts", "tiny_vc"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, config):
    fault(monkeypatch)
    result, _ = run(config, 7)
    assert not result["correct"], result["compared"]
    over = [k for k, c in result["compared"].items()
            if not c["value"] <= c["limit"]]
    assert over, result["compared"]


def test_the_unbroken_run_of_the_same_seed_is_correct():
    result, _ = run("tiny_tts", 7)
    assert result["correct"], result["compared"]
