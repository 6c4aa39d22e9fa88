"""Each family's operation counts against torch's FlopCounterMode on the
program's own models at a small size (the CPU runs every product the card
runs, at padded shapes)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness
from perfbench.flops import gan as gan_flops
from perfbench.tests.test_perfbench_reference import load


def program_models(config):
    from gantts_tpu_torch.models import create_model

    hp = harness.hparams_of(load(config))
    g = torch.Generator().manual_seed(0)
    G = create_model(hp["generator"], compute_dtype="float32", generator=g,
                     device="cpu", **hp["generator_params"])
    D = create_model(hp["discriminator"], compute_dtype="float32",
                     generator=g, device="cpu", **hp["discriminator_params"])
    return hp, G, D


def counted(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


@pytest.mark.parametrize("config", ["tiny_tts", "tiny_vc"])
@pytest.mark.parametrize("train", [False, True])
def test_generator_operations(config, train):
    hp, G, _ = program_models(config)
    _, ops = harness.family(load(config))
    B, T = 3, 24
    gp = hp["generator_params"]
    x = torch.randn(B, T, gp["in_dim"])
    lengths = torch.full((B,), T, dtype=torch.int32)
    R = torch.randn(T, 3 * T)
    x.requires_grad_(False)

    def step():
        with torch.set_grad_enabled(train):
            if config == "tiny_vc":
                y = G(x, R, lengths)[1]
            else:
                y = G(x, lengths)
            if train:
                y.sum().backward()

    got = counted(step)
    want = ops.generator(hp, B * T, train, rows=B)
    if config == "tiny_vc":
        # the In2Out model applies MLPG itself
        want += gan_flops.mlpg(hp, [T] * B, T, train)
    elif train:
        # the SRU layer also takes dx of the first layer's products, which
        # the step does not need (its input is data): the counts leave it
        # out
        want += 2 * 2 * gp["in_dim"] * 4 * gp["hidden_dim"] * B * T
    assert got == want


@pytest.mark.parametrize("config", ["tiny_tts", "tiny_vc"])
def test_discriminator_operations(config):
    hp, _, D = program_models(config)
    rows = 40
    dp = hp["discriminator_params"]
    x2 = torch.randn(2 * rows, dp["in_dim"])
    xg = torch.randn(rows, dp["in_dim"], requires_grad=True)

    def update():
        D(x2).sum().backward()          # the discriminator's update
        for p in D.parameters():
            p.requires_grad_(False)
        D(xg).sum().backward()          # the generator's adversarial loss
        for p in D.parameters():
            p.requires_grad_(True)

    assert counted(update) == gan_flops.discriminator(hp, rows, True)

    def evaluate():
        with torch.no_grad():
            D(x2)
            D(x2[:rows])

    assert counted(evaluate) == gan_flops.discriminator(hp, rows, False)


@pytest.mark.parametrize("config", ["tiny_tts", "tiny_vc"])
def test_mlpg_operations(config):
    from gantts_tpu_torch.core.paramgen import multi_stream_mlpg

    hp = harness.hparams_of(load(config))
    B, T = 2, 16
    D = sum(hp["stream_sizes"])
    y = torch.randn(B, T, D, requires_grad=True)
    R = torch.randn(T, 3 * T)

    def run():
        multi_stream_mlpg(y, R, hp["stream_sizes"],
                          hp["has_dynamic_features"]).sum().backward()

    assert counted(run) == gan_flops.mlpg(hp, [T] * B, T, True)
