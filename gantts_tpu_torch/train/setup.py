"""Model and optimizer construction (counterpart of the
``init_models_and_states`` part of gantts_tpu/train/setup.py; the data
preparation there comes with the training loop)."""

from __future__ import annotations

import torch

from gantts_tpu_torch.models import create_model
from gantts_tpu_torch.train.optim import create_optimizer
from gantts_tpu_torch.train.step import TrainState


def init_models_and_states(hp, seed=1234, device="cpu"):
    """Build generator and discriminator by name on ``device``, with torch's
    default init drawn from a generator seeded by ``seed``, and their
    optimizers.  Returns (model_g, model_d, opt_g, opt_d, gstate, dstate)."""
    cd = getattr(hp, "compute_dtype", "float32")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model_g = create_model(hp.generator, compute_dtype=cd, generator=gen,
                           device=device, **hp.generator_params)
    model_d = create_model(hp.discriminator, compute_dtype=cd, generator=gen,
                           device=device, **hp.discriminator_params)
    opt_g = create_optimizer(hp.optimizer_g, hp.optimizer_g_params,
                             model_g.parameters())
    opt_d = create_optimizer(hp.optimizer_d, hp.optimizer_d_params,
                             model_d.parameters())
    return (model_g, model_d, opt_g, opt_d, TrainState(model_g, opt_g),
            TrainState(model_d, opt_d))
