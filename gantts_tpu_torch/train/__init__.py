"""Training: optimizers, the GAN step, metrics and model/state setup."""

from gantts_tpu_torch.train.step import (  # noqa: F401
    GanTrainer,
    StepConfig,
    TrainState,
    compute_distortions,
)
