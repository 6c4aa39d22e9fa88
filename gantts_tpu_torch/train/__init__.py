"""Training: optimizers, the GAN step, metrics, setup, the epoch loop,
checkpoints, scalar logging and the command line (``python -m
gantts_tpu_torch.train``, in ``__main__``)."""

from gantts_tpu_torch.train.step import (  # noqa: F401
    GanTrainer,
    StepConfig,
    TrainState,
)
