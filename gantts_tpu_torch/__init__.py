"""gantts_tpu_torch: the PyTorch and CUDA port of gantts_tpu.

Laid out like ``gantts_tpu`` so that each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax``, and it does not import
``gantts_tpu`` (whose package import loads JAX): the host code the two share
is loaded by file path in ``_shared``.

Layers:
  core/     masking, stream arithmetic, dense MLPG
  models/   TorchLinear, MLP, SRU and SRURNN as nn.Modules
  kernels/  hand-written CUDA kernels for Hopper, with plain PyTorch versions
  train/    optimizers, the GAN training step, metrics, model/state setup
  convert   flax parameter trees <-> torch state_dicts
"""
