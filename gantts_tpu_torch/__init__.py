"""gantts_tpu_torch: the PyTorch and CUDA port of gantts_tpu.

Laid out like ``gantts_tpu`` so that each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax``, and it neither imports nor
reads any file of ``gantts_tpu``: the host code it needs (the hparams
bundles, the window math, preprocessing, the data pipeline) is its own copy.

Layers:
  hparams        the vc / tts_duration / tts_acoustic bundles
  preprocessing  normalization stats and scaling (NumPy, host)
  data           .npy discovery, the train/test split, bucketed batches
  core/          masking, stream arithmetic, window math, dense MLPG
  models/        TorchLinear, MLP, SRU and SRURNN, the LSTM family
  kernels/       hand-written CUDA kernels for Hopper, with plain versions
  train/         optimizers, the GAN step, setup, loop, checkpoints,
                 logging and the command line (``python -m
                 gantts_tpu_torch.train``)
  convert        flax parameter trees <-> torch state_dicts
"""
