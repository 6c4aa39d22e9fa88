"""Checkpoint save and restore with the reference's naming contract
(counterpart of gantts_tpu/train/checkpoint.py).

The GAN curriculum (train_gan.sh) hands state between separate processes
through files named ``checkpoint_epoch{N}_{Generator|Discriminator}.pth``
holding {state_dict, optimizer, global_epoch}.  The port writes them with
``torch.save``: the model's ``state_dict`` (the JAX package's parameter names,
see ``convert.py``) and the torch optimizer's.  A file is written to a
temporary name and renamed, so a crash mid-write never leaves a corrupt
checkpoint for the next stage, and read with ``weights_only=True``, which
executes no code from the file.  The JAX package's msgpack checkpoints are
not read here.
"""

from __future__ import annotations

import os
from os.path import join

import torch


def save_checkpoint(state, epoch, checkpoint_dir, name):
    """``state``: a TrainState (model, optimizer); ``name``: Generator or
    Discriminator.  Returns the path written."""
    path = join(checkpoint_dir, f"checkpoint_epoch{epoch}_{name}.pth")
    payload = {"state_dict": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "global_epoch": int(epoch)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    print("Saved checkpoint:", path)
    return path


def load_checkpoint(path):
    """Returns (state_dict, optimizer state or None, global_epoch), tensors
    on the CPU; ``load_state_dict`` moves them to the model's device."""
    print(f"Load checkpoint from: {path}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (payload["state_dict"], payload.get("optimizer"),
            int(payload["global_epoch"]))


def restore(state, path, reset_optimizer=False):
    """Load a checkpoint into ``state`` in place: the model's parameters
    and, unless ``reset_optimizer`` or the file has none, the optimizer's
    state.  Returns the checkpoint's global epoch."""
    state_dict, opt, epoch = load_checkpoint(path)
    state.model.load_state_dict(state_dict, strict=True)
    if opt is not None and not reset_optimizer:
        state.optimizer.load_state_dict(opt)
    return epoch
