"""Training command line of the port (counterpart of the repository's
train.py), for GAN-based VC and TTS models:

    python -m gantts_tpu_torch.train [options] <inputs_dir> <outputs_dir>

It takes train.py's flags with the same defaults, so a train_gan.sh stage's
command line runs here by changing only the program, and it adds
``--device`` (``cuda`` unless asked for ``cpu``).  It reads the .npy corpus
(X and Y directories side by side; the normalization stats are saved in
their parent), builds the models of ``--hparams_name`` with the
``--hparams`` overrides, optionally resumes from checkpoints, trains
``nepoch`` epochs and writes ``checkpoint_epoch{N}_{Generator|
Discriminator}.pth`` and the logged series (``scalars.jsonl``).

``--hparams_name=vc`` (the default, as in train.py) trains on a parallel
corpus: X and Y share pooled normalization stats (``data_mean`` and
``data_var`` in the corpus's parent), the In2Out generator applies MLPG
itself, and the discriminator reads the static mel-cepstra alone, so a
``--checkpoint-r`` reference discriminator serves the spoofing rate.

Not here: train.py's multi-device and compile-cache flags, which are TPU
matters, and ``--steps-per-dispatch``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
from os.path import abspath, join
from warnings import warn

import numpy as np


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.train",
        description="Training script for GAN-based VC/TTS models on "
                    "PyTorch")
    p.add_argument("inputs_dir")
    p.add_argument("outputs_dir")
    p.add_argument("--hparams_name", default="vc")
    p.add_argument("--hparams", default="")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                   default="checkpoints")
    p.add_argument("--checkpoint-g", dest="checkpoint_g", default=None)
    p.add_argument("--checkpoint-d", dest="checkpoint_d", default=None)
    p.add_argument("--checkpoint-r", dest="checkpoint_r", default=None)
    p.add_argument("--max_files", type=int, default=-1)
    p.add_argument("--discriminator-warmup", dest="discriminator_warmup",
                   action="store_true")
    p.add_argument("--w_d", type=float, default=1.0)
    p.add_argument("--mse_w", type=float, default=0.0)
    p.add_argument("--mge_w", type=float, default=1.0)
    p.add_argument("--restart_epoch", type=int, default=-1)
    p.add_argument("--reset_optimizers", action="store_true")
    p.add_argument("--log-event-path", dest="log_event_path", default=None)
    p.add_argument("--disable-slack", dest="disable_slack",
                   action="store_true",
                   help="accepted so that reference command lines parse; "
                        "this program posts no message")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def main(argv=None):
    since = time.time()
    args = build_arg_parser().parse_args(argv)
    print("Command line args:\n", vars(args))

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.hparams import hparams_debug_string
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.checkpoint import (
        load_checkpoint,
        restore,
        save_checkpoint,
    )
    from gantts_tpu_torch.train.logging import ScalarWriter
    from gantts_tpu_torch.train.loop import train_loop
    from gantts_tpu_torch.train.setup import (
        init_models_and_states,
        load_arrays,
        prepare_tts,
        prepare_vc,
    )

    hp = getattr(hparams, args.hparams_name).copy()
    hp.parse(args.hparams)
    print(hparams_debug_string(hp))

    inputs_dir, outputs_dir = args.inputs_dir, args.outputs_dir
    # inputs and outputs are in the same parent directory (train.py:674-677)
    data_dir = abspath(join(inputs_dir, os.pardir))
    assert data_dir == abspath(join(outputs_dir, os.pardir))

    max_files = args.max_files if args.max_files > 0 else None
    w_d, mse_w, mge_w = args.w_d, args.mse_w, args.mge_w
    update_d = w_d > 0
    update_g = not args.discriminator_warmup

    os.makedirs(args.checkpoint_dir, exist_ok=True)

    X, Y, utt_lengths = load_arrays(inputs_dir, outputs_dir, max_files)
    prepare = prepare_vc if hp.name == "vc" else prepare_tts
    loaders, Y_mean, Y_std = prepare(X, Y, utt_lengths, hp, data_dir)

    model_g, model_d, _, _, gstate, dstate = init_models_and_states(
        hp, device=args.device)
    print("Generator:", model_g)
    print("Discriminator:", model_d)

    # Reference discriminator for the spoofing rate (train.py:779-788)
    model_ref = None
    if args.checkpoint_r is not None:
        try:
            state_dict, _, _ = load_checkpoint(args.checkpoint_r)
            model_ref = create_model(
                hp.discriminator, compute_dtype=hp.compute_dtype,
                device=args.device, **hp.discriminator_params)
            model_ref.load_state_dict(state_dict, strict=True)
        except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) \
                as e:  # the reference warns and trains on without it
            warn(f"Invalid checkpoint for reference discriminator: {e!r}")
            model_ref = None

    global_epoch = 0
    if args.checkpoint_d:
        global_epoch = restore(dstate, args.checkpoint_d,
                               args.reset_optimizers)
    if args.checkpoint_g:
        global_epoch = restore(gstate, args.checkpoint_g,
                               args.reset_optimizers)
    if args.restart_epoch >= 0:
        global_epoch = args.restart_epoch

    log_event_path = args.log_event_path
    if log_event_path is None:
        log_event_path = "log/run-test" + str(np.random.randint(100000))
    print(f"Log event path: {log_event_path}")
    writer = ScalarWriter(log_event_path)

    cfg = StepConfig.from_hparams(hp, w_d, mse_w, mge_w, update_d, update_g,
                                  has_ref=model_ref is not None)
    trainer = GanTrainer(cfg, Y_mean, Y_std, args.device,
                         model_ref=model_ref, windows=hp.windows)

    print(f"Start training from epoch {global_epoch}")
    gstate, dstate, final_epoch = train_loop(
        trainer, gstate, dstate, loaders, hp, w_d=w_d, mse_w=mse_w,
        mge_w=mge_w, update_d=update_d, update_g=update_g,
        checkpoint_dir=args.checkpoint_dir, writer=writer,
        global_epoch=global_epoch)

    for state, enabled, name in [(gstate, update_g, "Generator"),
                                 (dstate, cfg.update_d, "Discriminator")]:
        if enabled:
            save_checkpoint(state, final_epoch, args.checkpoint_dir, name)

    writer.close()
    print(f"Finished! Elapsed: {(time.time() - since) / 60:.1f} min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
