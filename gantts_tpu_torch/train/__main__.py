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

``-g`` / ``-d`` / ``--checkpoint-r`` read the port's own ``torch.save``
checkpoints and the JAX package's flax msgpack ones (parameters, and the
optax state carried into torch.optim's; see ``checkpoint.py``).  A legacy
pickle checkpoint is refused: this program executes no code from a file.

``--steps-per-dispatch N`` runs N consecutive training steps of the same
shapes as one dispatch: on the card, one replay of a CUDA graph of N steps
(train/loop.py, train/graphs.py), equal bit for bit to N eager steps.  0
(the default) is 16 on ``cuda``, as train.py's auto on one device, and 1
on ``--device cpu``, where there are no graphs (train.py's path without
multi-step dispatch); N > 1 with ``--device cpu`` is an error.

``--profile-dir`` writes a torch.profiler Chrome trace of the second epoch
of the run (the first pays for building and loading the kernels and for
capturing the graphs); ``--debug-nans`` stops at the first non-finite
gradient norm or loss with a ``FloatingPointError`` that names the epoch,
phase, batch and quantity, and runs one eager step at a time.

Data parallelism (``gantts_tpu_torch.parallel``), train.py's flags with its
names and defaults: ``--num-devices N`` trains on N devices, one process
each (0, the default, is all visible devices of ``--device``: every CUDA
device, and 1 on ``cpu``; 1 is the single-device trainer).  N > 1 spawns N
worker processes that form a group (NCCL on ``cuda``, each rank on
``cuda:<rank>``; gloo on ``cpu``) and joins them; it fails if any fails.
``--distributed`` joins a group started elsewhere instead (torchrun's
environment, or ``--coordinator-address``, ``--num-processes`` and
``--process-id``), one process per device, and trains data-parallel over
the whole group, one rank included; ``--num-devices`` below the group's size
is refused there, as in train.py.  Under data parallelism every rank reads
the same corpus and steps on its rows of each global batch, the logged
values are the global batch's, rank 0 alone writes the log and the
checkpoints, and one step runs a dispatch (``--steps-per-dispatch`` 0 is 1;
more is refused).

Not here: train.py's compile-cache environment switch, a TPU matter.
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
    p.add_argument("--steps-per-dispatch", dest="steps_per_dispatch",
                   type=int, default=0,
                   help="training steps of the same shapes run as one "
                        "dispatch (one CUDA graph replay), bit-identical "
                        "to unfused. 0 = auto: 16 on cuda, 1 on cpu and "
                        "under --debug-nans")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="capture a torch.profiler trace of one epoch here")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="fail fast on the first NaN/Inf (gradient norm or "
                        "loss); one eager step at a time")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--num-devices", dest="num_devices", type=int, default=0,
                   help="devices to train on data-parallel, one process "
                        "each (0 = all visible: every CUDA device, 1 on "
                        "cpu; 1 forces the single-device trainer)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed group started elsewhere "
                        "(torchrun's environment or the coordinator flags)")
    p.add_argument("--coordinator-address", dest="coordinator_address",
                   default=None)
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    return p


def steps_per_dispatch(requested, device, debug_nans, data_parallel=False):
    """The K that ``--steps-per-dispatch`` asks for on ``device``: 0 is
    auto (16 on cuda, 1 on cpu); 1 under ``--debug-nans``.  K > 1 needs
    CUDA graphs, so it is refused on any other device, and under data
    parallelism, which runs one step a dispatch."""
    import torch

    kind = torch.device(device).type
    if requested < 0:
        raise ValueError(f"--steps-per-dispatch {requested}: not a count")
    if requested > 1 and kind != "cuda":
        raise ValueError(
            f"--steps-per-dispatch {requested} needs CUDA graphs: device "
            f"{device!r} runs one step at a time (1, or 0 for auto)")
    if requested > 1 and data_parallel:
        raise ValueError(
            f"--steps-per-dispatch {requested}: data parallelism runs one "
            f"step a dispatch (1, or 0 for auto)")
    if debug_nans or data_parallel:
        return 1
    if requested == 0:
        return 16 if kind == "cuda" else 1
    return requested


def num_devices(requested, device):
    """The devices ``--num-devices`` asks for on ``device``'s kind: 0 is
    all visible (``torch.cuda.device_count()`` on cuda, 1 on cpu)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    visible = torch.cuda.device_count() if cuda else 1
    if requested < 0:
        raise ValueError(f"--num-devices {requested}: not a count")
    if requested == 0:
        return max(visible, 1)
    if cuda and requested > visible:
        raise ValueError(f"--num-devices {requested}: {visible} CUDA "
                         f"device(s) visible")
    return requested


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    print("Command line args:\n", vars(args))
    try:
        n = 1 if args.distributed else num_devices(args.num_devices,
                                                   args.device)
        spd = steps_per_dispatch(args.steps_per_dispatch, args.device,
                                 args.debug_nans, args.distributed or n > 1)
    except ValueError as e:
        parser.error(str(e))

    if args.distributed:
        from gantts_tpu_torch.parallel import (
            backend_for,
            initialize_distributed,
        )

        mesh = initialize_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            backend=backend_for(args.device))
        if 0 < args.num_devices < mesh.world:
            # every process of the group owns one rank of the data axis
            raise SystemExit(
                f"--num-devices={args.num_devices} < {mesh.world} ranks is "
                "not supported with --distributed: every process trains on "
                "its rank. Start fewer processes instead.")
        return train(args, spd, mesh)
    if n > 1:
        from gantts_tpu_torch.parallel import spawn

        print(f"Spawning {n} data-parallel workers on {args.device}")
        spawn("gantts_tpu_torch.train.__main__:train_rank", n,
              args=(argv, spd), device=args.device)
        return 0
    return train(args, spd)


def train_rank(argv, spd):
    """One spawned worker of ``--num-devices N``: rank r of the group that
    ``parallel.spawn`` formed, on its device."""
    from gantts_tpu_torch.parallel import make_mesh

    train(build_arg_parser().parse_args(argv), spd, make_mesh())


def train(args, spd, mesh=None):
    """Train as ``args`` say, ``spd`` steps a dispatch (the K of
    ``steps_per_dispatch``); data-parallel over ``mesh`` (a
    ``parallel.DataGroup``) when given."""
    since = time.time()
    if args.debug_nans:
        print("--debug-nans: one eager step at a time "
              "(--steps-per-dispatch 1)")
    device = args.device if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0

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
        hp, device=device)
    print("Generator:", model_g)
    print("Discriminator:", model_d)

    # Reference discriminator for the spoofing rate (train.py:779-788)
    model_ref = None
    if args.checkpoint_r is not None:
        try:
            state_dict, _, _ = load_checkpoint(args.checkpoint_r)
            model_ref = create_model(
                hp.discriminator, compute_dtype=hp.compute_dtype,
                device=device, **hp.discriminator_params)
            model_ref.load_state_dict(state_dict, strict=True)
        except (OSError, KeyError, RuntimeError, ValueError,
                pickle.UnpicklingError) as e:
            # the reference warns and trains on without it; so does a
            # refused pickle, as under the JAX command line
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
    writer = ScalarWriter(log_event_path) if rank0 else None

    cfg = StepConfig.from_hparams(hp, w_d, mse_w, mge_w, update_d, update_g,
                                  has_ref=model_ref is not None)
    if mesh is None:
        trainer = GanTrainer(cfg, Y_mean, Y_std, device,
                             model_ref=model_ref, windows=hp.windows)
    else:
        from gantts_tpu_torch.parallel import DataParallelGanTrainer

        print(f"Data-parallel over {mesh.world} devices: rank {mesh.rank} "
              f"on {mesh.device}")
        trainer = DataParallelGanTrainer(
            cfg, Y_mean, Y_std, model_ref=model_ref, windows=hp.windows,
            mesh=mesh, states=(gstate, dstate))

    print(f"Start training from epoch {global_epoch}, {spd} step(s) a "
          f"dispatch")
    gstate, dstate, final_epoch = train_loop(
        trainer, gstate, dstate, loaders, hp, w_d=w_d, mse_w=mse_w,
        mge_w=mge_w, update_d=update_d, update_g=update_g,
        checkpoint_dir=args.checkpoint_dir, writer=writer,
        global_epoch=global_epoch,
        profile_dir=args.profile_dir if rank0 else None,
        debug_nans=args.debug_nans, steps_per_dispatch=spd)

    for state, enabled, name in [(gstate, update_g, "Generator"),
                                 (dstate, cfg.update_d, "Discriminator")]:
        if enabled:
            save_checkpoint(state, final_epoch, args.checkpoint_dir, name)

    if writer is not None:
        writer.close()
    print(f"Finished! Elapsed: {(time.time() - since) / 60:.1f} min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
