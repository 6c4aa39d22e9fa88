#!/usr/bin/env python3
"""Streamed-epoch throughput of the port with the host pipeline in the loop
(counterpart of tools/host_pipeline_bench.py).

Whole epochs stream through the port's ``data.BatchIterator`` (normalize ->
pad -> pinned host staging -> device copy without blocking -> step), by the
path the command line's train phase takes (gantts_tpu_torch/train/loop.py):
``dispatch_groups`` with the command line's default K (16 on the card, 1
on the CPU) and ``run_dispatch``, so that consecutive batches of one shape run K at a time
as one CUDA graph replay and a batch that fits no group runs as one eager
step.  Both loader settings, ``num_workers=0`` and ``--workers``, run
interleaved (A B A B ...) in one process on one trainer, after one warm-up
epoch each (which builds the kernels, captures the graphs and fills the
normalized-item caches), so that the comparison sees the same machine
state.  Each epoch ends in a device synchronisation.

usage: python tools/torch_host_pipeline_bench.py <X_dir> <Y_dir>
           [--hparams_name vc] [--hparams ...] [--epochs 6] [--workers 4]
           [--device cuda|cpu]

Prints the JAX tool's one JSON line (``metric``, ``workload`` and, for
``num_workers_0`` and ``num_workers_<workers>``, the median epoch seconds
and valid frames per second), with each setting's steps an epoch and the
steps of those that ran in graph replays.  The data statistics go to a
temporary directory, not beside the corpus.  This tool imports torch and
the port, and neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from os.path import dirname

import numpy as np
import torch

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))


def build_arg_parser():
    p = argparse.ArgumentParser(description="Streamed-epoch throughput of "
                                "the port's training loop")
    p.add_argument("inputs_dir")
    p.add_argument("outputs_dir")
    p.add_argument("--hparams_name", default="vc")
    p.add_argument("--hparams", default="")
    p.add_argument("--epochs", type=int, default=6,
                   help="measured epochs PER loader setting")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    """Run the benchmark as ``argv`` says; prints and returns its JSON
    object."""
    args = build_arg_parser().parse_args(argv)
    if args.workers < 1:
        raise SystemExit("--workers must be at least 1 (num_workers=0 is "
                         "always the other setting)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu")

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.data import BatchIterator
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.__main__ import steps_per_dispatch
    from gantts_tpu_torch.train.loop import (
        RMatrixCache,
        _Stager,
        dispatch_groups,
        run_dispatch,
    )
    from gantts_tpu_torch.train.setup import (
        init_models_and_states,
        load_arrays,
        prepare_tts,
        prepare_vc,
    )

    K = steps_per_dispatch(0, args.device, False)
    hp = getattr(hparams, args.hparams_name).copy()
    hp.parse(args.hparams)
    X, Y, lens = load_arrays(args.inputs_dir, args.outputs_dir)
    prep = prepare_vc if hp.name == "vc" else prepare_tts
    with tempfile.TemporaryDirectory() as stats_dir:
        loaders, Y_mean, Y_std = prep(X, Y, lens, hp, stats_dir)
    base_ds = loaders["train"].dataset

    _, _, _, _, gstate, dstate = init_models_and_states(hp, device=device)
    cfg = StepConfig.from_hparams(hp, w_d=1.0, mse_w=0.0, mge_w=1.0,
                                  update_d=True, update_g=True)
    trainer = GanTrainer(cfg, Y_mean, Y_std, device, windows=hp.windows)
    r_cache = RMatrixCache(hp.windows, device) if cfg.has_dynamic else None
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    noise_rs = np.random.RandomState(1234)
    stage = _Stager(device)
    adv_w = torch.full((), 1.0, dtype=torch.float32, device=device)
    warm = set()

    def with_noise(batch):
        x = batch[0]
        z = (noise_rs.rand(x.shape[0], x.shape[1], hp.generator_noise_dim)
             .astype(np.float32) if cfg.add_noise else None)
        return batch + (z,)

    def run_epoch(loader):
        """(seconds, valid frames, steps, steps in replays) of one epoch."""
        t0 = time.perf_counter()
        frames, steps, fused = 0.0, 0, 0
        batches = (with_noise(b) for b in loader)
        for group in dispatch_groups(
                batches, lambda b: (b[0].shape, b[1].shape), K, warm):
            R = r_cache.get(group[0][0].shape[1]) if r_cache is not None \
                else None
            run_dispatch(trainer, gstate, dstate, group, stage, R, adv_w,
                         gen, True)
            frames += sum(float(b[2].sum()) for b in group)
            steps += len(group)
            fused += len(group) if len(group) > 1 else 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, frames, steps, fused

    def make_loader(nw):
        # each setting its own iterator (its own epoch counter): the same
        # dataset and seed give both the same batch sequence
        return BatchIterator(base_ds, hp.batch_size, shuffle=True,
                             bucket_multiple=hp.batch_bucket_multiple,
                             num_workers=nw, cache_size=hp.cache_size)

    settings = ((0, make_loader(0)), (args.workers, make_loader(args.workers)))
    for _, it in settings:  # warm-up: one epoch each
        run_epoch(it)
    runs = {nw: [] for nw, _ in settings}
    for _ in range(args.epochs):
        for nw, it in settings:
            runs[nw].append(run_epoch(it))

    def summarize(rs):
        med = statistics.median(dt for dt, _, _, _ in rs)
        return {"median_epoch_s": med,
                "frames_per_sec": float(np.mean([f for _, f, _, _ in rs]))
                / med,
                "steps_per_epoch": rs[-1][2],
                "steps_in_replays_per_epoch": rs[-1][3]}

    out = {
        "metric": "streamed_epoch_throughput",
        "workload": f"{len(base_ds)} utts, batch {hp.batch_size}, "
                    f"{args.hparams_name}",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "steps_per_dispatch": K,
        "num_workers_0": summarize(runs[0]),
        f"num_workers_{args.workers}": summarize(runs[args.workers]),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
