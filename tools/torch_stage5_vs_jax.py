#!/usr/bin/env python3
"""Phase 10's tts_acoustic stage 5 in both packages, on the CPU, from the
same files: does the JAX package's first adversarial step diverge as the
port's does?

    python tools/torch_stage5_vs_jax.py [--utterances N] [--from DIR]
        [--work DIR] [--threads N]

1. Writes chip_smoke.py phase 10's TTS corpus (``write_tts_corpus``: wavs
   and state-aligned HTS labels, seed 0) and its features
   (``prepare_tts_features``: the port's prepare_features_tts in a
   subprocess).  ``--utterances`` cuts the corpus (24, phase 10's, by
   default); the cut is printed.
2. Trains stages 1-3 of the curriculum for tts_acoustic in its own float32
   (baseline to epoch 2, generator warm-up 1 epoch, discriminator warm-up 1
   epoch: phase 10's command) with the port on the CPU, or, with ``--from
   DIR``, takes ``DIR/gan/checkpoint_epoch1_{Generator,Discriminator}.pth``
   that a card run wrote on the same corpus.
3. Writes the JAX package's twins of the warm-up checkpoints
   (chip_smoke.write_jax_twin, as phase 11 does).
4. Runs stage 5's first adversarial epoch (epoch 2, one train and one test
   step at phase 10's size) from them twice: in the port on the CPU (the
   curriculum's stage with ``--device cpu``), and in the JAX package on the
   CPU (the repository's train.py with the argv train_gan.sh gives stage 5,
   ``curriculum.stage_argvs``, platform pinned to the CPU).

For each side it prints adv_w (w_d * clip(E(mge) / E(adv), 0, 1e3), 1 at a
stage's first epoch) and the E(mge)/E(adv) that the epoch logs, the
generator's largest |output| (normalized units, over valid frames, eval
mode) before and after the first adversarial step, the frames the
generator and the data both call voiced (co-voiced), and the logged test
f0_rmse.  The generators of both sides are read and run by the port (it
reads the JAX package's files), so the numbers are taken alike.  The last
line is one JSON object of these numbers.

The dropout masks of the two packages come from different generators, so
the two steps are not expected to agree in their bits: the question is
whether the JAX package blows up alike (on an NVIDIA H100 80GB HBM3 at
700 W the port's phase 10 read 2.3 -> 601).  This script imports both
packages; it is a tool, not part of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from os.path import join

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SPEC = "compute_dtype=float32"  # phase 10's tts_acoustic
EPOCHS = ("1", "1", "1", "2")  # G warm-up, D warm-up, spoofing, total


def curriculum_args(xdir, ydir, ck, device):
    return ["tts_acoustic", SPEC, xdir, ydir, ck, *EPOCHS,
            f"--device={device}"]


def run_port_stages(feats, ck, stages, **env):
    """The port's curriculum on the CPU with only ``stages`` switched
    on, and the environment switches ``env``."""
    import chip_smoke
    from gantts_tpu_torch import curriculum

    switches = {switch: "1" if stage in stages else "0"
                for stage, (switch, _) in curriculum.STAGES.items()}
    switches.update(env)
    argv = curriculum_args(join(feats, "X_acoustic"),
                           join(feats, "Y_acoustic"), ck, "cpu")
    t0 = time.perf_counter()
    rc = curriculum.main(argv, env=chip_smoke.curriculum_env(**switches))
    if rc != 0:
        raise SystemExit(f"the port's curriculum exited {rc}")
    print(f"port: stages {', '.join(stages)} in "
          f"{time.perf_counter() - t0:.1f} s (CPU)", flush=True)


def run_jax_stage5(feats, ck):
    """train.py with stage 5's argv from the JAX twins, on the CPU."""
    from gantts_tpu_torch import curriculum

    args = curriculum.build_arg_parser().parse_args(curriculum_args(
        join(feats, "X_acoustic"), join(feats, "Y_acoustic"), ck, "cpu"))
    (_, argv), = curriculum.stage_argvs(args, {
        "RUN_BASELINE": "0", "RUN_GENERATOR_WARMUP": "0",
        "RUN_DISCRIMINATOR_WARMUP": "0", "RUN_ADVERSARIAL": "1"})
    argv = [a.replace("_Generator.pth", "_Generator_jax.pth")
            .replace("_Discriminator.pth", "_Discriminator_jax.pth")
            for a in argv]
    env = dict(os.environ, JAX_PLATFORMS="cpu", GANTTS_TPU_PLATFORM="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, join(REPO, "train.py"), *argv],
                          cwd=REPO, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
        raise SystemExit(f"train.py exited {proc.returncode}")
    print(f"jax: stage 5 in {time.perf_counter() - t0:.1f} s (CPU): "
          f"train.py {' '.join(argv)}", flush=True)


def logged(ck):
    with open(join(ck, "gan", "log", "scalars.jsonl")) as f:
        return {(r["tag"], r["step"]): r["value"]
                for r in map(json.loads, f)}


def generator_readings(feats, paths):
    """For each generator ({label: checkpoint}), in eval mode over both
    splits: the largest |output| (normalized) on valid frames, the frames
    it calls voiced and the co-voiced frames."""
    import torch

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.core.masking import sequence_mask
    from gantts_tpu_torch.core.streams import get_static_features
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.checkpoint import load_checkpoint
    from gantts_tpu_torch.train.loop import RMatrixCache
    from gantts_tpu_torch.train.setup import load_arrays, prepare_tts
    from gantts_tpu_torch.train.step import _split_streams_inv_scale

    hp = hparams.tts_acoustic.copy()
    hp.parse(SPEC)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        X, Y, lengths = load_arrays(join(feats, "X_acoustic"),
                                    join(feats, "Y_acoustic"))
        loaders, y_mean, y_std = prepare_tts(X, Y, lengths, hp, feats)
    cfg = StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True, True)
    trainer = GanTrainer(cfg, y_mean, y_std, "cpu")
    r_cache = RMatrixCache(hp.windows, "cpu")
    splits = {phase: [tuple(torch.as_tensor(a) for a in b)
                      for b in loaders[phase]] for phase in ("train", "test")}
    found = {}
    for label, path in paths.items():
        model = create_model(hp.generator, compute_dtype=hp.compute_dtype,
                             device="cpu", **hp.generator_params).eval()
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            model.load_state_dict(load_checkpoint(path)[0])
        found[label] = {}
        for split, batches in splits.items():
            got = dict(frames=0, voiced=0, covoiced=0, out=0.0)
            with torch.no_grad():
                for x, y, lh in batches:
                    T = x.shape[1]
                    y_hat, y_hat_static = trainer._gen_forward(
                        model, x, r_cache.get(T), lh, None)
                    y_static = get_static_features(
                        y, cfg.num_windows, cfg.stream_sizes,
                        cfg.has_dynamic_features)
                    vuv = _split_streams_inv_scale(
                        y_static, trainer.Y_mean, trainer.Y_std, cfg)[2]
                    vuv_h = _split_streams_inv_scale(
                        y_hat_static, trainer.Y_mean, trainer.Y_std, cfg)[2]
                    mask = sequence_mask(lh, T)[..., None]
                    valid = mask[..., 0] > 0.5
                    got["frames"] += int(valid.sum())
                    got["voiced"] += int(((vuv_h > 0.5) & valid).sum())
                    got["covoiced"] += int(((vuv > 0.5) & (vuv_h > 0.5)
                                            & valid).sum())
                    got["out"] = max(got["out"], float(
                        (y_hat.abs() * mask).max()))
            found[label][split] = got
    return found


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--utterances", type=int, default=None,
                   help="cut phase 10's corpus to this many utterances")
    p.add_argument("--from", dest="from_dir", default=None,
                   help="a checkpoint directory whose gan/ holds the "
                        "warm-up checkpoints of a card run")
    p.add_argument("--work", default=None,
                   help="keep the corpus and checkpoints here")
    p.add_argument("--threads", type=int, default=4,
                   help="CPU threads for the port's steps")
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from gantts_tpu_torch import hparams

    torch.set_num_threads(args.threads)
    n = args.utterances or chip_smoke.TTS_UTTERANCES
    if n != chip_smoke.TTS_UTTERANCES:
        print(f"corpus cut: {n} utterances, not phase 10's "
              f"{chip_smoke.TTS_UTTERANCES}")
        chip_smoke.TTS_UTTERANCES = n  # prepare_tts_features checks it
    work = args.work or tempfile.mkdtemp(prefix="stage5_")
    root, feats = join(work, "corpus"), join(work, "feats")
    if not os.path.isdir(feats):
        chip_smoke.write_tts_corpus(root, num=n)
        chip_smoke.prepare_tts_features("cpu", root, feats)
    ck = join(work, "ck")
    warm = [join(ck, "gan", f"checkpoint_epoch1_{name}.pth")
            for name in ("Generator", "Discriminator")]
    if args.from_dir is not None:
        os.makedirs(join(ck, "gan"), exist_ok=True)
        for path in warm:
            shutil.copy(join(args.from_dir, "gan", os.path.basename(path)),
                        path)
        print(f"warm-up checkpoints from {args.from_dir}")
    elif not all(os.path.exists(path) for path in warm):
        run_port_stages(feats, ck, ("baseline", "generator_warmup",
                                    "discriminator_warmup"))
    hp = hparams.tts_acoustic
    for path, name, params in zip(warm, (hp.optimizer_g, hp.optimizer_d),
                                  (hp.optimizer_g_params,
                                   hp.optimizer_d_params)):
        chip_smoke.write_jax_twin(path, name, params)
    sides = {}
    for side in ("port", "jax", "port, w_d=0"):
        side_ck = join(work, "ck_" + side.replace(", ", "_"))
        shutil.rmtree(side_ck, ignore_errors=True)
        os.makedirs(join(side_ck, "gan"))
        for f in os.listdir(join(ck, "gan")):
            if f.startswith("checkpoint_epoch1_"):
                shutil.copy(join(ck, "gan", f), join(side_ck, "gan", f))
        if side == "jax":
            run_jax_stage5(feats, side_ck)
        else:
            run_port_stages(feats, side_ck, ("adversarial",),
                            W_D="0" if side.endswith("w_d=0") else "1.0")
        sides[side] = side_ck
    paths = {"warm-up": warm[0]}
    paths.update({side: join(side_ck, "gan", "checkpoint_epoch2_Generator."
                             "pth") for side, side_ck in sides.items()})
    readings = generator_readings(feats, paths)
    result = {"utterances": n, "warm-up": readings["warm-up"]}
    for side, side_ck in sides.items():
        rows = logged(side_ck)
        nan = float("nan")  # the control logs no expectations
        e_mge, e_adv = rows.get(("E(mge)", 2), nan), rows.get(("E(adv)", 2),
                                                               nan)
        ratio = rows.get(("MGE/ADV loss weight", 2), nan)
        result[side] = dict(
            adv_w=0.0 if side.endswith("w_d=0") else 1.0, e_mge=e_mge, e_adv=e_adv, e_mge_over_e_adv=ratio,
            next_adv_w=min(max(ratio, 0.0), 1e3),
            test_f0_rmse=rows[("test f0_rmse metric", 2)],
            train_f0_rmse=rows[("train f0_rmse metric", 2)],
            after=readings[side])
        before, after = readings["warm-up"], readings[side]
        print(f"{side}: epoch 2 (the first adversarial step) took adv_w "
              f"{result[side]['adv_w']} and logged E(mge) {e_mge!r}, E(adv) {e_adv!r}, "
              f"E(mge)/E(adv) {ratio!r} (epoch 3's adv_w "
              f"{min(max(ratio, 0.0), 1e3)!r}); largest |output| "
              f"(normalized, train split) {before['train']['out']!r} -> "
              f"{after['train']['out']!r}, test split "
              f"{before['test']['out']!r} -> {after['test']['out']!r}; "
              f"co-voiced frames train {before['train']['covoiced']} -> "
              f"{after['train']['covoiced']} of {after['train']['frames']}, "
              f"test {before['test']['covoiced']} -> "
              f"{after['test']['covoiced']} of {after['test']['frames']}; "
              f"test f0_rmse {result[side]['test_f0_rmse']!r}")
        if not math.isfinite(after["train"]["out"]):
            print(f"{side}: the generator's output is not finite")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
