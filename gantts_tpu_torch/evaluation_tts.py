"""Evaluation command line for GAN-based TTS models on the port (counterpart
of the repository's evaluation_tts.py):

    python -m gantts_tpu_torch.evaluation_tts [options] \\
        <acoustic_checkpoint> <duration_checkpoint> <data_dir> \\
        <labels_dir> <outputs_dir>

It takes evaluation_tts.py's flags (``--fs``, the reference's misspelt
``--disable-duraton-gen``, ``--post-filter``, ``--true-variance-mlpg``,
``--hparams_acoustic``, ``--hparams_duration``, ``--workers``) and adds
``--device`` (``cuda`` unless asked for ``cpu``).  Both checkpoints are
generator checkpoints of the port's training command line (``torch.save``;
the JAX package's msgpack checkpoints are not read).  ``data_dir`` holds
``X_acoustic`` and the stats that training saved for both models
(``X_{typ}_data_{min,max}.npy``, ``Y_{typ}_data_{mean,var}.npy``); the eval
and test utterances are re-derived from X_acoustic's files by the
reference's split, and each ``labels_dir/<name>.lab`` is synthesized into
``outputs_dir/{eval,test}/<name>.wav`` (int16).  ``outputs_dir/analysis.json``
compares the generated mel-cepstra's global variance and modulation
spectrum with those of ``data_dir/Y_acoustic``.
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import basename, join, splitext

import numpy as np
from scipy.io import wavfile


def get_lab_files(data_dir, label_dir, test=False):
    """The eval (or test) utterances' label paths, by the reference's split
    of the X_acoustic directory (evaluation_tts.py:26-33)."""
    from gantts_tpu_torch.data import NPYDataSource

    src = NPYDataSource(join(data_dir, "X_acoustic"), train=False, test=test)
    return [join(label_dir, splitext(basename(f))[0] + ".lab")
            for f in src.collect_files()]


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.evaluation_tts",
        description="Evaluation script for GAN-based TTS models on PyTorch")
    p.add_argument("acoustic_checkpoint")
    p.add_argument("duration_checkpoint")
    p.add_argument("data_dir")
    p.add_argument("labels_dir")
    p.add_argument("outputs_dir")
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--disable-duraton-gen", dest="disable_duration_gen",
                   action="store_true",
                   help="use the labels' own timings (no duration model)")
    p.add_argument("--post-filter", dest="post_filter", action="store_true",
                   help="Merlin's post-filter on the mel-cepstra")
    p.add_argument("--true-variance-mlpg", dest="true_variance_mlpg",
                   action="store_true",
                   help="MLPG with the training set's variances on the "
                        "denormalized features instead of unit variances "
                        "on the normalized ones")
    p.add_argument("--hparams_acoustic", default="")
    p.add_argument("--hparams_duration", default="")
    p.add_argument("--workers", type=int, default=1,
                   help="threads over utterances (the host vocoder chain "
                        "releases the GIL)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the generators (default: cuda)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.io import hts
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.synthesis import tts_from_label
    from gantts_tpu_torch.train.checkpoint import load_checkpoint
    from gantts_tpu_torch.utils.analysis import (
        run_utterance_jobs,
        write_analysis_report,
    )

    hp_acoustic = hparams.tts_acoustic.copy()
    hp_duration = hparams.tts_duration.copy()
    hp_acoustic.parse(args.hparams_acoustic)
    hp_duration.parse(args.hparams_duration)

    binary_dict, continuous_dict = hts.load_question_set(
        hp_acoustic.question_path)

    X_min, X_max, Y_mean, Y_std, models = {}, {}, {}, {}, {}
    for typ in ("acoustic", "duration"):
        X_min[typ] = np.load(join(args.data_dir, f"X_{typ}_data_min.npy"))
        X_max[typ] = np.load(join(args.data_dir, f"X_{typ}_data_max.npy"))
        Y_mean[typ] = np.load(join(args.data_dir, f"Y_{typ}_data_mean.npy"))
        Y_std[typ] = np.sqrt(
            np.load(join(args.data_dir, f"Y_{typ}_data_var.npy")))

        hp = hp_acoustic if typ == "acoustic" else hp_duration
        if hp.generator_params["in_dim"] is None:
            D = X_min[typ].shape[-1]
            if hp.generator_add_noise:
                D = D + hp.generator_noise_dim
            hp.generator_params["in_dim"] = D
        if hp.generator_params["out_dim"] is None:
            hp.generator_params["out_dim"] = Y_mean[typ].shape[-1]

        model = create_model(hp.generator, compute_dtype=hp.compute_dtype,
                             device=args.device, **hp.generator_params)
        ckpt = (args.acoustic_checkpoint if typ == "acoustic"
                else args.duration_checkpoint)
        state_dict, _, _ = load_checkpoint(ckpt)
        model.load_state_dict(state_dict, strict=True)
        models[typ] = model.eval()

    eval_dir = join(args.outputs_dir, "eval")
    test_dir = join(args.outputs_dir, "test")
    os.makedirs(eval_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    eval_files = get_lab_files(args.data_dir, args.labels_dir, test=False)
    test_files = get_lab_files(args.data_dir, args.labels_dir, test=True)

    def process(dst_dir, label_path):
        print(dst_dir, label_path)
        name = splitext(basename(label_path))[0]
        waveform, mgc, _, _, _ = tts_from_label(
            models, label_path, X_min, X_max, Y_mean, Y_std, hp_duration,
            hp_acoustic, binary_dict, continuous_dict,
            post_filter=args.post_filter,
            apply_duration_model=not args.disable_duration_gen, fs=args.fs,
            mge_training=not args.true_variance_mlpg)
        wavfile.write(join(dst_dir, name + ".wav"), args.fs,
                      waveform.astype(np.int16))
        return np.asarray(mgc)

    jobs = [(dst_dir, path)
            for dst_dir, files in [(eval_dir, eval_files),
                                   (test_dir, test_files)]
            for path in files]
    generated_mgc = run_utterance_jobs(process, jobs, args.workers)

    K = len(hp_acoustic.windows)
    write_analysis_report(
        join(args.outputs_dir, "analysis.json"), generated_mgc,
        natural_dir=join(args.data_dir, "Y_acoustic"),
        static_dim=hp_acoustic.stream_sizes[0] // K,
        modfs=1000.0 / hp_acoustic.frame_period)
    return 0


if __name__ == "__main__":
    sys.exit(main())
