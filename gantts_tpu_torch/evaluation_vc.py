"""Evaluation command line for GAN-based VC models on the port (counterpart
of the repository's evaluation_vc.py):

    python -m gantts_tpu_torch.evaluation_vc [options] <checkpoint> \\
        <data_dir> <wav_dir> <outputs_dir>

It takes evaluation_vc.py's flags (``--diffvc``, ``--hparams``,
``--workers``) and adds ``--device`` (``cuda`` unless asked for ``cpu``).
``checkpoint`` is a generator checkpoint of the port's training command line
(``torch.save``) or of the JAX package's (flax msgpack); a legacy pickle
checkpoint is refused (``train/checkpoint.py``).
``data_dir`` holds the X directory and the normalization stats
(``data_mean.npy``, ``data_var.npy``) that training saved; the eval and
test utterances are re-derived from X's files by the reference's split, and
each is converted from ``wav_dir/<name>.wav`` into
``outputs_dir/{eval,test}/<name>.wav`` (int16).  ``outputs_dir/analysis.json``
compares the generated static mel-cepstra's global variance and modulation
spectrum with those of ``data_dir/Y``.
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import basename, join, splitext

import numpy as np
from scipy.io import wavfile


def get_wav_files(data_dir, wav_dir, test=False):
    """The eval (or test) utterances' wav paths, by the reference's split of
    the X directory (evaluation_vc.py:121-129)."""
    from gantts_tpu_torch.data import NPYDataSource

    if test:
        files = NPYDataSource(join(data_dir, "X"), test=True).collect_files()
    else:
        files = NPYDataSource(join(data_dir, "X"),
                              train=False).collect_files()
    return [join(wav_dir, splitext(basename(f))[0] + ".wav") for f in files]


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.evaluation_vc",
        description="Evaluation script for GAN-based VC models on PyTorch")
    p.add_argument("checkpoint")
    p.add_argument("data_dir")
    p.add_argument("wav_dir")
    p.add_argument("outputs_dir")
    p.add_argument("--diffvc", action="store_true",
                   help="spectral-differential MLSA filtering of the source "
                        "waveform, keeping its excitation")
    p.add_argument("--hparams", default="",
                   help="hparams overrides (vc bundle)")
    p.add_argument("--workers", type=int, default=1,
                   help="threads over utterances (the host vocoder chain "
                        "releases the GIL)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the generator (default: cuda)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.synthesis import vc_from_waveform
    from gantts_tpu_torch.train.checkpoint import load_checkpoint
    from gantts_tpu_torch.utils.analysis import (
        run_utterance_jobs,
        write_analysis_report,
    )

    hp = hparams.vc.copy()
    hp.parse(args.hparams)

    data_mean = np.load(join(args.data_dir, "data_mean.npy"))
    data_var = np.load(join(args.data_dir, "data_var.npy"))
    data_std = np.sqrt(data_var)

    if hp.generator_params["in_dim"] is None:
        hp.generator_params["in_dim"] = data_mean.shape[-1]
    if hp.generator_params["out_dim"] is None:
        hp.generator_params["out_dim"] = data_mean.shape[-1]

    model = create_model(hp.generator, compute_dtype=hp.compute_dtype,
                         device=args.device, **hp.generator_params)
    state_dict, _, _ = load_checkpoint(args.checkpoint)
    model.load_state_dict(state_dict, strict=True)
    model.eval()

    eval_dir = join(args.outputs_dir, "eval")
    test_dir = join(args.outputs_dir, "test")
    os.makedirs(eval_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    eval_files = get_wav_files(args.data_dir, args.wav_dir, test=False)
    test_files = get_wav_files(args.data_dir, args.wav_dir, test=True)

    def process(dst_dir, path):
        print(dst_dir, path)
        name = splitext(basename(path))[0]
        fs, x = wavfile.read(path)
        waveform, _, outputs = vc_from_waveform(
            model, x.astype(np.float64), fs, data_mean, data_std, hp,
            diffvc=args.diffvc)
        peak = np.max(np.abs(waveform))
        if peak > 32767:
            waveform = waveform / peak * 32767 * 0.99
        wavfile.write(join(dst_dir, name + ".wav"), fs,
                      waveform.astype(np.int16))
        return np.asarray(outputs)

    jobs = [(dst_dir, path)
            for dst_dir, files in [(eval_dir, eval_files),
                                   (test_dir, test_files)]
            for path in files]
    generated_feats = run_utterance_jobs(process, jobs, args.workers)

    write_analysis_report(
        join(args.outputs_dir, "analysis.json"), generated_feats,
        natural_dir=join(args.data_dir, "Y"), static_dim=hp.order,
        modfs=1000.0 / hp.frame_period)
    return 0


if __name__ == "__main__":
    sys.exit(main())
