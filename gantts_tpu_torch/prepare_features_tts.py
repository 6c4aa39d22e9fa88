"""Feature extraction for TTS training on the port (counterpart of the
repository's prepare_features_tts.py):

    python -m gantts_tpu_torch.prepare_features_tts [options] <DATA_ROOT>

It takes prepare_features_tts.py's flags (``--max_files``, ``--dst_dir``,
``--overwrite``, ``--workers``, ``--question_path``, ``--hparams_acoustic``,
``--hparams_duration``) and writes the same files.  DATA_ROOT is in the
Merlin slt_arctic layout, ``wav/*.wav`` and ``label_state_align/*.lab``
(``label_phone_align`` with ``use_phone_alignment=True``); the outputs are
one float32 .npy per utterance in ``X_duration/`` (phone-level linguistic
features), ``Y_duration/`` (state durations), ``X_acoustic/`` (frame-level
linguistic features with the 9 subphone features) and ``Y_acoustic/``
(mgc, lf0, vuv and bap with their deltas), silences deleted.

All of it is host work in float64 (the port's WORLD/SPTK, with the C++
engine where it builds); nothing here touches a GPU.  ``--workers``
processes share the utterances; they are spawned, not forked, so ``main``
may run in a process that holds CUDA.  One worker runs in this process.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from os.path import basename, exists, join, splitext

import numpy as np
from scipy.io import wavfile


def _label_files(data_root, use_phone_alignment, max_files):
    d = "label_phone_align" if use_phone_alignment else "label_state_align"
    files = sorted(glob(join(data_root, d, "*.lab")))
    if max_files is not None and max_files > 0:
        files = files[:max_files]
    return files


def extract_linguistic(path, question_path, add_frame_features,
                       subphone_features):
    """Phone- or frame-level linguistic features of one label file, silences
    deleted (the reference's LinguisticSource, prepare_features_tts.py:36-67)."""
    from gantts_tpu_torch.io import hts, merlin

    binary_dict, continuous_dict = hts.load_question_set(question_path)
    labels = hts.load(path)
    feats = merlin.linguistic_features(
        labels, binary_dict, continuous_dict,
        add_frame_features=add_frame_features,
        subphone_features=subphone_features)
    if add_frame_features:
        indices = labels.silence_frame_indices()
    else:
        indices = labels.silence_phone_indices()
    feats = np.delete(feats, indices[indices < len(feats)], axis=0)
    return feats.astype(np.float32)


def extract_duration(path):
    """Per-phone state durations of one label file, silent phones deleted
    (the reference's DurationSource, prepare_features_tts.py:70-89)."""
    from gantts_tpu_torch.io import hts, merlin

    labels = hts.load(path)
    feats = merlin.duration_features(labels)
    indices = labels.silence_phone_indices()
    feats = np.delete(feats, indices[indices < len(feats)], axis=0)
    return feats.astype(np.float32)


def extract_acoustic(wav_path, label_path, hp):
    """The whole WORLD chain for one utterance (the reference's
    AcousticSource, prepare_features_tts.py:92-157): F0 (Harvest, or DIO
    and StoneMask), the envelope as mel-cepstra, coded aperiodicity, log F0
    interpolated through unvoiced frames, V/UV, modulation-spectrum
    smoothing and deltas; cut to the label's frames, silences deleted."""
    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.frontend import sptk, world
    from gantts_tpu_torch.io import hts

    fs, x = wavfile.read(wav_path)
    x = x.astype(np.float64)
    if hp.use_harvest:
        f0, timeaxis = world.harvest(
            x, fs, frame_period=hp.frame_period,
            f0_floor=hp.f0_floor, f0_ceil=hp.f0_ceil)
    else:
        f0, timeaxis = world.dio(
            x, fs, frame_period=hp.frame_period,
            f0_floor=hp.f0_floor, f0_ceil=hp.f0_ceil)
        f0 = world.stonemask(x, f0, timeaxis, fs)
    spectrogram = world.cheaptrick(x, f0, timeaxis, fs)
    aperiodicity = world.d4c(x, f0, timeaxis, fs)

    bap = world.code_aperiodicity(aperiodicity, fs)
    alpha = sptk.mcepalpha(fs)
    mgc = sptk.sp2mc(spectrogram, order=hp.order, alpha=alpha)
    f0 = f0[:, None]
    lf0 = f0.copy()
    nonzero = np.nonzero(f0)
    lf0[nonzero] = np.log(f0[nonzero])
    if hp.use_harvest:
        # Harvest's contour can carry F0 through frames WORLD finds
        # aperiodic: V/UV comes from the 0-Hz aperiodicity band instead
        # (prepare_features_tts.py:131-135)
        vuv = (aperiodicity[:, 0] < 0.5).astype(np.float32)[:, None]
    else:
        vuv = (lf0 != 0).astype(np.float32)
    lf0 = P.interp1d(lf0, kind=hp.f0_interpolation_kind)

    if hp.mod_spec_smoothing:
        hop_length = int(fs * (hp.frame_period * 0.001))
        mgc = P.modspec_smoothing(
            mgc, fs / hop_length, cutoff=hp.mod_spec_smoothing_cutoff)

    mgc = P.delta_features(mgc, hp.windows)
    lf0 = P.delta_features(lf0, hp.windows)
    bap = P.delta_features(bap, hp.windows)

    features = np.hstack((mgc, lf0, vuv, bap))

    labels = hts.load(label_path)
    features = features[: labels.num_frames()]
    indices = labels.silence_frame_indices()
    features = np.delete(features, indices[indices < len(features)], axis=0)
    return features.astype(np.float32)


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.prepare_features_tts",
        description="Prepare duration and acoustic features for TTS")
    p.add_argument("DATA_ROOT")
    p.add_argument("--max_files", type=int, default=-1)
    p.add_argument("--dst_dir", default="data/cmu_arctic_tts")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--workers", type=int, default=0,
                   help="processes over utterances (default: one per CPU)")
    p.add_argument("--question_path", default=None,
                   help="Merlin .hed question set (overrides hparams)")
    p.add_argument("--hparams_acoustic", default="")
    p.add_argument("--hparams_duration", default="")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.utils.analysis import run_in_processes

    hp_acoustic = hparams.tts_acoustic.copy()
    hp_duration = hparams.tts_duration.copy()
    hp_acoustic.parse(args.hparams_acoustic)
    hp_duration.parse(args.hparams_duration)
    if args.question_path:
        hp_acoustic.question_path = args.question_path
        hp_duration.question_path = args.question_path
    if hp_acoustic.question_path != hp_duration.question_path:
        raise ValueError("the acoustic and duration bundles name different "
                         "question sets")
    if hp_acoustic.use_phone_alignment != hp_duration.use_phone_alignment:
        raise ValueError("the acoustic and duration bundles disagree on "
                         "use_phone_alignment")

    label_files = _label_files(args.DATA_ROOT,
                               hp_acoustic.use_phone_alignment,
                               args.max_files)
    wav_files = sorted(glob(join(args.DATA_ROOT, "wav", "*.wav")))
    if args.max_files > 0:
        wav_files = wav_files[:args.max_files]

    roots = {k: join(args.dst_dir, k) for k in
             ("X_duration", "Y_duration", "X_acoustic", "Y_acoustic")}
    skip_dur = exists(roots["X_duration"]) and exists(roots["Y_duration"])
    skip_ac = exists(roots["X_acoustic"]) and exists(roots["Y_acoustic"])
    if args.overwrite:
        skip_dur = skip_ac = False
    for d in roots.values():
        os.makedirs(d, exist_ok=True)

    workers = args.workers or os.cpu_count() or 1

    def linguistic(hp):
        return run_in_processes(
            extract_linguistic,
            [(f, hp.question_path, hp.add_frame_features,
              hp.subphone_features) for f in label_files], workers)

    if not skip_dur:
        X = linguistic(hp_duration)
        Y = run_in_processes(extract_duration, [(f,) for f in label_files],
                             workers)
        print("Duration linguistic feature dim", X[0].shape[-1])
        print("Duration feature dim", Y[0].shape[-1])
        for f, x, y in zip(label_files, X, Y):
            name = splitext(basename(f))[0]
            np.save(join(roots["X_duration"], name), x)
            np.save(join(roots["Y_duration"], name), y)
    else:
        print("Features for duration model training found, skipping.")

    if not skip_ac:
        X = linguistic(hp_acoustic)
        Y = run_in_processes(
            extract_acoustic,
            [(w, f, hp_acoustic) for w, f in zip(wav_files, label_files)],
            workers)
        print("Acoustic linguistic feature dim", X[0].shape[-1])
        print("Acoustic feature dim", Y[0].shape[-1])
        for f, x, y in zip(label_files, X, Y):
            name = splitext(basename(f))[0]
            # HTS label timings and WORLD frame counts can differ by a frame
            T = min(len(x), len(y))
            np.save(join(roots["X_acoustic"], name), x[:T])
            np.save(join(roots["Y_acoustic"], name), y[:T])
    else:
        print("Features for acoustic model training found, skipping.")

    print("Finished!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
