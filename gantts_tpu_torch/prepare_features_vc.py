"""Feature extraction for one-to-one voice conversion on the port
(counterpart of the repository's prepare_features_vc.py):

    python -m gantts_tpu_torch.prepare_features_vc [options] \\
        <DATA_ROOT> <source_speaker> <target_speaker>

It takes prepare_features_vc.py's flags (``--max_files``, ``--dst_dir``,
``--overwrite``, ``--workers``) and writes the same files: for each
parallel pair, the source's and the target's mel-cepstra (the vc bundle's
order, without the power term, modulation-spectrum smoothed, with deltas),
aligned by exact DTW, trailing zero frames trimmed and both padded to one
even length, as ``dst_dir/X/<source name>.npy`` and ``dst_dir/Y/<target
name>.npy``.  DATA_ROOT is in the CMU ARCTIC layout,
``cmu_us_<speaker>_arctic/wav/*.wav`` (or ``<speaker>/*.wav``,
``<speaker>/wav/*.wav``).

All of it is host work in float64 (the port's WORLD/SPTK and DTW, with the
C++ engine where it builds); nothing here touches a GPU.  ``--workers``
processes share the analysis; they are spawned, not forked, so ``main`` may
run in a process that holds CUDA.  One worker runs in this process.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from os.path import basename, exists, join, splitext

import numpy as np
from scipy.io import wavfile


def collect_wav_files(data_root, speaker, max_files):
    """CMU ARCTIC layout: <root>/cmu_us_<spk>_arctic/wav/*.wav, with plain
    <root>/<spk>/*.wav and <root>/<spk>/wav/*.wav fallbacks."""
    cands = [join(data_root, f"cmu_us_{speaker}_arctic", "wav", "*.wav"),
             join(data_root, speaker, "*.wav"),
             join(data_root, speaker, "wav", "*.wav")]
    for pat in cands:
        files = sorted(glob(pat))
        if files:
            break
    if not files:
        raise FileNotFoundError(
            f"No wavs for speaker {speaker!r} under {data_root} "
            f"(tried {cands})")
    if max_files is not None and max_files > 0:
        files = files[:max_files]
    return files


def extract_mgc(wav_path):
    """WORLD mel-cepstra of one wav (the reference's MGCSource,
    prepare_features_vc.py:43-61): DIO and StoneMask, CheapTrick, trailing
    zero frames trimmed, sp2mc, the 0th coefficient dropped, 50 Hz
    modulation-spectrum smoothing, deltas."""
    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.frontend import sptk, world
    from gantts_tpu_torch.hparams import vc as hp

    fs, x = wavfile.read(wav_path)
    x = x.astype(np.float64)
    f0, timeaxis = world.dio(x, fs, frame_period=hp.frame_period)
    f0 = world.stonemask(x, f0, timeaxis, fs)
    spectrogram = world.cheaptrick(x, f0, timeaxis, fs)
    spectrogram = P.trim_zeros_frames(spectrogram)
    alpha = sptk.mcepalpha(fs)
    mgc = sptk.sp2mc(spectrogram, order=hp.order, alpha=alpha)
    mgc = mgc[:, 1:]  # drop the 0th coefficient
    hop_length = int(fs * (hp.frame_period * 0.001))
    mgc = P.modspec_smoothing(mgc, fs / hop_length, cutoff=50)
    mgc = P.delta_features(mgc, hp.windows)
    return mgc.astype(np.float32)


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.prepare_features_vc",
        description="Prepare aligned mel-cepstra for one-to-one VC")
    p.add_argument("DATA_ROOT")
    p.add_argument("source_speaker")
    p.add_argument("target_speaker")
    p.add_argument("--max_files", type=int, default=100)
    p.add_argument("--dst_dir", default="data/cmu_arctic_vc")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--workers", type=int, default=0,
                   help="processes over utterances (default: one per CPU)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.utils.analysis import run_in_processes

    skip = exists(join(args.dst_dir, "X")) and exists(join(args.dst_dir, "Y"))
    if args.overwrite:
        skip = False
    if skip:
        print("Features seem to be prepared, skipping feature extraction.")
        return 0

    src_files = collect_wav_files(args.DATA_ROOT, args.source_speaker,
                                  args.max_files)
    tgt_files = collect_wav_files(args.DATA_ROOT, args.target_speaker,
                                  args.max_files)
    n = min(len(src_files), len(tgt_files))
    src_files, tgt_files = src_files[:n], tgt_files[:n]

    for d in ("X", "Y"):
        os.makedirs(join(args.dst_dir, d), exist_ok=True)

    workers = args.workers or os.cpu_count() or 1
    print(f"Extracting WORLD features for {n} pairs with {workers} workers")
    X = run_in_processes(extract_mgc, [(f,) for f in src_files], workers)
    Y = run_in_processes(extract_mgc, [(f,) for f in tgt_files], workers)

    # padded into (N, Tmax, D), the aligner's contract
    Tmax = max(max(len(a) for a in X), max(len(b) for b in Y))
    D = X[0].shape[1]
    Xp = np.zeros((n, Tmax, D), np.float32)
    Yp = np.zeros((n, Tmax, D), np.float32)
    for i in range(n):
        Xp[i, : len(X[i])] = X[i]
        Yp[i, : len(Y[i])] = Y[i]

    print("Perform alignment")
    Xa, Ya = P.DTWAligner().transform((Xp, Yp))

    print("Save features to disk")
    for idx in range(n):
        src_name = splitext(basename(src_files[idx]))[0]
        tgt_name = splitext(basename(tgt_files[idx]))[0]
        x = P.trim_zeros_frames(Xa[idx])
        y = P.trim_zeros_frames(Ya[idx])
        x, y = P.adjust_frame_lengths(x, y, pad=True, divisible_by=2)
        np.save(join(args.dst_dir, "X", src_name), x)
        np.save(join(args.dst_dir, "Y", tgt_name), y)
    print("Finished!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
