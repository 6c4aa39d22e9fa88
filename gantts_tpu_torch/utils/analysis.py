"""Quantitative analyses from the reference's evaluation notebooks.

The reference publishes its quality evidence as notebook plots
(notebooks/Test VC.ipynb, Test RNN VC.ipynb; SURVEY.md section 4): global
variance (GV) of the mel-cepstra and modulation spectra of natural vs
generated features.  These are their computational cores as library
functions so any experiment can log them.
"""

from __future__ import annotations

import numpy as np


def global_variance(features):
    """Per-dimension global variance over all frames of one or more
    utterances.  ``features``: (T, D) or list of (T, D).  GAN training is
    expected to push generated GV toward natural GV (Saito 2017's key
    metric)."""
    if isinstance(features, (list, tuple)):
        features = np.concatenate([np.asarray(f) for f in features], axis=0)
    return np.var(np.asarray(features, dtype=np.float64), axis=0)


def modulation_spectrum(features, modfs, n=4096):
    """Mean log modulation spectrum per dimension.

    Returns (freqs, log_ms) with ``log_ms`` shape (n//2+1, D): the log power
    of the temporal DFT of each trajectory dimension — adversarial training
    should recover the high-band modulation energy that MGE-only training
    oversmooths."""
    from gantts_tpu_torch.preprocessing import modspec

    if isinstance(features, (list, tuple)):
        specs = [modspec(np.asarray(f, dtype=np.float64), n=n)
                 for f in features]
        ms = np.mean(specs, axis=0)
    else:
        ms = modspec(np.asarray(features, dtype=np.float64), n=n)
    freqs = np.fft.rfftfreq(n, d=1.0 / modfs)
    return freqs, np.log(np.maximum(ms, 1e-30))


def _hi_band_db(features, modfs):
    freqs, ms = modulation_spectrum(features, modfs)
    hi = (freqs >= 25.0) & (freqs <= 50.0)
    return float(10.0 / np.log(10.0) * np.mean(ms[hi]))


def _modspec_curve_db(features, modfs, n_points=128):
    """Mean-over-dimensions log modulation spectrum, downsampled to
    ``n_points`` frequencies — small enough to live in analysis.json, dense
    enough for tools/report.py to plot."""
    freqs, ms = modulation_spectrum(features, modfs)
    curve = 10.0 / np.log(10.0) * ms.mean(axis=1)
    idx = np.linspace(0, len(freqs) - 1, n_points).astype(int)
    return freqs[idx], curve[idx]


def write_analysis_report(path, generated, natural_dir, static_dim, modfs):
    """GV + modulation-spectrum comparison of generated statics vs the
    natural training targets, written as ``analysis.json`` next to every
    synthesis run (shared by evaluation_vc.py and evaluation_tts.py).

    Besides the scalar summaries, the report carries the per-dimension GV
    arrays and the (downsampled) modulation-spectrum curves so
    ``tools/report.py`` can render the reference notebooks' comparison
    figures (notebooks/Test VC.ipynb) from the JSON alone."""
    import json
    from glob import glob
    from os.path import join

    report = {}
    if generated:
        gen = [g[:, :static_dim] for g in generated]
        gv_gen = global_variance(gen)
        report["gv_generated_mean"] = float(np.mean(gv_gen))
        report["modspec_generated_hi_band_db"] = _hi_band_db(gen, modfs)
        report["gv_generated"] = [float(v) for v in gv_gen]
        freqs, curve = _modspec_curve_db(gen, modfs)
        report["modspec_freqs_hz"] = [round(float(f), 3) for f in freqs]
        report["modspec_generated_db"] = [round(float(v), 4) for v in curve]
    try:
        nat = [np.load(f)[:, :static_dim]
               for f in sorted(glob(join(natural_dir, "*.npy")))[:50]]
        if nat:
            gv_nat = global_variance(nat)
            report["gv_natural_mean"] = float(np.mean(gv_nat))
            report["modspec_natural_hi_band_db"] = _hi_band_db(nat, modfs)
            report["gv_natural"] = [float(v) for v in gv_nat]
            freqs, curve = _modspec_curve_db(nat, modfs)
            report.setdefault("modspec_freqs_hz",
                              [round(float(f), 3) for f in freqs])
            report["modspec_natural_db"] = [round(float(v), 4)
                                            for v in curve]
            if "gv_generated_mean" in report:
                report["gv_ratio"] = (report["gv_generated_mean"]
                                      / max(report["gv_natural_mean"], 1e-30))
    except (OSError, ValueError):
        pass
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print("analysis ->", path,
          {k: v for k, v in report.items() if not isinstance(v, list)})


def run_in_processes(fn, jobs, workers):
    """``[fn(*job) for job in jobs]``, in this process when ``workers`` <= 1,
    else over ``workers`` spawned processes (fresh interpreters: safe in a
    process that holds CUDA or threads, which a fork is not).  ``fn`` and
    the jobs must pickle; the feature extraction's per-utterance work is
    Python-bound (regex questions, freqt) and gains nothing from threads.
    A caller whose ``__main__`` runs this without the ``if __name__ ==
    "__main__"`` guard gets BrokenProcessPool, not a hang."""
    if workers <= 1:
        return [fn(*job) for job in jobs]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(fn, *job) for job in jobs]
        return [f.result() for f in futures]


def run_utterance_jobs(process, jobs, workers):
    """Run ``process(*job)`` over every job, thread-fanned when workers > 1
    (the per-utterance eval work is C++/BLAS-bound, so threads scale)."""
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(lambda j: process(*j), jobs))
    return [process(*j) for j in jobs]
