#!/usr/bin/env python3
"""Copy-synthesis fidelity benchmark of the port's WORLD-equivalent vocoder
(gantts_tpu_torch/frontend/world.py and sptk.py, the C++ engine loaded by
frontend/native.py): the counterpart of tools/copy_synthesis_bench.py,
whose signals, metrics, conditions and result keys it keeps.

Generates synthetic speech-like test signals with KNOWN ground truth (f0
contour incl. vibrato + unvoiced segments, formant filter), runs the full
analysis chain (f0 -> cheaptrick -> d4c), then:

  * F0 accuracy:  RMSE (Hz, over co-voiced frames) + V/UV error rate of
    dio+stonemask and harvest against the known contour;
  * Copy-synthesis MCD: mel-cepstral distortion between the original and
    the analysis->synthesis round trip (dB, c1..c24, co-analyzed);
  * Spectral envelope error: mean abs log-spectral distance between
    cheaptrick output and the known filter response over voiced frames.

Writes vocoder_fidelity_torch.json at the repository root.  Where
nvidia-smi names a card, the ``workload`` text also names it and the
machine's numpy and scipy, so that a file written on the card's machine
says where it came from; elsewhere the JSON is the JAX tool's, key for key.
The front end's engine (native or NumPy) goes to standard error.
tests/test_torch_vocoder_fidelity.py holds the two tools' JSON equal and
the committed file within 1e-3 of vocoder_fidelity.json.

This tool imports the port, numpy/scipy and tools/torch_quality_dossier.py
(for ``card_line``): neither JAX nor the JAX package, nor
tools/copy_synthesis_bench.py (its helpers are copied here).

usage: python tools/torch_copy_synthesis_bench.py
           [--out vocoder_fidelity_torch.json] [--n 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from os.path import dirname, join

import numpy as np

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

from tools.torch_quality_dossier import card_line  # noqa: E402

FS = 16000
HOP_S = 0.005


def formant_filter(fs, formants=((730, 60), (1090, 80), (2440, 120))):
    """Cascade of 2nd-order resonators (vowel-like envelope)."""
    import scipy.signal

    b_all, a_all = np.array([1.0]), np.array([1.0])
    for fc, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        theta = 2 * np.pi * fc / fs
        a = np.array([1.0, -2 * r * np.cos(theta), r * r])
        b = np.array([1.0 - r])
        b_all = np.convolve(b_all, b)
        a_all = np.convolve(a_all, a)
    return b_all, a_all


def make_utterance(seed, dur_s=1.2, base_f0=None, return_components=False,
                   fs=None, jitter=0.0, shimmer=0.0, breath=0.03,
                   snr_db=None, phase0=0.0, noise_seed=None):
    """Speech-like signal: voiced (pulse train + vibrato through formants)
    and unvoiced (filtered noise) segments.  Returns (x, f0_true, vuv_true)
    at 5 ms frames; with ``return_components`` also the filtered harmonic
    and noise components (x = x_harm + x_noise, same scale) so estimator
    accuracy can be judged against KNOWN aperiodicity.

    Stress knobs for the per-condition fidelity rows:
      jitter   relative random F0 perturbation (smoothed, e.g. 0.01 = 1%)
      shimmer  relative random amplitude modulation of the voiced source
      breath   breath-noise excitation level (0.03 = modal, 0.15 = breathy)
      snr_db   additive white measurement noise at this SNR (None = off)
    """
    import scipy.signal

    if fs is None:
        fs = FS
    rs = np.random.RandomState(seed)
    n = int(dur_s * fs)
    tt = np.arange(n) / fs
    n_frames = int(dur_s / HOP_S) + 1
    ft = np.arange(n_frames) * HOP_S

    if base_f0 is None:
        base_f0 = rs.uniform(100, 240)
    # f0 contour: slow declination + vibrato
    f0_c = base_f0 * (1.0 - 0.15 * ft / dur_s) \
        * (1.0 + 0.02 * np.sin(2 * np.pi * 5.0 * ft))

    # voicing pattern: 3 voiced islands separated by unvoiced/silence
    vuv = np.zeros(n_frames, bool)
    pos = 0.08
    while pos < dur_s - 0.15:
        seg = rs.uniform(0.15, 0.3)
        a, b = int(pos / HOP_S), int(min(dur_s, pos + seg) / HOP_S)
        vuv[a:b] = True
        pos += seg + rs.uniform(0.06, 0.15)

    f0_true = np.where(vuv, f0_c, 0.0)

    # sample-level excitation
    f0_samp = np.interp(tt, ft, f0_c)
    if jitter > 0.0:
        # smoothed random F0 perturbation (~30 Hz bandwidth), cycle-scale
        pert = rs.randn(n)
        pert = scipy.signal.lfilter(*scipy.signal.butter(2, 30, fs=fs), pert)
        pert /= max(1e-12, pert.std())
        f0_samp = f0_samp * (1.0 + jitter * pert)
    v_samp = np.interp(tt, ft, vuv.astype(float)) > 0.5
    phase = np.cumsum(2 * np.pi * f0_samp / fs) + phase0
    # band-limited pulse train: sum of harmonics below 0.45*fs
    exc = np.zeros(n)
    max_h = int(0.45 * fs / base_f0)
    for h in range(1, max_h + 1):
        exc += np.sin(phase * h) / np.sqrt(h)
    if shimmer > 0.0:
        am = rs.randn(n)
        am = scipy.signal.lfilter(*scipy.signal.butter(2, 30, fs=fs), am)
        am /= max(1e-12, am.std())
        exc = exc * (1.0 + shimmer * am)
    exc *= v_samp
    # noise_seed decouples the noise realization from the utterance
    # structure (same f0/vuv/formants, fresh noise) — used by the
    # co-render floor measurements; default keeps the original stream
    rs_n = rs if noise_seed is None else np.random.RandomState(noise_seed)
    exc_noise = breath * rs_n.randn(n)            # breath noise everywhere
    exc_noise += 0.25 * rs_n.randn(n) * (~v_samp)  # unvoiced excitation

    b, a = formant_filter(fs)
    x_harm = scipy.signal.lfilter(b, a, exc)
    x_noise = scipy.signal.lfilter(b, a, exc_noise)
    x = x_harm + x_noise
    if snr_db is not None:
        meas = rs.randn(n)
        meas *= np.sqrt((x ** 2).mean() / 10.0 ** (snr_db / 10.0))
        x_noise = x_noise + meas
        x = x + meas
    scale = 0.6 / np.abs(x).max()
    x = x * scale
    if return_components:
        return x, f0_true, vuv, x_harm * scale, x_noise * scale
    return x, f0_true, vuv


def true_band_aperiodicity(x_harm, x_noise, f0_true, band_edges,
                           win_s=0.015, fs=None, hop_s=None):
    """Ground-truth coarse aperiodicity sqrt(P_noise / P_total) per frame
    and band, from the separately known harmonic/noise components.  fs and
    hop_s default to the module constants but MUST be passed for any
    condition generated at a non-default rate (e.g. fs22050)."""
    import scipy.signal

    fs = FS if fs is None else fs
    hop_s = HOP_S if hop_s is None else hop_s
    T = len(f0_true)
    n_bands = len(band_edges) - 1
    out = np.ones((T, n_bands))
    half = int(win_s * fs / 2)
    for b in range(n_bands):
        lo, hi = band_edges[b], band_edges[b + 1]
        sos = scipy.signal.butter(
            4, [max(lo, 1.0), min(hi, fs / 2 - 1.0)], btype="band",
            fs=fs, output="sos")
        hb = scipy.signal.sosfiltfilt(sos, x_harm)
        nb = scipy.signal.sosfiltfilt(sos, x_noise)
        for i in range(T):
            c = int(i * hop_s * fs)
            s0, s1 = max(0, c - half), min(len(hb), c + half)
            ph = float(np.mean(hb[s0:s1] ** 2))
            pn = float(np.mean(nb[s0:s1] ** 2))
            out[i, b] = np.sqrt(pn / max(ph + pn, 1e-300))
    return out

def f0_metrics(f0_est, f0_true, vuv_true, edge_tol=2):
    n = min(len(f0_est), len(f0_true))
    f0_est, f0_true, vuv_true = f0_est[:n], f0_true[:n], vuv_true[:n]
    vuv_est = f0_est > 0
    vuv_err = float(np.mean(vuv_est != vuv_true))
    # core V/UV error: frames more than edge_tol frames from a true V/UV
    # boundary (the analysis window inherently blurs +-2 frames at 5 ms hop)
    edges = np.where(np.diff(vuv_true.astype(int)) != 0)[0]
    core = np.ones(n, bool)
    for e in edges:
        core[max(0, e - edge_tol + 1): e + edge_tol + 1] = False
    vuv_core = float(np.mean(vuv_est[core] != vuv_true[core])) \
        if core.any() else float("nan")
    both = vuv_est & vuv_true
    if both.sum() == 0:
        return dict(f0_rmse_hz=float("nan"), vuv_error=vuv_err,
                    vuv_error_core=vuv_core, gross_error_rate=1.0)
    d = f0_est[both] - f0_true[both]
    gross = float(np.mean(np.abs(d) / f0_true[both] > 0.2))
    return dict(f0_rmse_hz=float(np.sqrt(np.mean(d ** 2))),
                vuv_error=vuv_err, vuv_error_core=vuv_core,
                gross_error_rate=gross)


def frame_mcd(x, y, order=24, fs=None):
    """Per-frame mel-cepstral distortion (dB) between two waveforms,
    co-analyzed on x's dio grid (c1..c_order).

    The co-analysis runs with ``uv_boundary_clamp=False``: the MEASUREMENT
    instrument stays fixed across rounds (the production analyzer's
    round-5 transition-aware window placement de-blurs boundary frames,
    which re-bases every distance — both systems' numbers and the
    co-render floors — by ~+0.15 dB without any waveform changing)."""
    from gantts_tpu_torch.frontend import sptk, world

    if fs is None:
        fs = FS
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    f0x, tx = world.dio(x, fs)
    spx = world.cheaptrick(x, f0x, tx, fs, uv_boundary_clamp=False)
    spy = world.cheaptrick(y, f0x, tx, fs,  # same time grid
                           uv_boundary_clamp=False)
    alpha = sptk.mcepalpha(fs)
    mcx = sptk.sp2mc(spx, order=order, alpha=alpha)
    mcy = sptk.sp2mc(spy, order=order, alpha=alpha)
    d = mcx[:, 1:] - mcy[:, 1:]
    return 10.0 / np.log(10.0) * np.sqrt(2.0 * np.sum(d ** 2, axis=1))


def mcd(x, y, order=24, fs=None):
    """Mean mel-cepstral distortion (dB), co-analyzed frame-by-frame."""
    return float(np.mean(frame_mcd(x, y, order=order, fs=fs)))


def frame_classes(vuv_true, n, edge=3):
    """Frame masks: voiced-steady / V-UV boundary (+-edge frames) /
    unvoiced-steady, from the known voicing pattern."""
    vuv = vuv_true[:n]
    edges = np.where(np.diff(vuv.astype(int)) != 0)[0]
    boundary = np.zeros(n, bool)
    for e in edges:
        boundary[max(0, e - edge + 1): e + edge + 1] = True
    return {"voiced_steady": vuv & ~boundary,
            "vuv_boundary": boundary,
            "unvoiced_steady": ~vuv & ~boundary}


def unvoiced_coanalysis_floor(n_seeds=3):
    """Stochastic floor of the unvoiced MCD: co-analysis of two INDEPENDENT
    realizations of the same noise-through-formants process.  No vocoder in
    the loop — this is the chi^2 periodogram-variance limit any
    analysis/synthesis round trip of noise is compared against (the round
    trip pays one realization's estimation error; two independent
    realizations pay sqrt(2) of it)."""
    import scipy.signal

    b, a = formant_filter(FS)
    n = int(1.2 * FS)
    floors = []
    for seed in range(n_seeds):
        r1 = np.random.RandomState(seed)
        r2 = np.random.RandomState(1000 + seed)
        x1 = scipy.signal.lfilter(b, a, 0.25 * r1.randn(n))
        x2 = scipy.signal.lfilter(b, a, 0.25 * r2.randn(n))
        x1 *= 0.6 / np.abs(x1).max()
        x2 *= 0.6 / np.abs(x2).max()
        floors.append(float(frame_mcd(x1, x2)[5:-5].mean()))
    return float(np.mean(floors))


def boundary_corender_floor(n_seeds=3):
    """Intrinsic floor of the vuv_boundary class for any vocoder that does
    not preserve pulse phase or the noise realization: co-analyze two
    renders of the SAME utterance (identical f0 contour, voicing pattern
    and formants) that differ only in the pulse train's initial phase and
    the noise seed.  At steady voiced frames the phase offset is invisible
    (periodic signal), but at a V/UV transition the first/last pulse's
    position inside the analysis window shifts the windowed spectrum —
    exactly the freedom a WORLD-style synthesizer exercises, measured here
    with NO vocoder in the loop.  (Round-4 measurement: ~1.4 dB, vs the
    system's 1.88 after the d4c transition-aware window clamp.)"""
    vals = []
    for seed in range(n_seeds):
        x1, f0_true, vuv = make_utterance(seed)
        x2, _, _ = make_utterance(seed, phase0=np.pi * 0.73,
                                  noise_seed=1000 + seed)
        fm = frame_mcd(x1, x2)
        nf = min(len(fm), len(vuv))
        sel = frame_classes(vuv[:nf], nf)["vuv_boundary"]
        if sel.sum():
            vals.append(float(fm[:nf][sel].mean()))
    return float(np.mean(vals))


# Stress conditions for the per-condition fidelity rows (VERDICT round-2
# item 2): pathological voice qualities, measurement noise, F0 near the
# 71/700 Hz config bounds (reference hparams.py:170-197), and fs=22050
# (exercises the ties-to-even twin rounding parity — a divergence class
# that fs=16000 alone never catches).
CONDITIONS = {
    "jitter_shimmer": dict(jitter=0.01, shimmer=0.10),
    "breathy": dict(breath=0.15),
    "snr20db": dict(snr_db=20.0),
    "snr10db": dict(snr_db=10.0),
    "f0_low_85hz": dict(base_f0=85.0),
    "f0_high_600hz": dict(base_f0=600.0),
    "fs22050": dict(fs=22050),
}


def run_condition(kw, n_utts=2, seed0=100):
    """Harvest F0 accuracy + copy-synthesis MCD under one stress condition."""
    from gantts_tpu_torch.frontend import world

    fs = kw.get("fs", FS)
    f0m, mcds = [], []
    for seed in range(seed0, seed0 + n_utts):
        x, f0_true, vuv = make_utterance(seed, **kw)
        f0, t = world.harvest(x, fs)
        f0m.append(f0_metrics(f0, f0_true, vuv))
        sp = world.cheaptrick(x, f0, t, fs)
        ap = world.d4c(x, f0, t, fs)
        y = world.synthesize(f0, sp, ap, fs)
        mcds.append(mcd(x, y, fs=fs))
    return {
        "f0_rmse_hz": round(float(np.mean(
            [m["f0_rmse_hz"] for m in f0m])), 4),
        "gross_error_rate": round(float(np.mean(
            [m["gross_error_rate"] for m in f0m])), 4),
        "vuv_error_core": round(float(np.mean(
            [m["vuv_error_core"] for m in f0m])), 4),
        "copy_synthesis_mcd_db": round(float(np.mean(mcds)), 4),
    }


def flatten(value, prefix=""):
    """{dotted key: leaf} of a nested JSON object."""
    if not isinstance(value, dict):
        return {prefix.rstrip("."): value}
    out = {}
    for k, v in value.items():
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def largest_gap(got, want):
    """(dotted key, |got - want|) of the largest gap between the numbers of
    two of this bench's results, as --out writes them; a ValueError names
    the keys that only one of them has."""
    got, want = flatten(got), flatten(want)
    if sorted(got) != sorted(want):
        raise ValueError(f"keys differ: {sorted(set(got) ^ set(want))}")
    gaps = {k: abs(got[k] - v) for k, v in want.items()
            if not isinstance(v, str)}
    key = max(gaps, key=gaps.get)
    return key, gaps[key]


def workload(n):
    """The JAX tool's workload text, and where nvidia-smi names a card, the
    card and the machine's numpy and scipy."""
    import scipy

    text = f"{n} synthetic utterances, fs={FS}, 5ms hop"
    card = card_line("cuda")
    if card:
        text += (f"; on the machine of {card} (numpy {np.__version__}, "
                 f"scipy {scipy.__version__})")
    return text


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=join(dirname(dirname(
        os.path.abspath(__file__))), "vocoder_fidelity_torch.json"))
    p.add_argument("--n", type=int, default=6)
    args = p.parse_args(argv)

    from gantts_tpu_torch.frontend import native, world

    print(f"host front end: {native.engine()}", file=sys.stderr)

    agg = {"dio": [], "harvest": []}
    mcds = []
    mcd_by_class = {"voiced_steady": [], "vuv_boundary": [],
                    "unvoiced_steady": []}
    env_errs = []
    ap_voiced_lo, ap_voiced_all, ap_unvoiced = [], [], []
    band_edges = world._d4c_band_edges(FS)
    centers = (np.asarray(band_edges[:-1]) + np.asarray(band_edges[1:])) / 2
    ap_err_bands = []
    for seed in range(args.n):
        x, f0_true, vuv_true, x_harm, x_noise = make_utterance(
            seed, return_components=True)

        f0_d, t = world.dio(x, FS)
        f0_d = world.stonemask(x, f0_d, t, FS)
        agg["dio"].append(f0_metrics(f0_d, f0_true, vuv_true))

        f0_h, th = world.harvest(x, FS)
        agg["harvest"].append(f0_metrics(f0_h, f0_true, vuv_true))

        # copy synthesis with the harvest track
        sp = world.cheaptrick(x, f0_h, th, FS)
        ap = world.d4c(x, f0_h, th, FS)
        y = world.synthesize(f0_h, sp, ap, FS)
        fm = frame_mcd(x, y)
        mcds.append(float(fm.mean()))
        for cname, sel in frame_classes(vuv_true, len(fm)).items():
            if sel.any():
                mcd_by_class[cname].append(float(fm[sel].mean()))

        # aperiodicity sanity: harmonically-dominated voiced low band must
        # read (mostly) periodic, unvoiced frames fully aperiodic
        nn = min(len(f0_h), len(vuv_true))
        v = (f0_h[:nn] > 0) & vuv_true[:nn]
        uv = (f0_h[:nn] == 0) & ~vuv_true[:nn]
        nb = ap.shape[1]
        if v.any():
            ap_voiced_lo.append(float(ap[:nn][v][:, : nb // 4].mean()))
            ap_voiced_all.append(float(ap[:nn][v].mean()))
        if uv.any():
            ap_unvoiced.append(float(ap[:nn][uv].mean()))

        # d4c ACCURACY vs known aperiodicity (the harmonic and noise
        # components are synthesized separately, so the true band power
        # ratio is known): mean |est - true| per coarse band, voiced frames
        if v.any():
            true_ap = true_band_aperiodicity(x_harm, x_noise, f0_true,
                                             band_edges)
            kc = np.round(centers / (FS / 2) * (nb - 1)).astype(int)
            est = ap[:nn, kc][v]
            ap_err_bands.append(np.abs(est - true_ap[:nn][v]).mean(axis=0))

        # envelope accuracy on voiced frames vs known formant response
        import scipy.signal

        b, a = formant_filter(FS)
        n_bins = sp.shape[1]
        w, resp = scipy.signal.freqz(b, a, worN=n_bins, fs=FS)
        filt_env = np.abs(resp) ** 2
        voiced = np.where(f0_h[: len(vuv_true)] > 0)[0]
        if len(voiced) > 3:
            errs = []
            for i in voiced:
                fi = f0_h[i]
                # the synthetic excitation puts power ~1/h at harmonic h, so
                # the TRUE spectral envelope is |H(f)|^2 * (fi / f); compare
                # over the formant region (300 Hz - 4 kHz) where harmonics
                # dominate the breath-noise floor, per-frame gain removed
                # (shape error only).
                tilt = fi / np.maximum(w, fi)
                true_env = filt_env * tilt
                lo = int(300 / (FS / 2) * (n_bins - 1))
                hi = int(4000 / (FS / 2) * (n_bins - 1))
                # NB: the clamp must sit far below the smallest true-envelope
                # value; true_env reaches ~1e-13 near 4 kHz (the filter's
                # absolute scale is tiny), so a 1e-12 epsilon used to inflate
                # the "true" curve there and read as a fake -9 dB estimator
                # bias in the 3.6-4 kHz band.
                d = (10 * np.log10(np.maximum(sp[i, lo:hi], 1e-300))
                     - 10 * np.log10(np.maximum(true_env[lo:hi], 1e-300)))
                d = d - d.mean()
                errs.append(np.abs(d).mean())
            env_errs.append(float(np.mean(errs)))

    def avg(rows, key):
        vals = [r[key] for r in rows if np.isfinite(r[key])]
        return round(float(np.mean(vals)), 4) if vals else None

    result = {
        "workload": workload(args.n),
        "dio_stonemask": {k: avg(agg["dio"], k) for k in
                          ("f0_rmse_hz", "vuv_error", "vuv_error_core", "gross_error_rate")},
        "harvest": {k: avg(agg["harvest"], k) for k in
                    ("f0_rmse_hz", "vuv_error", "vuv_error_core", "gross_error_rate")},
        "copy_synthesis_mcd_db": round(float(np.mean(mcds)), 4),
        # error decomposition (tools/torch_fidelity_decomp.py): voiced-steady
        # frames are near-transparent; unvoiced frames are bounded below by
        # the chi^2 periodogram-variance floor reported alongside
        "copy_synthesis_mcd_by_class": {
            k: round(float(np.mean(v)), 4)
            for k, v in mcd_by_class.items() if v},
        "unvoiced_coanalysis_floor_db": round(
            unvoiced_coanalysis_floor(), 4),
        # intrinsic phase/noise-realization floor of the boundary class
        "vuv_boundary_corender_floor_db": round(
            boundary_corender_floor(), 4),
        "envelope_lsd_db": round(float(np.mean(env_errs)), 4),
        "d4c_voiced_lowband_ap": round(float(np.mean(ap_voiced_lo)), 4),
        "d4c_voiced_allband_ap": round(float(np.mean(ap_voiced_all)), 4),
        "d4c_unvoiced_ap": round(float(np.mean(ap_unvoiced)), 4),
        "d4c_abs_err_per_band": {
            f"{int(band_edges[b])}-{int(band_edges[b + 1])}Hz": round(
                float(np.mean([r[b] for r in ap_err_bands])), 4)
            for b in range(len(band_edges) - 1)},
        "conditions": {name: run_condition(kw)
                       for name, kw in CONDITIONS.items()},
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
