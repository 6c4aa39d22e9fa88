#!/usr/bin/env python3
"""Diagnostic: vocoder consistency of the port's front end —
cheaptrick(synthesize(sp, ap, f0)) vs sp (the counterpart of
tools/fidelity_diag.py, on gantts_tpu_torch/frontend/world.py and sptk.py;
it prints what that tool prints).

Synthesizes from KNOWN (f0, sp, ap) and measures how well re-analysis
recovers them, per component.  Not a CI gate; a debugging tool for the
copy-synthesis fidelity work.  Imports the port, numpy and scipy: neither
JAX nor the JAX package.

usage: python tools/torch_fidelity_diag.py"""

from __future__ import annotations

import os
import sys
from os.path import dirname

import numpy as np
import scipy.signal

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

from gantts_tpu_torch.frontend import sptk, world  # noqa: E402

FS = 16000
HOP = 0.005


def run(tag, f0, sp, ap):
    T = len(f0)
    t = np.arange(T) * HOP
    y = world.synthesize(f0, sp, ap, FS)
    # PSD check over the stationary mid-section
    mid = y[len(y) // 4: 3 * len(y) // 4]
    f_w, psd = scipy.signal.welch(mid, FS, nperseg=1024)
    # expected PSD: sp (power per... cheaptrick's convention) — compare shapes
    sp_mid = sp[T // 2]
    n_bins = sp.shape[1]
    freq = np.arange(n_bins) * FS / ((n_bins - 1) * 2)
    sp_i = np.interp(f_w, freq, sp_mid)
    sel = (f_w > 300) & (f_w < 6000)
    d_psd = 10 * np.log10(psd[sel] / psd[sel].mean()) \
        - 10 * np.log10(sp_i[sel] / sp_i[sel].mean())
    # re-analysis consistency
    sp2 = world.cheaptrick(y, f0, t, FS)
    alpha = sptk.mcepalpha(FS)
    mcx = sptk.sp2mc(sp, order=24, alpha=alpha)
    mcy = sptk.sp2mc(sp2, order=24, alpha=alpha)
    d = (mcx[:, 1:] - mcy[:, 1:])[5:-5]
    mcd = 10.0 / np.log(10) * np.sqrt(2) * np.mean(
        np.sqrt(np.sum(d ** 2, axis=1)))
    # gain consistency (c0)
    dc0 = float(np.mean(mcy[5:-5, 0] - mcx[5:-5, 0]))
    print(f"{tag:32s} consistency-MCD {mcd:6.3f} dB   "
          f"PSD-shape-err {np.abs(d_psd).mean():5.2f} dB   "
          f"c0 offset {dc0:+.3f}")
    return y


def main():
    T = 240
    n_bins = world.get_cheaptrick_fft_size(FS) // 2 + 1
    freq = np.arange(n_bins) * FS / ((n_bins - 1) * 2)
    # smooth vowel-like envelope
    env = np.ones(n_bins)
    for fc, bw, g in ((500, 80, 4.0), (1500, 120, 2.0), (2500, 160, 1.0)):
        env += g / (1 + ((freq - fc) / bw) ** 2)
    env = env * np.exp(-freq / 4000.0)
    sp = np.tile(env, (T, 1))

    for f0v in (120.0, 220.0):
        f0 = np.full(T, f0v)
        for apv in (0.05, 0.3):
            ap = np.full((T, n_bins), apv)
            run(f"f0={f0v:.0f} ap={apv}", f0, sp, ap)
        # unvoiced
    f0 = np.zeros(T)
    ap = np.full((T, n_bins), 1.0 - 1e-12)
    run("unvoiced ap=1", f0, sp, ap)

    # vibrato voiced
    tfr = np.arange(T) * HOP
    f0 = 180 * (1 + 0.02 * np.sin(2 * np.pi * 5 * tfr))
    ap = np.full((T, n_bins), 0.1)
    run("vibrato f0~180 ap=0.1", f0, sp, ap)


if __name__ == "__main__":
    main()
