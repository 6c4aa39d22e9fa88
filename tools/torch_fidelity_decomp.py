#!/usr/bin/env python3
"""Decompose the copy-synthesis MCD of the port's vocoder into frame classes
and error sources (the counterpart of tools/fidelity_decomp.py, on
gantts_tpu_torch/frontend/world.py; it prints what that tool prints).

Uses the same synthetic utterances as torch_copy_synthesis_bench and
reports the co-analysis MCD split by frame class (voiced-steady / V-UV
boundary / unvoiced-steady) and with ground-truth substitutions (true F0,
true band aperiodicity) so the residual attributable to each estimation
stage vs the synthesis/analysis round trip itself is visible.  Diagnostic
only — not a CI gate.  Imports the port and numpy: neither JAX nor the JAX
package.

usage: python tools/torch_fidelity_decomp.py"""

from __future__ import annotations

import os
import sys
from os.path import dirname

import numpy as np

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

from tools.torch_copy_synthesis_bench import (  # noqa: E402
    FS, frame_classes, frame_mcd, make_utterance, true_band_aperiodicity)

from gantts_tpu_torch.frontend import world  # noqa: E402


def classes(vuv_true, n, edge=3):
    full = frame_classes(vuv_true, n, edge=edge)
    return {"voiced": full["voiced_steady"],
            "boundary": full["vuv_boundary"],
            "unvoiced": full["unvoiced_steady"]}


def expand_true_ap(x_harm, x_noise, f0_true, n_bins):
    band_edges = world._d4c_band_edges(FS)
    coarse = true_band_aperiodicity(x_harm, x_noise, f0_true, band_edges)
    centers = (np.asarray(band_edges[:-1]) + np.asarray(band_edges[1:])) / 2
    freq = np.arange(n_bins) * FS / ((n_bins - 1) * 2)
    ap = np.empty((len(f0_true), n_bins))
    for i in range(len(f0_true)):
        ap[i] = np.interp(freq, centers, coarse[i])
    ap[f0_true <= 0] = 1.0 - 1e-12
    return np.clip(ap, 0.001, 1.0 - 1e-12)


def main():
    rows = {}
    for seed in range(3):
        x, f0_true, vuv_true, x_harm, x_noise = make_utterance(
            seed, return_components=True)
        f0_h, th = world.harvest(x, FS)
        sp = world.cheaptrick(x, f0_h, th, FS)
        ap = world.d4c(x, f0_h, th, FS)
        n_bins = sp.shape[1]

        t_true = np.arange(len(f0_true)) * 0.005
        sp_tf = world.cheaptrick(x, f0_true, t_true, FS)
        ap_tf = world.d4c(x, f0_true, t_true, FS)
        ap_true = expand_true_ap(x_harm, x_noise, f0_true, n_bins)

        variants = {
            "full (harvest f0, d4c ap)": (f0_h, sp, ap),
            "true f0": (f0_true, sp_tf, ap_tf),
            "true f0 + true ap": (f0_true, sp_tf, ap_true),
            "harvest f0 + true ap": (
                f0_h, sp,
                expand_true_ap(x_harm, x_noise,
                               np.where(f0_h[:len(f0_true)] > 0,
                                        f0_true, 0.0),
                               n_bins)),
        }
        for name, (f0v, spv, apv) in variants.items():
            m = min(len(f0v), spv.shape[0], apv.shape[0])
            y = world.synthesize(f0v[:m], spv[:m], apv[:m], FS)
            fm = frame_mcd(x, y)
            cls = classes(vuv_true, len(fm))
            row = rows.setdefault(name, {k: [] for k in
                                         ("all", *cls.keys())})
            row["all"].append(float(fm.mean()))
            for k, sel in cls.items():
                if sel[:len(fm)].any():
                    row[k].append(float(fm[sel[:len(fm)]].mean()))

    print(f"{'variant':34s} {'all':>7s} {'voiced':>7s} "
          f"{'boundary':>9s} {'unvoiced':>9s}")
    for name, row in rows.items():
        vals = [np.mean(row[k]) if row[k] else float("nan")
                for k in ("all", "voiced", "boundary", "unvoiced")]
        print(f"{name:34s} {vals[0]:7.3f} {vals[1]:7.3f} "
              f"{vals[2]:9.3f} {vals[3]:9.3f}")


if __name__ == "__main__":
    main()
