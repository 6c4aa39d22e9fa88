"""Spectral post-filters: the port's own copy of gantts_tpu/postfilters.py,
on the port's own ``freqt``, ``mc2b`` and ``b2mc``.

``merlin_post_filter`` re-provides ``nnmnkwii.postfilters.merlin_post_filter``
(reference use: evaluation_tts.py:33, 112-113): Merlin's formant-enhancement
post-filter on mel-cepstra.  Algorithm (Merlin's postfilter recipe):

  1. lifter the mel-cepstrum: mgc_p = mgc * coef^clip(m-1, 0, ...)
     — i.e. coefficients 2.. are scaled by ``coef``-powered weights
     (here: w[0:2] = 1, w[2:] = coef, the standard Merlin lifter),
  2. match the average log power at r0 by compensating c0 through the
     0th autocorrelation of the corresponding spectra,
  3. keep c1 energy-corrected through the warped domain (b1 equalization).
"""

from __future__ import annotations

import numpy as np

from gantts_tpu_torch.frontend.sptk import b2mc, freqt, mc2b


def _c2acr0(c, fftlen=512):
    """0th autocorrelation of the signal whose cepstrum is ``c``."""
    logspec = np.fft.rfft(np.pad(c, ((0, 0), (0, fftlen - c.shape[1]))),
                          axis=1).real
    spec = np.exp(2.0 * logspec)
    return spec.mean(axis=1)


def merlin_post_filter(mgc, alpha, minimum_phase_order=511, fftlen=512,
                       coef=1.4, weight=None):
    """Formant-enhancing post-filter on a (T, M+1) mel-cepstrum track."""
    mgc = np.asarray(mgc, dtype=np.float64)
    T, M1 = mgc.shape
    if weight is None:
        weight = np.full(M1, coef)
        weight[:2] = 1.0

    # work in the unwarped cepstral domain for the power computations
    mgc_r0 = _c2acr0(freqt(mgc, minimum_phase_order, -alpha), fftlen)
    mgc_p = mgc * weight
    mgc_p_r0 = _c2acr0(freqt(mgc_p, minimum_phase_order, -alpha), fftlen)

    # power matching: replace only b0 of the weighted cepstrum so the
    # average log power matches the unfiltered track (Merlin recipe keeps
    # the weighted b[1:] untouched)
    b_p = mc2b(mgc_p, alpha)
    b_p[:, 0] += 0.5 * np.log(
        np.maximum(mgc_r0, 1e-300) / np.maximum(mgc_p_r0, 1e-300))
    return b2mc(b_p, alpha)
