"""Mel-cepstrum transforms and the MLSA synthesis filter.

Re-provision of the pysptk/SPTK (C) functionality the reference exercises
(SURVEY.md section 2.3): ``sp2mc``, ``mc2sp``, ``mc2b``, ``util.mcepalpha``
and the streaming MLSA digital filter behind ``pysptk.synthesis.Synthesizer``
(prepare_features_vc.py:51-52, evaluation_vc.py:49-50, 99-106,
evaluation_tts.py:105, 115).

Everything is implemented from the mathematical definitions of the
mel-cepstral analysis framework (Tokuda/Imai), not translated from SPTK
sources:

  * spectrum <-> cepstrum:  log|H|(w) = c0 + sum_{k>=1} c_k cos(wk)
    (one-sided minimum-phase cepstrum);
  * frequency warping (freqt): Oppenheim all-pass recursion;
  * MLSA coefficients:  b[M] = mc[M],  b[m] = mc[m] - alpha*b[m+1], the
    change of basis from warped-delay powers to the MLSA basis
    Phi_m(z) = (1-a^2) z^-1 / (1 - a z^-1) * A(z)^{m-1},
    A(z) = (z^-1 - a)/(1 - a z^-1);
  * MLSA filter: H(z) = exp(b0) * exp(F(z)), F = sum_{m>=1} b_m Phi_m,
    exp approximated by the Pade(5) feedback structure
        u = x + sum_l (-1)^{l+1} A_l (F^l u),   y = u + sum_l A_l (F^l u),
    realizable per sample because F is strictly causal.

Frame-level transforms are vectorized NumPy (float64).  The per-sample MLSA
loop has a C++ implementation (cpp/frontend.cpp via ctypes,
``gantts_tpu_torch.frontend.native``); the NumPy version here is the
correctness oracle and fallback.

The port's own copy of gantts_tpu/frontend/sptk.py, numerics unchanged.
"""

from __future__ import annotations

import numpy as np

# Pade order-5 coefficients A_l of exp(w) ~= N(w)/N(-w), N(w)=sum A_l w^l.
# exp Pade[5/5]: A_l = C(5,l) * 5! * (10-l)! / (10! * (5-l)! * l!) ... the
# closed form below; A_0 = 1.
def _pade_coeffs(L=5):
    from math import factorial

    return np.array([
        factorial(2 * L - l) * factorial(L)
        / (factorial(2 * L) * factorial(l) * factorial(L - l))
        for l in range(L + 1)
    ])


_PADE5 = _pade_coeffs(5)


def mcepalpha(fs, start=0.0, stop=1.0, step=0.001, num_points=1000):
    """All-pass warping coefficient best matching the mel scale at ``fs``.

    Brute-force search minimizing the squared distance between the
    normalized all-pass phase response and the normalized mel scale
    (pysptk.util.mcepalpha approach; 0.42 @ 16 kHz, ~0.455 @ 22.05 kHz).
    """
    alphas = np.arange(start, stop, step)
    f = np.linspace(0.0, fs / 2.0, num_points)
    mel = np.log1p(f / 1000.0)
    mel = mel / mel[-1]
    omega = np.pi * np.arange(num_points) / (num_points - 1)
    sin_w, cos_w = np.sin(omega), np.cos(omega)
    best_alpha, best_dist = 0.0, np.inf
    for a in alphas:
        warp = np.arctan2((1 - a * a) * sin_w, (1 + a * a) * cos_w - 2 * a)
        warp = warp / np.pi
        dist = float(np.sum((mel - warp) ** 2))
        if dist < best_dist:
            best_dist, best_alpha = dist, float(a)
    return best_alpha


def freqt(c, order, alpha):
    """Frequency-warp cepstra by ``alpha`` (output order ``order``).

    ``c``: (..., M+1); returns (..., order+1).  Vectorized over leading axes.
    """
    c = np.asarray(c, dtype=np.float64)
    M_in = c.shape[-1] - 1
    d = np.zeros(c.shape[:-1] + (order + 1,), dtype=np.float64)
    beta = 1.0 - alpha * alpha
    for i in range(M_in, -1, -1):
        prev = d
        d = np.empty_like(prev)
        d[..., 0] = c[..., i] + alpha * prev[..., 0]
        if order >= 1:
            d[..., 1] = beta * prev[..., 0] + alpha * prev[..., 1]
        for m in range(2, order + 1):
            d[..., m] = prev[..., m - 1] + alpha * (prev[..., m] - d[..., m - 1])
    return d


def sp2mc(powerspec, order, alpha):
    """Power spectrogram (one-sided, fftlen//2+1) -> mel-cepstrum (order+1).

    Reference: prepare_features_vc.py:51, prepare_features_tts.py:126.
    """
    powerspec = np.asarray(powerspec, dtype=np.float64)
    logsp = 0.5 * np.log(np.maximum(powerspec, 1e-300))  # log|H|
    c = np.fft.irfft(logsp, axis=-1)
    n = logsp.shape[-1]
    cep = c[..., :n].copy()
    cep[..., 1:] *= 2.0  # fold the symmetric part: one-sided min-phase cep
    return freqt(cep, order, alpha)


def mc2sp(mc, alpha, fftlen):
    """Mel-cepstrum -> power spectrogram (one-sided, fftlen//2+1).

    Reference: evaluation_vc.py:105, evaluation_tts.py:115.
    """
    mc = np.asarray(mc, dtype=np.float64)
    cep = freqt(mc, fftlen // 2, -alpha)
    buf = np.zeros(mc.shape[:-1] + (fftlen,), dtype=np.float64)
    buf[..., : cep.shape[-1]] = cep
    # Re(rfft) of a one-sided sequence gives c0 + sum c_k cos(wk) exactly.
    logmag = np.fft.rfft(buf, axis=-1).real
    return np.exp(2.0 * logmag)


def mc2b(mc, alpha):
    """Mel-cepstrum -> MLSA filter coefficients (evaluation_vc.py:99)."""
    mc = np.asarray(mc, dtype=np.float64)
    b = np.empty_like(mc)
    M = mc.shape[-1] - 1
    b[..., M] = mc[..., M]
    for m in range(M - 1, -1, -1):
        b[..., m] = mc[..., m] - alpha * b[..., m + 1]
    return b


def b2mc(b, alpha):
    """Inverse of :func:`mc2b`."""
    b = np.asarray(b, dtype=np.float64)
    mc = np.empty_like(b)
    M = b.shape[-1] - 1
    mc[..., M] = b[..., M]
    for m in range(M - 1, -1, -1):
        mc[..., m] = b[..., m] + alpha * b[..., m + 1]
    return mc


class _WarpedFIR:
    """One application of F(z) = sum_{m=1..M} b_m Phi_m(z) as a stateful
    per-sample filter.

    State: ``d[m]`` holds Phi_m applied to the input signal, and ``x_prev``
    the last input sample (F is strictly causal: output at n uses inputs
    <= n-1).  Update on receiving the *previous* input sample s:

        d[1] <- (1-a^2) * s + a * d[1]
        d[m] <- d[m-1]_old + a * (d[m]_old - d[m-1]_new),  m = 2..M
        v = sum_{m=1..M} b_m d[m]
    """

    __slots__ = ("alpha", "d", "x_prev")

    def __init__(self, order, alpha):
        self.alpha = alpha
        self.d = np.zeros(order + 1)
        self.x_prev = 0.0

    def step(self, b):
        a = self.alpha
        d = self.d
        old = d.copy()
        d[1] = (1 - a * a) * self.x_prev + a * old[1]
        for m in range(2, len(d)):
            d[m] = old[m - 1] + a * (old[m] - d[m - 1])
        return float(np.dot(b[1:], d[1:]))

    def push(self, x):
        self.x_prev = x


class MLSAFilter:
    """Streaming MLSA synthesis filter, Pade(5), time-varying coefficients.

    Pure-Python correctness oracle; production path is the C++ port
    (cpp/frontend.cpp) validated against this class sample-for-sample.
    """

    def __init__(self, order, alpha, pd=5):
        self.order = order
        self.alpha = alpha
        self.pd = pd
        self.pade = _pade_coeffs(pd)
        self.stages = [_WarpedFIR(order, alpha) for _ in range(pd)]

    def step(self, x, b):
        """One excitation sample through exp(F); gain exp(b0) NOT applied."""
        pade = self.pade
        v = np.empty(self.pd + 1)
        for l in range(1, self.pd + 1):
            v[l] = self.stages[l - 1].step(b)
        # u = x + sum_l (-1)^{l+1} A_l v_l ;  y = u + sum_l A_l v_l
        u = x
        for l in range(1, self.pd + 1):
            term = pade[l] * v[l]
            u += term if (l % 2 == 1) else -term
        y = u + float(np.dot(pade[1:], v[1:]))
        # chain inputs for next sample: stage 1 sees u, stage l sees v_{l-1}
        self.stages[0].push(u)
        for l in range(2, self.pd + 1):
            self.stages[l - 1].push(v[l - 1])
        return y


def mlsa_synthesis(excitation, b_frames, alpha, hopsize, pd=5):
    """Filter excitation through a time-varying MLSA filter.

    ``excitation``: (N,) float64; ``b_frames``: (T, M+1) from :func:`mc2b`,
    coefficients switched every ``hopsize`` samples (the
    pysptk.synthesis.Synthesizer contract used at evaluation_vc.py:99-102).
    The exp(b0) gain is applied to the excitation per frame.
    Dispatches to C++ when built; NumPy fallback otherwise.
    """
    from gantts_tpu_torch.frontend import native

    excitation = np.ascontiguousarray(excitation, dtype=np.float64)
    b_frames = np.ascontiguousarray(b_frames, dtype=np.float64)
    if native.available():
        return native.mlsa_synthesis(excitation, b_frames, alpha, hopsize, pd)
    return _mlsa_synthesis_py(excitation, b_frames, alpha, hopsize, pd)


def _mlsa_synthesis_py(excitation, b_frames, alpha, hopsize, pd=5):
    T, M1 = b_frames.shape
    filt = MLSAFilter(M1 - 1, alpha, pd)
    N = len(excitation)
    out = np.zeros(N)
    for n in range(N):
        b = b_frames[min(n // hopsize, T - 1)]
        out[n] = filt.step(excitation[n] * np.exp(b[0]), b)
    return out
