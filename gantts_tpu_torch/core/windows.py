"""Window matrices and the unit-variance MLPG matrix (host-side, NumPy), the
port's own copy of what it uses from gantts_tpu/core/windows.py.

A window ``(l, u, coeffs)`` with ``len(coeffs) == l + u + 1`` has the T x T
matrix ``W[t, t + k] = coeffs[l + k]`` for ``-l <= k <= u``, clipped at the
boundaries.  With K windows stacked, ``R = P^{-1} [W_0; ...; W_{K-1}]^T``
(``P = sum_k W_k^T W_k``, symmetric positive definite and banded) turns a
normalized static+dynamic trajectory into the maximum-likelihood static
trajectory under unit variances, so the training step's MLPG is one matmul.
P is factored in banded storage with scipy; the JAX package reaches a C++
solver for the same system where its native library is built.

``mlpg`` is the full host MLPG of TTS synthesis (float64, per-dimension
variances, unit or true): one banded SPD solve per feature dimension,
through the C++ engine's ``banded_cholesky_solve`` where it is built and
``scipy.linalg.solveh_banded`` otherwise, as in the JAX package.

Exactness: if ``u = delta_features(s, windows)`` then ``R @ window_major(u)
== s`` up to float rounding, since P^{-1} W*^T W* = I.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

# The static, delta and delta-delta windows (the bundles' ``windows``).
DEFAULT_WINDOWS = [
    (0, 0, np.array([1.0])),
    (1, 1, np.array([-0.5, 0.0, 0.5])),
    (1, 1, np.array([1.0, -2.0, 1.0])),
]


def _check_window(window):
    l, u, coeffs = window
    coeffs = np.asarray(coeffs, dtype=np.float64)
    if l < 0 or u < 0 or len(coeffs) != l + u + 1:
        raise ValueError(
            f"Malformed window {window!r}: need len(coeffs) == l + u + 1")
    return int(l), int(u), coeffs


def build_win_mats(windows, T):
    """Dense T x T matrix for each window (clipped at the boundaries)."""
    mats = []
    for window in windows:
        l, u, coeffs = _check_window(window)
        W = np.zeros((T, T), dtype=np.float64)
        for k in range(-l, u + 1):
            c = coeffs[l + k]
            if c == 0.0:
                continue
            idx = np.arange(max(0, -k), min(T, T - k))
            W[idx, idx + k] = c
        mats.append(W)
    return mats


def window_half_bandwidth(windows) -> int:
    """Half-bandwidth of P = sum_k W_k^T W_k."""
    return max(l + u for l, u, _ in map(_check_window, windows))


def _banded_precision(windows, T):
    """P = sum_k W_k^T W_k in scipy upper-banded storage, shape (b+1, T):
    ``ab[b + i - j, j] = P[i, j]`` for ``max(0, j-b) <= i <= j``, built from
    the window coefficients without dense T x T temporaries."""
    b = window_half_bandwidth(windows)
    ab = np.zeros((b + 1, T), dtype=np.float64)
    for window in windows:
        l, u, coeffs = _check_window(window)
        # W[t, t+k] = coeffs[l+k]; contribution to P[t+k1, t+k2] is
        # coeffs[l+k1]*coeffs[l+k2] for every valid row t.
        for k1 in range(-l, u + 1):
            c1 = coeffs[l + k1]
            if c1 == 0.0:
                continue
            for k2 in range(k1, u + 1):  # j >= i (upper triangle)
                c2 = coeffs[l + k2]
                if c2 == 0.0:
                    continue
                t0 = max(0, -k1, -k2)
                t1 = min(T, T - k1, T - k2)
                if t1 <= t0:
                    continue
                i = np.arange(t0, t1) + k1
                j = np.arange(t0, t1) + k2
                ab[b + i - j, j] += c1 * c2
    return ab


def unit_variance_mlpg_matrix(windows, T, dtype=np.float32):
    """R = (sum_k W_k^T W_k)^{-1} [W_0; ...; W_{K-1}]^T, shape (T, K*T).

    Computed once per bucketed sequence length and cached by the training
    loop (``train/loop.py`` ``RMatrixCache``)."""
    K = len(windows)
    ab = _banded_precision(windows, T)
    # RHS: W*^T laid out as (T, K*T): column (k*T + t) is row t of W_k.
    rhs = np.zeros((T, K * T), dtype=np.float64)
    for k, window in enumerate(windows):
        l, u, coeffs = _check_window(window)
        for off in range(-l, u + 1):
            c = coeffs[l + off]
            if c == 0.0:
                continue
            t = np.arange(max(0, -off), min(T, T - off))
            rhs[t + off, k * T + t] = c
    R = scipy.linalg.solveh_banded(ab, rhs, lower=False)
    return np.ascontiguousarray(R, dtype=dtype)


def _solveh_banded(ab, rhs):
    """Banded SPD solve: the C++ engine's banded_cholesky_solve
    (cpp/frontend.cpp), scipy where the engine is not built."""
    from gantts_tpu_torch.frontend import native

    if native.available():
        return native.banded_cholesky_solve(
            ab, np.ascontiguousarray(rhs, np.float64),
            bandwidth=ab.shape[0] - 1)
    return scipy.linalg.solveh_banded(ab, rhs, lower=False)


def mlpg(means, variances, windows):
    """Full MLPG with per-dimension (frame-invariant) variances
    (``nnmnkwii.paramgen.mlpg`` as the reference calls it at
    evaluation_tts.py:72-74, unit variances, and :96-98, true variances).

    ``means`` is (T, K*D) with per-frame layout ``[win0-block, win1-block,
    ..., win{K-1}-block]`` (each block D wide); ``variances`` is (K*D,) or
    (T, K*D) (only frame-invariant variances, all the reference uses; the
    first row is taken).  Returns the (T, D) static trajectory, solved per
    dimension as the banded SPD system ``(W*^T S^-1 W*) y = W*^T S^-1 u``:
    O(T b^2 D), float64.
    """
    means = np.asarray(means, dtype=np.float64)
    T, KD = means.shape
    K = len(windows)
    if KD % K:
        raise ValueError(f"means dim {KD} not divisible by num windows {K}")
    D = KD // K
    variances = np.asarray(variances, dtype=np.float64)
    if variances.ndim == 2:
        variances = variances[0]
    if variances.shape[-1] != KD:
        raise ValueError("variances must have K*D entries")

    b = window_half_bandwidth(windows)
    out = np.empty((T, D), dtype=np.float64)
    # the precision differs per dimension only through the scalar
    # 1/sigma^2_kd weights, so each dimension assembles its own band
    win_info = [_check_window(w) for w in windows]
    for d in range(D):
        ab = np.zeros((b + 1, T), dtype=np.float64)
        rhs = np.zeros(T, dtype=np.float64)
        for k, (l, u, coeffs) in enumerate(win_info):
            inv_var = 1.0 / variances[k * D + d]
            u_kd = means[:, k * D + d]
            for k1 in range(-l, u + 1):
                c1 = coeffs[l + k1]
                if c1 == 0.0:
                    continue
                # rhs: (W_k^T S^-1 u)[t+k1] += c1 * inv_var * u_kd[t]
                t0, t1 = max(0, -k1), min(T, T - k1)
                rhs[np.arange(t0, t1) + k1] += c1 * inv_var * u_kd[t0:t1]
                for k2 in range(k1, u + 1):
                    c2 = coeffs[l + k2]
                    if c2 == 0.0:
                        continue
                    s0 = max(0, -k1, -k2)
                    s1 = min(T, T - k1, T - k2)
                    if s1 <= s0:
                        continue
                    i = np.arange(s0, s1) + k1
                    j = np.arange(s0, s1) + k2
                    ab[b + i - j, j] += c1 * c2 * inv_var
        out[:, d] = _solveh_banded(ab, rhs[:, None])[:, 0]
    return out


def delta_features(x, windows):
    """Apply each window to a (T, D) static trajectory; returns (T, K*D) with
    per-frame layout [win0, win1, ...], the layout MLPG expects.  Boundary
    frames use clipped windows (out-of-range taps contribute 0)."""
    x = np.asarray(x)
    T, D = x.shape
    outs = []
    for window in windows:
        l, u, coeffs = _check_window(window)
        y = np.zeros((T, D), dtype=x.dtype)
        for k in range(-l, u + 1):
            c = coeffs[l + k]
            if c == 0.0:
                continue
            t0, t1 = max(0, -k), min(T, T - k)
            y[t0:t1] += np.asarray(c * x[t0 + k:t1 + k], dtype=x.dtype)
        outs.append(y)
    return np.hstack(outs)
