"""Normalization stats, scaling, trajectory smoothing and frame utilities on
the host (NumPy, float64 where it matters): the port's own copy of
gantts_tpu/preprocessing/__init__.py.  Training uses the scaling and the
stats that ``train/setup.py`` collects and saves; synthesis the smoothing;
feature extraction the frame utilities (``trim_zeros_frames``,
``adjust_frame_length(s)``, ``interp1d``) and ``alignment.DTWAligner``."""

from __future__ import annotations

import numpy as np

from gantts_tpu_torch.core.windows import delta_features  # noqa: F401
from gantts_tpu_torch.preprocessing.alignment import DTWAligner  # noqa: F401


def _handle_zeros(scale):
    """Avoid div-by-zero for constant feature dims (sklearn convention)."""
    scale = np.asarray(scale, dtype=np.float64).copy()
    if scale.ndim == 0:
        return 1.0 if scale == 0.0 else scale
    scale[scale == 0.0] = 1.0
    return scale


def scale(x, data_mean, data_std):
    """Z-score normalization: (x - mean) / std  (std==0 dims pass through)."""
    return (x - data_mean) / _handle_zeros(data_std)


def inv_scale(x, data_mean, data_std):
    """Inverse of :func:`scale`: x * std + mean."""
    return data_std * x + data_mean


def minmax_scale_params(data_min, data_max, feature_range=(0, 1)):
    """Precompute (min_, scale_) for :func:`minmax_scale`."""
    data_range = data_max - data_min
    scale_ = (feature_range[1] - feature_range[0]) / _handle_zeros(data_range)
    return data_min, scale_


def minmax_scale(x, data_min=None, data_max=None, feature_range=(0, 1),
                 scale_=None, min_=None):
    """Min-max scaling into ``feature_range``, from raw (data_min, data_max)
    or from (min_, scale_) precomputed by :func:`minmax_scale_params`."""
    if scale_ is None or min_ is None:
        min_, scale_ = minmax_scale_params(data_min, data_max, feature_range)
    return (x - min_) * scale_ + feature_range[0]


def meanvar(dataset, lengths=None, mean_=0.0, var_=0.0,
            last_sample_count=0, return_last_sample_count=False):
    """Streaming per-dimension mean and population variance over all frames
    of a dataset (``nnmnkwii.preprocessing.meanvar``), Chan et al.'s
    parallel update.  Pass a previous call's (mean_, var_,
    last_sample_count) to continue accumulating, as VC pools X and Y."""
    mean_ = np.asarray(mean_, dtype=np.float64)
    var_ = np.asarray(var_, dtype=np.float64)
    n = int(last_sample_count)
    if n > 0:
        m2 = var_ * n
        total = mean_ * n
    else:
        m2 = None
        total = None

    for idx, x in enumerate(dataset):
        x = np.asarray(x, dtype=np.float64)
        if lengths is not None:
            x = x[: lengths[idx]]
        nb = x.shape[0]
        if nb == 0:
            continue
        mb = x.mean(axis=0)
        m2b = ((x - mb) ** 2).sum(axis=0)
        if total is None:
            total, m2, n = mb * nb, m2b, nb
        else:
            delta = mb - total / n
            total = total + mb * nb
            m2 = m2 + m2b + delta ** 2 * n * nb / (n + nb)
            n += nb

    mean_out = total / n
    var_out = m2 / n
    if return_last_sample_count:
        return mean_out, var_out, n
    return mean_out, var_out


def minmax(dataset, lengths=None):
    """Per-dimension min/max over all frames of a dataset."""
    data_min, data_max = None, None
    for idx, x in enumerate(dataset):
        x = np.asarray(x)
        if lengths is not None:
            x = x[: lengths[idx]]
        xmin, xmax = x.min(axis=0), x.max(axis=0)
        if data_min is None:
            data_min, data_max = xmin, xmax
        else:
            data_min = np.minimum(data_min, xmin)
            data_max = np.maximum(data_max, xmax)
    return data_min.astype(np.float64), data_max.astype(np.float64)


def modspec(y, n=4096, norm=None):
    """Modulation spectrum: power of the per-dimension temporal DFT."""
    s_complex = np.fft.rfft(y, n=n, axis=0, norm=norm)
    return s_complex.real ** 2 + s_complex.imag ** 2


def modspec_smoothing(y, modfs, n=4096, cutoff=50):
    """Trajectory smoothing by removing modulation frequencies above
    ``cutoff`` Hz (``nnmnkwii.preprocessing.modspec_smoothing``): a
    brick-wall low-pass along the time axis of each feature dimension.
    ``modfs`` is the frame rate (fs / hop_length, 200 Hz at 5 ms frames)."""
    T = y.shape[0]
    if n < T:
        n = 1 << (T - 1).bit_length()  # the next power of two >= T
    if cutoff >= modfs / 2:
        return y
    s = np.fft.rfft(y, n=n, axis=0)
    freqs = np.fft.rfftfreq(n, d=1.0 / modfs)
    s[freqs > cutoff] = 0.0
    out = np.fft.irfft(s, n=n, axis=0)[:T]
    return out.astype(y.dtype)


def trim_zeros_frames(x, eps=1e-7):
    """Drop trailing frames whose L1 norm is < eps (prepare_features_vc.py:49)."""
    T = x.shape[0]
    s = np.abs(x).sum(axis=tuple(range(1, x.ndim)))
    keep = T
    while keep > 0 and s[keep - 1] < eps:
        keep -= 1
    return x[:keep]


def adjust_frame_length(x, pad=True, divisible_by=1):
    """Pad (with zeros) or truncate one array so T % divisible_by == 0."""
    T = x.shape[0]
    if divisible_by > 1:
        rem = T % divisible_by
        if rem:
            if pad:
                T = T + divisible_by - rem
            else:
                T = T - rem
    return _fix_length(x, T)


def adjust_frame_lengths(x, y, pad=True, ensure_even=False, divisible_by=1):
    """Make two arrays share a frame count (prepare_features_vc.py:113-115).

    If ``pad``, both are zero-padded up to the max length, else truncated to
    the min; then the common length is adjusted to ``divisible_by``.
    """
    if ensure_even:
        divisible_by = 2
    Tx, Ty = x.shape[0], y.shape[0]
    T = max(Tx, Ty) if pad else min(Tx, Ty)
    if divisible_by > 1:
        rem = T % divisible_by
        if rem:
            T = T + divisible_by - rem if pad else T - rem
    return _fix_length(x, T), _fix_length(y, T)


def _fix_length(x, T):
    if x.shape[0] == T:
        return x
    if x.shape[0] > T:
        return x[:T]
    pad_width = [(0, T - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, mode="constant")


def interp1d(f0, kind="slinear"):
    """Fill unvoiced (zero) regions of an F0/lf0 trajectory by interpolation
    (``nnmnkwii.preprocessing.interp1d``, prepare_features_tts.py:136).

    ``f0`` is (T,) or (T, 1); zeros are treated as unvoiced and replaced by
    scipy interpolation over the voiced samples; leading/trailing unvoiced
    regions take the nearest voiced value.  Quadratic or cubic interpolation
    over fewer than 4 voiced samples falls back to slinear (2-3 samples) or
    to the one voiced value.
    """
    import scipy.interpolate

    squeeze = f0.ndim == 2
    v = f0.reshape(-1).astype(np.float64)
    nz = np.nonzero(v)[0]
    if len(nz) == 0:
        return f0
    if len(nz) < 4 and kind in ("quadratic", "cubic"):
        kind = "slinear" if len(nz) >= 2 else "nearest"
    if len(nz) == 1:
        out = np.full_like(v, v[nz[0]])
    else:
        f = scipy.interpolate.interp1d(
            nz, v[nz], kind=kind, bounds_error=False,
            fill_value=(v[nz[0]], v[nz[-1]]))
        out = v.copy()
        zeros = np.where(v == 0)[0]
        out[zeros] = f(zeros)
    out = out.astype(f0.dtype)
    return out.reshape(f0.shape) if squeeze else out
