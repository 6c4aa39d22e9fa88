"""WORLD-equivalent vocoder: analysis (F0, spectral envelope, aperiodicity)
and synthesis.

This re-provides the pyworld (WORLD C++) surface the reference is built on
(SURVEY.md section 2.3): ``dio``, ``stonemask``, ``harvest``, ``cheaptrick``,
``d4c``, ``code_aperiodicity``, ``decode_aperiodicity``, ``synthesize``,
``get_cheaptrick_fft_size`` (prepare_features_vc.py:46-48,
prepare_features_tts.py:111-123, evaluation_vc.py:45-48/104-108,
evaluation_tts.py:106/116-124).

The algorithms are implemented from their published descriptions (Morise's
DIO / CheapTrick / D4C papers), not ported from the WORLD sources:

  dio         multi-channel zero-crossing/extremum interval analysis over a
              half-octave low-pass filter bank; candidate per channel scored
              by the dispersion of its four interval estimates.
  stonemask   F0 refinement by parabolic-interpolated normalized
              autocorrelation around the DIO estimate (same goal as WORLD's
              instantaneous-frequency refinement: sub-bin F0 accuracy).
  harvest     Harvest-style estimation: dense multi-channel candidate map,
              best-stable base contour, contour FIXING (short-segment
              removal + extension through unstable regions by re-selecting
              agreeing candidates), harmonic-lock correction, fixed-horizon
              coherence voicing gate, NCC refinement.  Measured on synthetic
              ground truth (vocoder_fidelity.json): 0.26 Hz RMSE, zero
              gross errors, 0.6% core V/UV error.
  cheaptrick  pitch-adaptive Hanning windowing (3 T0), 2f0/3 rectangular
              spectral smoothing, quefrency liftering with sinc recovery and
              the q1 = -0.15 compensation lifter.
  d4c         band aperiodicity from the normalized autocorrelation of
              band-passed signal segments at lag T0 (periodicity ratio),
              expanded to a full spectral aperiodicity envelope.
  synthesize  pulse-synchronous minimum-phase periodic component + frame
              OLA noise component shaped by sp * ap^2.

Host-side float64 throughout.  Per-utterance analysis is embarrassingly
parallel and is fanned out across processes by the feature-prep CLIs; the
synthesis overlap-add scatter runs through the C++ ``ola_add`` kernel
(cpp/frontend.cpp) when the host library is built, with an in-place NumPy
fallback.

The port's own copy of gantts_tpu/frontend/world.py, numerics unchanged;
its C++ twins load through ``gantts_tpu_torch.frontend.native``.
"""

from __future__ import annotations

import numpy as np

DEFAULT_F0_FLOOR = 71.0
DEFAULT_F0_CEIL = 800.0
DEFAULT_FRAME_PERIOD = 5.0
# Unvoiced-frame analysis knobs (see cheaptrick).  The C++ twin
# (cpp/frontend.cpp cheaptrick_frames) hardcodes the defaults, so the
# dispatch in cheaptrick() falls back to this NumPy oracle whenever they
# are changed.  Tuning notes (tools/fidelity_decomp.py experiments): the
# unvoiced round-trip MCD is dominated by the non-idempotent smooth+lifter
# bias plus the chi^2 periodogram variance of the re-analysis; lowering
# CHEAPTRICK_UV_F0 to 180 trades ~0.07 dB headline MCD for 90 ms unvoiced
# analysis spans that would smear real-speech transients, so the WORLD
# defaults stay.
UV_AVG_SEGMENTS = 9    # unvoiced periodogram sub-windows
UV_AVG_SPACING = 1.0   # sub-window center spacing, in units of T0
CHEAPTRICK_UV_F0 = 500.0  # pseudo-F0 for unvoiced frames
COHERENCE_LP_HARMONICS = 10  # low-f0 probe band limit (_coherence_gate_py)


def get_cheaptrick_fft_size(fs, f0_floor=DEFAULT_F0_FLOOR):
    """2^ceil(log2(3 fs / f0_floor + 1)) (WORLD's CheapTrick contract)."""
    return int(2 ** np.ceil(np.log2(3.0 * fs / f0_floor + 1.0)))


def _is_pow2(n):
    return n > 0 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# F0 estimation
# ---------------------------------------------------------------------------

def _lowpass_fir(x, fs, cutoff, taps=None):
    """Zero-phase windowed-sinc low-pass via FFT convolution."""
    if taps is None:
        taps = int(fs / cutoff * 4) | 1
    n = np.arange(taps) - taps // 2
    h = np.sinc(2 * cutoff / fs * n) * np.blackman(taps)
    h /= h.sum()
    import scipy.signal

    return scipy.signal.fftconvolve(x, h, mode="same")


def _interval_candidates(sig, fs, frame_times):
    """Four interval-based F0 tracks (neg/pos zero crossings, peaks, dips),
    interpolated at frame_times.  Returns (4, T) array (0 where undefined)."""
    tracks = np.zeros((4, len(frame_times)))
    s0, s1 = sig[:-1], sig[1:]

    def events_to_track(locs, row):
        if len(locs) < 3:
            return
        ivals = np.diff(locs) / fs
        good = ivals > 0
        if good.sum() < 2:
            return
        centers = (locs[:-1] + locs[1:]) / 2 / fs
        f0s = 1.0 / ivals
        tracks[row] = np.interp(frame_times, centers[good], f0s[good],
                                left=f0s[good][0], right=f0s[good][-1])

    neg = np.where((s0 > 0) & (s1 <= 0))[0].astype(np.float64)
    pos = np.where((s0 < 0) & (s1 >= 0))[0].astype(np.float64)
    d0, d1 = np.diff(sig)[:-1], np.diff(sig)[1:]
    peaks = np.where((d0 > 0) & (d1 <= 0))[0].astype(np.float64) + 1
    dips = np.where((d0 < 0) & (d1 >= 0))[0].astype(np.float64) + 1
    for row, locs in enumerate((neg, pos, peaks, dips)):
        events_to_track(locs, row)
    return tracks


def dio(x, fs, f0_floor=DEFAULT_F0_FLOOR, f0_ceil=DEFAULT_F0_CEIL,
        frame_period=DEFAULT_FRAME_PERIOD, channels_in_octave=2.0,
        allowed_range=0.1):
    """Fundamental frequency estimation.

    Returns (f0, temporal_positions); f0 == 0 marks unvoiced frames,
    matching the pyworld call contract (prepare_features_vc.py:46,
    evaluation_vc.py:45).
    """
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    hop_t = frame_period / 1000.0
    n_frames = int(len(x) / fs / hop_t) + 1
    t = np.arange(n_frames) * hop_t

    # same channel map as harvest (one shared implementation; ties resolve
    # to the first/lowest channel in both the old incremental loop and
    # np.argmin)
    cands, scores = _candidate_map(x, fs, f0_floor, f0_ceil, t,
                                   channels_in_octave)
    best = np.argmin(scores, axis=0)
    idx = np.arange(n_frames)
    f0 = np.where(scores[best, idx] < allowed_range, cands[best, idx], 0.0)
    # Periodicity gate: interval statistics alone accept narrow-band noise
    # (filtered noise has regular zero crossings); require the raw signal's
    # normalized autocorrelation at the candidate lag to confirm voicing.
    _, peak_r = _ncc_refine(x, f0, t, fs)
    f0[peak_r < 0.45] = 0.0
    # order: harmonic-lock correction FIRST (a frame locked onto k*f0 can
    # be rescued; the coherence gate would instead zero it), then the
    # ringing gate, then neighbor consistency.
    f0 = _subharmonic_fix(x, f0, t, fs, f0_floor)
    f0 = _coherence_gate(x, f0, t, fs)
    f0 = _contour_consistency_fix(x, f0, t, fs)
    f0 = _remove_jumps(f0, allowed_range=0.18)
    return f0, t


def _coherence_gate(x, f0, temporal_positions, fs, horizon_s=0.012,
                    thresh=0.5, tol=0.08):
    """Dispatch for the coherence voicing gate (C++ fast path; NumPy oracle
    in :func:`_coherence_gate_py` — see its docstring for the rationale)."""
    from gantts_tpu_torch.frontend import native

    if native.has_coherence_gate():
        return native.coherence_gate(
            np.asarray(x, dtype=np.float64), f0, temporal_positions, fs,
            horizon_s, thresh, tol)
    return _coherence_gate_py(x, f0, temporal_positions, fs, horizon_s,
                              thresh, tol)


def _coherence_gate_py(x, f0, temporal_positions, fs, horizon_s=0.012,
                       thresh=0.5, tol=0.08):
    """Reject voiced candidates that decohere within a fixed TIME horizon.

    The one-period NCC gate cannot tell glottal periodicity from
    noise-driven formant RINGING: a resonator at center frequency fc with
    bandwidth bw is locally periodic at lag 1/fc no matter the window.  But
    its autocorrelation decays with the coherence time 1/(pi*bw) — under
    5 ms for any speech formant (bw >= 50 Hz) — while true voicing stays
    correlated over tens of ms.  So test the NCC at the multiple of the
    candidate period nearest ``horizon_s`` (>= 2 periods, small lag search
    for jitter/vibrato): ringing tracks fall below ``thresh`` there, real
    f0 does not (measured on the copy-synthesis ground truth: rejects half
    the false-voiced frames at a 2/919 true-frame cost; the survivors are
    then fragmented below _remove_jumps' min_run).  Frames so close to a
    signal edge that no probe lag fits are left untouched (a partially
    clipped window is still gated, just off-center).

    Low-F0 chirp robustness: when the horizon is PERIOD-clamped (k forced
    up to 2 because round(horizon_s * f) < 2, i.e. f < ~167 Hz), the
    correlation support spans many vibrato-scale milliseconds and the
    within-support f0 drift decorrelates the high harmonics — true voiced
    80 Hz frames read as incoherent (31% core V/UV error on the f0_low_85hz
    fidelity condition).  For those frames only, the probe is band-limited
    to the first ~10 harmonics (windowed-sinc low-pass) and the support
    shortened to (k + 0.75) * T0 per side; ringing rejection is unaffected
    (a resonator's decay at lag k*T0 does not depend on the support
    length).  Measured: low-f0 core V/UV 0.31 -> 0.05, main corpus
    unchanged (vocoder_fidelity.json conditions)."""
    import scipy.signal

    x = np.asarray(x, dtype=np.float64)
    out = f0.copy()
    fir_cache = {}  # (cutoff, taps) -> FIR; f repeats across frames
    for i, (f, tc) in enumerate(zip(f0, temporal_positions)):
        if f <= 0:
            continue
        T0 = fs / f
        k_nat = int(round(horizon_s * fs / T0))
        k = max(2, k_nat)
        clamped = k_nat < 2
        half = int((k + (0.75 if clamped else 2)) * T0)
        c = int(tc * fs)
        lo, hi = max(0, c - half), min(len(x), c + half)
        seg = x[lo:hi]
        seg = seg - seg.mean()
        if clamped:
            cutoff = COHERENCE_LP_HARMONICS * f
            taps = int(fs / cutoff * 4) | 1
            h = fir_cache.get((cutoff, taps))
            if h is None:
                nn = np.arange(taps) - taps // 2
                h = np.sinc(2.0 * cutoff / fs * nn) * np.blackman(taps)
                h /= h.sum()
                fir_cache[cutoff, taps] = h
            seg = scipy.signal.fftconvolve(seg, h, mode="same")
        lags = np.arange(max(2, int(k * T0 * (1 - tol))),
                         min(len(seg) - 2, int(k * T0 * (1 + tol)) + 1))
        if len(lags) < 1:
            continue
        best = -1.0
        for lag in lags:
            a, b = seg[:-lag], seg[lag:]
            d = np.sqrt(max(1e-12, np.dot(a, a) * np.dot(b, b)))
            best = max(best, float(np.dot(a, b) / d))
        if best < thresh:
            out[i] = 0.0
    return out


def _subharmonic_fix(x, f0, temporal_positions, fs, f0_floor,
                     max_div=6, improvement=0.12):
    from gantts_tpu_torch.frontend import native

    if native.has_analysis():
        return native.subharmonic_fix(
            np.asarray(x, dtype=np.float64), f0, temporal_positions, fs,
            f0_floor, max_div, improvement)
    return _subharmonic_fix_py(x, f0, temporal_positions, fs, f0_floor,
                               max_div, improvement)


def _subharmonic_fix_py(x, f0, temporal_positions, fs, f0_floor,
                        max_div=6, improvement=0.12):
    """Harmonic (octave-up) error correction.

    If the estimate locked onto the k-th harmonic, the NCC at the TRUE
    (longer) period k*T0_est is substantially HIGHER than at T0_est (which
    is not a real period of the signal).  A correct estimate already sits at
    an NCC maximum, so requiring a clear improvement (not mere equality —
    any multiple of a true period also correlates ~1) avoids demoting
    correct frames to subharmonics."""
    x = np.asarray(x, dtype=np.float64)
    out = f0.copy()
    for i, (f, tc) in enumerate(zip(f0, temporal_positions)):
        if f <= 0:
            continue
        divs = [k for k in range(2, max_div + 1) if f / k >= f0_floor]
        if not divs:
            continue
        T0max = fs / (f / max(divs))
        half = int(1.2 * T0max)
        c = int(tc * fs)
        lo, hi = max(0, c - half), min(len(x), c + half)
        seg = x[lo:hi]
        seg = seg - seg.mean()

        def ncc(lag):
            if lag < 2 or lag >= len(seg) - 1:
                return -1.0
            a, b = seg[:-lag], seg[lag:]
            d = np.sqrt(max(1e-12, np.dot(a, a) * np.dot(b, b)))
            return np.dot(a, b) / d

        r1 = ncc(int(round(fs / f)))
        best_k, best_r = 1, r1
        for k in divs:
            rk = ncc(int(round(k * fs / f)))
            if rk > best_r:
                best_k, best_r = k, rk
        if best_k > 1 and best_r > r1 + improvement and best_r > 0.5:
            out[i] = f / best_k
    return out


def _contour_consistency_fix(x, f0, temporal_positions, fs, rel=0.3,
                             window=3):
    """Re-probe voiced frames that disagree with their neighbors (the
    FixF0Contour step-2/3 analog of WORLD's Dio).

    A frame can lock onto a formant-ringing frequency even inside a voiced
    run (typically near voicing offsets, where the subharmonic check's
    window spans the boundary and degrades).  Such frames disagree with
    the local voiced median by far more than any physiological f0 change
    between 5 ms frames; re-seed them at the median and keep the NCC-refined
    value only if it confirms periodicity there, else mark unvoiced."""
    x = np.asarray(x, dtype=np.float64)
    out = f0.copy()
    n = len(f0)
    probes = np.zeros(n)  # median seed per outlier frame; 0 elsewhere
    for i in range(n):
        f = f0[i]
        if f <= 0:
            continue
        lo, hi = max(0, i - window), min(n, i + window + 1)
        neigh = [f0[j] for j in range(lo, hi) if j != i and f0[j] > 0]
        if len(neigh) < 2:
            continue
        med = float(np.median(neigh))
        if abs(f - med) / med > rel:
            probes[i] = med
    if (probes > 0).any():
        # one batched refine call (it skips f0 <= 0 frames internally)
        refined, peak_r = _ncc_refine(x, probes, temporal_positions, fs)
        sel = probes > 0
        out[sel] = np.where(peak_r[sel] >= 0.45, refined[sel], 0.0)
    return out


ONSET_REPROBE_R = 0.6  # NCC threshold for the pre-onset voicing re-probe


def _onset_reprobe(x, f0, temporal_positions, fs, thresh=ONSET_REPROBE_R):
    """Extend each voiced run ONE frame earlier when the pre-onset frame is
    measurably periodic at the onset F0.

    Windowed voicing decisions turn on systematically LATE at voicing
    onsets (the first voiced frame's analysis window is half unvoiced, so
    gates reject it; measured ~1 frame mean lag on the fidelity corpus).
    Offsets are left alone: the post-offset formant ring is quasi-periodic,
    and rendering pulses there matches the signal BETTER than noise
    (measured — an offset-side trim regresses the boundary MCD ~0.2 dB).
    Evidence-gated via the existing NCC primitive (_ncc_refine, C++ twin
    pinned): only frames whose own centered window confirms periodicity at
    the onset F0 are claimed, so true silence before an onset stays
    unvoiced.  Effect (tools/copy_synthesis_bench.py): vuv_boundary
    round-trip MCD 1.74 -> 1.67 dB with total V/UV error unchanged."""
    out = f0.copy()
    probes = np.zeros(len(f0))
    for i in range(1, len(f0)):
        if f0[i] > 0 and f0[i - 1] == 0:
            probes[i - 1] = f0[i]
    if not (probes > 0).any():
        return out
    refined, peak_r = _ncc_refine(np.asarray(x, dtype=np.float64), probes,
                                  temporal_positions, fs)
    sel = (probes > 0) & (peak_r >= thresh)
    out[sel] = refined[sel]
    return out


def _remove_jumps(f0, allowed_range=0.18, min_run=3):
    """Zero out short/discontinuous voiced runs (DIO FixStep analog)."""
    f0 = f0.copy()
    T = len(f0)
    # drop voiced runs shorter than min_run (runs split at relative jumps)
    i = 0
    while i < T:
        if f0[i] == 0:
            i += 1
            continue
        j = i
        while j < T and f0[j] > 0 and \
                (j == i or abs(f0[j] - f0[j - 1]) / f0[j - 1] <= allowed_range):
            j += 1
        if j - i < min_run:
            f0[i:j] = 0.0
        i = j
    return f0


def _ncc_refine(x, f0, temporal_positions, fs):
    """Per-frame F0 refinement by parabolic-interpolated normalized
    autocorrelation around the current estimate (C++ fast path; NumPy
    oracle in :func:`_ncc_refine_py`).

    Returns (refined_f0, peak_r) where peak_r is the NCC value at the best
    lag (1 = perfectly periodic, used as a voicing confidence)."""
    from gantts_tpu_torch.frontend import native

    if native.has_analysis():
        return native.ncc_refine(
            np.asarray(x, dtype=np.float64), f0, temporal_positions, fs)
    return _ncc_refine_py(x, f0, temporal_positions, fs)


def _ncc_refine_py(x, f0, temporal_positions, fs):
    """NumPy oracle for :func:`_ncc_refine` (cpp/frontend.cpp ncc_refine)."""
    x = np.asarray(x, dtype=np.float64)
    refined = f0.copy()
    peak_r = np.zeros(len(f0))
    for i, (f, tc) in enumerate(zip(f0, temporal_positions)):
        if f <= 0:
            continue
        T0 = fs / f
        half = int(2 * T0)
        c = int(tc * fs)
        lo, hi = max(0, c - half), min(len(x), c + half)
        seg = x[lo:hi]
        if len(seg) < int(1.5 * T0) + 2:
            continue
        seg = seg - seg.mean()
        lags = np.arange(max(2, int(T0 * 0.8)), min(len(seg) - 2,
                                                    int(T0 * 1.25)))
        if len(lags) < 3:
            continue
        e0 = np.dot(seg, seg)
        if e0 < 1e-12:
            continue
        r = np.array([
            np.dot(seg[:-k], seg[k:])
            / max(1e-12, np.sqrt(np.dot(seg[:-k], seg[:-k])
                                 * np.dot(seg[k:], seg[k:])))
            for k in lags])
        k = int(np.argmax(r))
        peak_r[i] = float(r[k])
        if 0 < k < len(lags) - 1:
            y0, y1, y2 = r[k - 1], r[k], r[k + 1]
            denom = y0 - 2 * y1 + y2
            delta = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
        else:
            delta = 0.0
        best_lag = lags[k] + delta
        cand = fs / best_lag
        if 0.7 * f < cand < 1.4 * f:
            refined[i] = cand
    return refined, peak_r


def stonemask(x, f0, temporal_positions, fs):
    """Refine an F0 contour by parabolic-interpolated autocorrelation.

    Call contract of pyworld.stonemask (prepare_features_vc.py:47)."""
    refined, _ = _ncc_refine(x, f0, temporal_positions, fs)
    return refined


def _candidate_map(x, fs, f0_floor, f0_ceil, frame_times,
                   channels_in_octave):
    """Per-channel interval-based F0 candidates with stability scores.

    Returns (cands, scores): (n_ch, T) arrays; score = relative dispersion
    of the four interval estimates (lower = more periodic), inf where the
    channel produced nothing usable."""
    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor)
                       * channels_in_octave)) + 1
    boundary_f0s = f0_floor * 2.0 ** (np.arange(1, n_ch + 1)
                                      / channels_in_octave)
    T = len(frame_times)
    cands = np.zeros((n_ch, T))
    scores = np.full((n_ch, T), np.inf)
    for ci, bf0 in enumerate(boundary_f0s):
        filtered = _lowpass_fir(x, fs, bf0)
        tracks = _interval_candidates(filtered, fs, frame_times)
        valid = (tracks > 0).all(axis=0)
        mean_f0 = tracks.mean(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            score = tracks.std(axis=0) / np.maximum(mean_f0, 1e-9)
        in_band = (mean_f0 > max(f0_floor, bf0 / 4)) & (mean_f0 < bf0) \
            & (mean_f0 < f0_ceil)
        ok = valid & in_band
        cands[ci, ok] = mean_f0[ok]
        scores[ci, ok] = score[ok]
    return cands, scores


def _select_from_candidates(contour, cands, scores, i, rel=0.18):
    """Best candidate at frame i within ``rel`` of ``contour`` (Hz value);
    returns 0.0 if none."""
    ref = contour
    col = cands[:, i]
    ok = (col > 0) & (np.abs(col - ref) / max(ref, 1e-9) <= rel)
    if not ok.any():
        return 0.0
    j = np.argmin(np.where(ok, scores[:, i], np.inf))
    return float(col[j])


def harvest(x, fs, f0_floor=DEFAULT_F0_FLOOR, f0_ceil=DEFAULT_F0_CEIL,
            frame_period=DEFAULT_FRAME_PERIOD, channels_in_octave=8.0,
            allowed_range=0.12):
    """Harvest-style F0 estimation: dense candidate map + contour growing.

    Follows the structure of Morise's Harvest (implemented from the paper,
    not ported): (1) a dense multi-channel candidate map with per-candidate
    stability scores; (2) a base contour from the best-scoring stable
    candidates, NCC-gated for voicing; (3) contour FIXING — voiced segments
    are split at >18% jumps, short segments dropped, and each segment is
    EXTENDED forward/backward through unstable regions by re-selecting, at
    each neighbor frame, the candidate closest to the segment edge value
    (this is what rescues onset/offset frames whose best raw candidate is a
    harmonic); (4) NCC refinement constrained around the fixed contour.
    Returns the pyworld (f0, temporal_positions) contract
    (prepare_features_tts.py:111-115)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    hop_t = frame_period / 1000.0
    n_frames = int(len(x) / fs / hop_t) + 1
    t = np.arange(n_frames) * hop_t

    cands, scores = _candidate_map(x, fs, f0_floor, f0_ceil, t,
                                   channels_in_octave)

    # base contour: best-scoring candidate per frame, stability-gated
    best = np.argmin(scores, axis=0)
    base = cands[best, np.arange(n_frames)]
    base_score = scores[best, np.arange(n_frames)]
    base[base_score > allowed_range] = 0.0
    # periodicity gate (same rationale as dio)
    _, peak_r = _ncc_refine(x, base, t, fs)
    base[peak_r < 0.45] = 0.0
    # harmonic-lock correction BEFORE contour fixing: a run that locked onto
    # the k-th harmonic would otherwise survive as a self-consistent segment
    # (and before the coherence gate, which would zero such frames instead
    # of letting them be corrected)
    base = _subharmonic_fix(x, base, t, fs, f0_floor)
    base = _coherence_gate(x, base, t, fs)

    # ---- contour fixing --------------------------------------------------
    f0 = _remove_jumps(base, allowed_range=0.18, min_run=6)

    # extension: grow each voiced segment through frames where SOME channel
    # agrees with the contour, even if that frame's best candidate didn't
    segs = _voiced_segments(f0)
    ext = f0.copy()
    for (a, b) in segs:
        # backward from a-1
        ref = f0[a]
        i = a - 1
        while i >= 0 and ext[i] == 0:
            c = _select_from_candidates(ref, cands, scores, i)
            if c <= 0:
                break
            ext[i] = c
            ref = c
            i -= 1
        # forward from b
        ref = f0[b - 1]
        i = b
        while i < n_frames and ext[i] == 0:
            c = _select_from_candidates(ref, cands, scores, i)
            if c <= 0:
                break
            ext[i] = c
            ref = c
            i += 1

    # extended frames must still look periodic (NCC voicing confirmation)
    grown = (ext > 0) & (f0 == 0)
    if grown.any():
        probe = np.where(grown, ext, 0.0)
        _, r_ext = _ncc_refine(x, probe, t, fs)
        ext[grown & (r_ext < 0.45)] = 0.0
        still = np.where((ext > 0) & grown, ext, 0.0)
        gated = _coherence_gate(x, still, t, fs)
        ext[grown & (still > 0) & (gated == 0)] = 0.0

    f0 = _remove_jumps(ext, allowed_range=0.18, min_run=3)

    # ---- refinement around the fixed contour ------------------------------
    f0, _ = _ncc_refine(x, f0, t, fs)
    # onset-lag correction LAST (operates on the final voicing decisions)
    f0 = _onset_reprobe(x, f0, t, fs)
    return f0, t


def _voiced_segments(f0):
    """[(start, end)) index pairs of voiced runs."""
    segs = []
    i, T = 0, len(f0)
    while i < T:
        if f0[i] == 0:
            i += 1
            continue
        j = i
        while j < T and f0[j] > 0:
            j += 1
        segs.append((i, j))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Spectral envelope
# ---------------------------------------------------------------------------

def cheaptrick(x, f0, temporal_positions, fs, q1=-0.15,
               f0_floor=DEFAULT_F0_FLOOR, fft_size=None,
               uv_boundary_clamp=True):
    """Pitch-adaptive spectral envelope; (T, fft_size//2+1) power spectrum.

    Contract of pyworld.cheaptrick (prepare_features_vc.py:48,
    prepare_features_tts.py:120, evaluation_vc.py:47).  The per-frame loop
    runs in C++ when the host library is available (cpp/frontend.cpp
    cheaptrick_frames); this NumPy body is its oracle.

    ``uv_boundary_clamp`` enables the transition-aware unvoiced sub-window
    placement (see the loop comment).  Default ON — production analysis
    wants it; the fidelity tooling's co-analysis distance
    (tools/copy_synthesis_bench.py frame_mcd) turns it OFF so the metric
    stays a fixed instrument comparable across rounds."""
    x = np.asarray(x, dtype=np.float64)
    if fft_size is None:
        fft_size = get_cheaptrick_fft_size(fs, f0_floor)
    from gantts_tpu_torch.frontend import native

    # the C++ engine's FFT is radix-2 only; non-power-of-two sizes (legal
    # for the np.fft oracle) must take the NumPy path.  The twin also
    # hardcodes the unvoiced-averaging defaults, so any tuned constants
    # force the oracle path rather than silently ignoring them.
    if (native.has_analysis() and _is_pow2(fft_size)
            and UV_AVG_SEGMENTS == 9 and UV_AVG_SPACING == 1.0
            and CHEAPTRICK_UV_F0 == 500.0):
        return native.cheaptrick_frames(x, f0, temporal_positions, fs,
                                        q1, f0_floor, fft_size,
                                        uv_clamp=uv_boundary_clamp)
    n_bins = fft_size // 2 + 1
    T = len(f0)
    sp = np.empty((T, n_bins))
    default_f0 = CHEAPTRICK_UV_F0
    # only consumed by the clamp branch below; the fidelity tooling's
    # co-analysis path runs with uv_boundary_clamp=False
    run_lo, run_hi = (_uv_run_bounds(f0, temporal_positions, fs, f0_floor)
                      if uv_boundary_clamp else (None, None))

    for i in range(T):
        voiced = f0[i] > f0_floor / 2
        f = f0[i] if voiced else default_f0
        T0 = fs / f
        half = int(1.5 * T0)
        c = int(round(temporal_positions[i] * fs))
        # Unvoiced frames: Welch-average K sub-window periodograms spaced
        # T0 apart (conscious improvement over WORLD's single window; no
        # harmonic structure exists to protect, and the single 3*T0=6 ms
        # window leaves the noise periodogram with ~4 degrees of freedom —
        # the dominant term in copy-synthesis MCD.  K=9 spans ~22 ms and
        # cuts the unvoiced co-analysis MCD ~2x; measured in
        # vocoder_fidelity.json).  Voiced frames are untouched.
        K = 1 if voiced else UV_AVG_SEGMENTS
        ps = np.zeros(n_bins)
        for j in range(K):
            off = int(round((j - (K - 1) / 2.0) * T0 * UV_AVG_SPACING))
            if not voiced and uv_boundary_clamp:
                # Transition-aware placement (round 5, vuv_boundary +
                # unvoiced classes): shift any sub-window that would cross
                # into an adjacent VOICED run back inside this unvoiced
                # run.  Near a boundary the crossing window reads pulse
                # energy into the noise envelope; synthesis then renders
                # that energy as FRESH noise on top of the re-analyzed
                # voiced leak — a round-trip double-count worth ~0.13 dB
                # on the boundary class and ~0.17 dB on unvoiced-steady
                # (whose 9-window span reaches 14 ms).  The shift keeps
                # all K averaging windows (estimator variance unchanged)
                # and is a no-op away from boundaries.
                wlo = c - half + off
                whi = c + half + off
                if wlo < run_lo[i]:
                    off += max(0, min(run_lo[i] - wlo, run_hi[i] - whi))
                elif whi > run_hi[i]:
                    off -= max(0, min(whi - run_hi[i], wlo - run_lo[i]))
            idx = np.arange(c - half + off, c + half + 1 + off)
            seg = np.zeros(len(idx))
            ok = (idx >= 0) & (idx < len(x))
            seg[ok] = x[idx[ok]]
            win = np.hanning(len(seg))
            wseg = seg * win
            wseg -= win * (wseg.sum() / max(win.sum(), 1e-12))  # DC removal
            ps += np.abs(np.fft.rfft(wseg, fft_size)) ** 2
        ps /= K
        ps = _linear_smoothing(ps, 2.0 * f / 3.0, fs, fft_size)
        ps = np.maximum(ps, 1e-12 * max(ps.max(), 1e-300))
        # liftering: sinc recovery of the rect smoothing + q1 compensation
        logps = np.log(ps)
        cep = np.fft.irfft(logps)
        quef = np.arange(1, n_bins) / fs * fft_size  # quefrency in samples
        arg = np.pi * f * quef / fs
        lifter = np.ones(n_bins)
        lifter[1:] = np.sin(arg) / arg
        comp = (1.0 - 2.0 * q1) + 2.0 * q1 * np.cos(2 * np.pi * quef * f / fs)
        lif = np.ones(n_bins)
        lif[1:] = lifter[1:] * comp
        full = np.zeros(fft_size)
        full[:n_bins] = lif
        full[n_bins:] = lif[1:-1][::-1]
        sp[i] = np.exp(np.fft.rfft(cep * full).real[:n_bins])
    return sp


def _uv_run_bounds(f0, temporal_positions, fs, f0_floor):
    """Per-frame sample bounds of the frame's own voicing run, for the
    unvoiced sub-window clamp in cheaptrick (and its C++ twin — integer
    arithmetic only, ties-to-even center rounding, so the two stay
    decision-exact).  Boundaries sit midway between adjacent frame
    centers; run edges at the signal ends carry +-inf sentinels so the
    clamp only engages toward an adjacent VOICED run, never at the file
    edge (windows there legitimately hang off into zero padding)."""
    T = len(f0)
    v = np.asarray(f0) > f0_floor / 2
    centers = np.asarray(
        np.round(np.asarray(temporal_positions) * fs), dtype=np.int64)
    big = np.int64(1) << 60
    lo = np.full(T, -big, dtype=np.int64)
    hi = np.full(T, big, dtype=np.int64)
    i = 0
    while i < T:
        j = i
        while j < T and v[j] == v[i]:
            j += 1
        if i > 0:
            lo[i:j] = (centers[i - 1] + centers[i]) // 2
        if j < T:
            hi[i:j] = (centers[j - 1] + centers[j]) // 2
        i = j
    return lo, hi


def _linear_smoothing(ps, width_hz, fs, fft_size):
    """Rectangular smoothing of a one-sided power spectrum (width in Hz)."""
    n_bins = len(ps)
    w_bins = width_hz * fft_size / fs
    if w_bins <= 1:
        return ps
    # moving average via cumulative sum with fractional width
    k = int(np.floor(w_bins / 2))
    ext = np.r_[ps[k:0:-1], ps, ps[-2:-k - 2:-1]]  # mirror edges
    c = np.cumsum(ext)
    out = (c[2 * k:] - np.r_[0.0, c[:-2 * k - 1]]) / (2 * k + 1)
    return out[:n_bins]


# ---------------------------------------------------------------------------
# Aperiodicity
# ---------------------------------------------------------------------------

D4C_SUB_PERIODS = 1.5  # sub-window length (periods) for the band measure
D4C_N_SUB = 5          # sub-windows per frame


def _band_ap_subcplx_py(band_re, band_im, f0, temporal_positions, fs,
                        sub_periods=D4C_SUB_PERIODS, n_sub=D4C_N_SUB):
    """NumPy oracle for the per-frame band periodicity measure
    (cpp/frontend.cpp d4c_band_cplx).

    Periodicity r per band = energy-weighted mean over ``n_sub`` short
    sub-windows (each ``sub_periods`` * T0 long, spaced T0 apart) of the
    MAGNITUDE of the complex correlation of the band's analytic signal at
    lag ~T0 (max over a +-3% lag search).  Short sub-windows keep the
    within-window f0 chirp (vibrato/declination) from decorrelating high
    harmonics, and the complex magnitude is insensitive to the carrier
    phase offset left by the integer-lag grid — the two effects that made
    a plain long-window NCC overestimate high-band aperiodicity ~5x on
    known-aperiodicity mixtures (see tools/copy_synthesis_bench.py
    d4c_accuracy).  ap = sqrt(1 - r)."""
    n_bands, n = band_re.shape
    T = len(f0)
    band_ap = np.ones((T, n_bands)) * (1.0 - 1e-12)
    for i in range(T):
        f = f0[i]
        if f <= 0:
            continue
        T0 = fs / f
        lag0 = int(round(T0))
        srch = max(1, int(round(0.03 * T0)))
        c = int(round(temporal_positions[i] * fs))
        subL = int(sub_periods * T0)
        offs = (np.arange(n_sub) - (n_sub - 1) / 2.0) * T0
        for b in range(n_bands):
            zr, zi = band_re[b], band_im[b]
            num = 0.0
            den = 0.0
            for off in offs:
                s0 = int(c + off - subL / 2)
                s1 = s0 + subL
                if s0 < 0 or s1 + lag0 + srch >= n:
                    continue
                ar, ai = zr[s0:s1], zi[s0:s1]
                ea = np.dot(ar, ar) + np.dot(ai, ai)
                if ea < 1e-300:
                    continue
                best = 0.0
                for lag in range(lag0 - srch, lag0 + srch + 1):
                    br, bi = zr[s0 + lag:s1 + lag], zi[s0 + lag:s1 + lag]
                    eb = np.dot(br, br) + np.dot(bi, bi)
                    # <a, b> for analytic signals a = ar+j*ai, b = br+j*bi
                    cr = np.dot(ar, br) + np.dot(ai, bi)
                    ci = np.dot(ar, bi) - np.dot(ai, br)
                    d = np.sqrt(max(1e-300, ea * eb))
                    best = max(best, np.sqrt(cr * cr + ci * ci) / d)
                num += ea * best
                den += ea
            if den <= 0.0:
                continue
            r = min(max(num / den, 0.0), 1.0 - 1e-12)
            band_ap[i, b] = np.sqrt(max(1.0 - r, 1e-12))
    return band_ap


def d4c(x, f0, temporal_positions, fs, threshold=0.85, fft_size=None):
    """Band aperiodicity -> full (T, fft_size//2+1) aperiodicity envelope.

    Periodicity per band measured on the band-passed analytic signal as the
    complex correlation magnitude at lag ~T0 over short sub-windows (see
    :func:`_band_ap_subcplx_py`); aperiodicity = sqrt(1 - r).  Accuracy is
    validated against known-aperiodicity synthetic mixtures in
    tools/copy_synthesis_bench.py (d4c_accuracy section of
    vocoder_fidelity.json).  Unvoiced frames get aperiodicity 1 - 1e-12
    (pyworld convention)."""
    x = np.asarray(x, dtype=np.float64)
    if fft_size is None:
        fft_size = get_cheaptrick_fft_size(fs)
    n_bins = fft_size // 2 + 1
    T = len(f0)
    band_edges = _d4c_band_edges(fs)
    n_bands = len(band_edges) - 1
    freq_axis = np.arange(n_bins) * fs / fft_size

    # band-pass + analytic signal for the whole waveform once per band
    import scipy.signal

    band_re = np.empty((n_bands, len(x)))
    band_im = np.empty((n_bands, len(x)))
    for b in range(n_bands):
        lo, hi = band_edges[b], band_edges[b + 1]
        sos = scipy.signal.butter(
            4, [max(lo, 1.0), min(hi, fs / 2 - 1.0)], btype="band",
            fs=fs, output="sos")
        z = scipy.signal.hilbert(scipy.signal.sosfiltfilt(sos, x))
        band_re[b] = z.real
        band_im[b] = z.imag

    # Transition-aware sub-window placement (round 4, vuv_boundary class):
    # at voiced frames near a V/UV boundary the +-(n_sub-1)/2*T0 ensemble
    # (plus the +T0 correlation lag) straddles into the unvoiced neighbor,
    # the noise deflates the complex correlation, and the frame's
    # aperiodicity is biased HIGH — copy synthesis then renders boundary
    # frames too noisy (measured: boundary-class MCD 2.06 -> 1.88 dB with
    # this clamp; the voiced signal inside the segment is what the frame's
    # ap should describe).  Each frame's ensemble CENTER is shifted just
    # enough to keep every sub-window inside its own voiced segment.  The
    # shift is expressed as an adjusted temporal position c/fs with c an
    # exact integer sample, so the C++ twin (which recomputes
    # c = nearbyint(tpos * fs)) sees the identical center and stays
    # decision-exact with the NumPy oracle.
    tpos_eff = np.asarray(temporal_positions, np.float64).copy()
    for a, b in _voiced_segments(f0):
        s0 = int(round(temporal_positions[a] * fs))
        s1 = int(round(temporal_positions[b - 1] * fs))
        for i in range(a, b):
            T0 = fs / f0[i]
            lag0 = int(round(T0))
            srch = max(1, int(round(0.03 * T0)))
            subL = int(D4C_SUB_PERIODS * T0)
            span_l = (D4C_N_SUB - 1) / 2.0 * T0 + subL / 2.0
            lo, hi = s0 + span_l, s1 - (span_l + lag0 + srch)
            if lo <= hi:
                c = int(round(temporal_positions[i] * fs))
                tpos_eff[i] = float(int(np.clip(c, np.ceil(lo),
                                                np.floor(hi)))) / fs

    from gantts_tpu_torch.frontend import native

    if native.has_d4c_band_cplx():
        band_ap = native.d4c_band_cplx(band_re, band_im, f0,
                                       tpos_eff, fs,
                                       D4C_SUB_PERIODS, D4C_N_SUB)
    else:
        band_ap = _band_ap_subcplx_py(band_re, band_im, f0,
                                      tpos_eff, fs)

    # expand bands to the full frequency axis (log-linear interpolation)
    centers = (np.asarray(band_edges[:-1]) + np.asarray(band_edges[1:])) / 2
    ap_db = 20 * np.log10(band_ap)  # (T, n_bands)
    if n_bands == 1:
        full_db = np.broadcast_to(ap_db, (T, n_bins))
    else:
        j = np.clip(np.searchsorted(centers, freq_axis) - 1, 0, n_bands - 2)
        frac = (freq_axis - centers[j]) / (centers[j + 1] - centers[j])
        full_db = ap_db[:, j] + (ap_db[:, j + 1] - ap_db[:, j]) * frac
        full_db = np.where(freq_axis <= centers[0], ap_db[:, :1], full_db)
        full_db = np.where(freq_axis >= centers[-1], ap_db[:, -1:], full_db)
    return np.clip(10 ** (full_db / 20), 1e-12, 1.0 - 1e-12)


def _d4c_band_edges(fs):
    """3 kHz-spaced coarse bands up to fs/2 (>= 1 band)."""
    edges = [0.0]
    f = 3000.0
    while f < fs / 2 - 1500.0:
        edges.append(f)
        f += 3000.0
    edges.append(fs / 2)
    return edges


def num_coded_aperiodicities(fs):
    """pyworld convention: one coded band per 3 kHz above 3 kHz... for
    fs=16000 this is 1 (matches the reference bap stream size 3 = 1 static x
    3 windows, hparams.py:196)."""
    return max(1, int(min(15000.0, fs / 2.0 - 3000.0) / 3000.0))


def code_aperiodicity(aperiodicity, fs):
    """(T, n_bins) -> (T, num_coded) coarse aperiodicity in dB
    (prepare_features_tts.py:123 contract)."""
    n_coded = num_coded_aperiodicities(fs)
    n_bins = aperiodicity.shape[1]
    fft_size = (n_bins - 1) * 2
    coded = np.empty((aperiodicity.shape[0], n_coded))
    for k in range(n_coded):
        f = 3000.0 * (k + 1)
        bin_idx = int(round(f * fft_size / fs))
        bin_idx = min(bin_idx, n_bins - 1)
        coded[:, k] = 20 * np.log10(
            np.clip(aperiodicity[:, bin_idx], 1e-12, 1.0))
    return coded


def decode_aperiodicity(coded_aperiodicity, fs, fft_size):
    """(T, num_coded) dB -> (T, fft_size//2+1) ratio, linear interpolation in
    dB with 'almost periodic' 0 Hz anchor and Nyquist continuation
    (evaluation_tts.py:116 contract)."""
    coded = np.asarray(coded_aperiodicity, dtype=np.float64)
    T, n_coded = coded.shape
    n_bins = fft_size // 2 + 1
    freq_axis = np.arange(n_bins) * fs / fft_size
    anchors_f = np.r_[0.0, 3000.0 * (np.arange(n_coded) + 1), fs / 2.0]
    out = np.empty((T, n_bins))
    for i in range(T):
        anchors_db = np.r_[-60.0, coded[i], coded[i, -1]]
        db = np.interp(freq_axis, anchors_f, anchors_db)
        out[i] = np.clip(10 ** (db / 20.0), 1e-12, 1.0 - 1e-12)
    return out


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _min_phase_ir(power_spec, fft_size):
    """Minimum-phase impulse response from a one-sided power spectrum."""
    return np.fft.irfft(_min_phase_spectrum(power_spec, fft_size), fft_size)


def _min_phase_spectrum(power_spec, fft_size):
    """One-sided complex minimum-phase spectrum from a power spectrum."""
    logmag = 0.5 * np.log(np.maximum(power_spec, 1e-300))
    c = np.fft.irfft(logmag, fft_size)
    n = fft_size // 2
    c_min = c.copy()
    c_min[1:n] *= 2.0
    c_min[n + 1:] = 0.0
    return np.exp(np.fft.rfft(c_min, fft_size))


DEFAULT_UV_F0 = 500.0  # event spacing in unvoiced regions (WORLD convention)
PULSE_PRE_PAD = 64     # room for the fractional-shift pre-ring (samples)


def _synthesis_events(f0, fs, hop, N, default_f0=DEFAULT_UV_F0):
    """Excitation event table for WORLD-style synthesis.

    The timeline is tiled by excitation events: per-sample F0 is the linear
    interpolation of the frame contour (unvoiced frames filled with
    ``default_f0`` so unvoiced regions get events every fs/default_f0
    samples), the running phase crosses an integer at each event, and the
    crossing's sub-sample position is kept — integer-quantized pulse spacing
    reads as period jitter (inter-harmonic noise) after re-analysis.

    Returns (times, voiced, f_at) — float sample positions, voicing flags,
    per-event interpolated F0 — with a synthetic noise-only event at t=0 so
    the noise segments [floor(t_e), floor(t_{e+1})) tile [0, N) exactly.
    """
    T = len(f0)
    frame_t = np.arange(T) * hop
    voiced_fr = f0 > 0
    filled = np.where(voiced_fr, f0, default_f0)
    ts = np.arange(N, dtype=np.float64)
    f0_s = np.interp(ts, frame_t, filled)
    vuv_s = np.interp(ts, frame_t, voiced_fr.astype(np.float64)) > 0.5
    phase = np.cumsum(f0_s / fs)
    wraps = np.floor(phase)
    prev = np.r_[0.0, wraps[:-1]]
    cross = np.where(wraps > prev)[0]  # f0 < fs => at most one wrap/sample
    pp = np.r_[0.0, phase[:-1]]
    dp = phase[cross] - pp[cross]
    frac = (wraps[cross] - pp[cross]) / np.maximum(dp, 1e-12)
    # the integer crossing falls between samples cross-1 and cross
    times = np.maximum((cross - 1) + np.clip(frac, 0.0, 1.0), 0.0)
    voiced = vuv_s[cross]
    f_at = f0_s[cross]
    if len(times) == 0 or int(times[0]) > 0:
        times = np.r_[0.0, times]
        voiced = np.r_[False, voiced]
        f_at = np.r_[default_f0, f_at]
    return times, voiced.astype(bool), f_at


def synthesize(f0, spectrogram, aperiodicity, fs,
               frame_period=DEFAULT_FRAME_PERIOD):
    """WORLD-style synthesis: excitation events (voiced pulses at fractional
    sample instants / unvoiced noise markers) each rendering a periodic
    minimum-phase response plus a noise segment convolved with the
    aperiodic minimum-phase response.

    Consecutive noise segments tile the timeline (no windowed OLA, so the
    aperiodic component's power is exactly sp*ap^2 with no frame-rate
    modulation), spectra are linearly interpolated at the event time, and
    voiced pulses apply their sub-sample position as a linear phase term —
    the three properties that make the analysis->synthesis round trip
    consistent (cheaptrick(synthesize(sp)) ~= sp, measured in
    vocoder_fidelity.json).

    Contract of pyworld.synthesize (evaluation_vc.py:107,
    evaluation_tts.py:121): returns a float64 waveform of
    ~T*frame_period*fs/1000 samples."""
    f0 = np.asarray(f0, dtype=np.float64).reshape(-1)
    sp = np.asarray(spectrogram, dtype=np.float64)
    ap = np.asarray(aperiodicity, dtype=np.float64)
    T, n_bins = sp.shape
    fft_size = (n_bins - 1) * 2
    hop = fs * frame_period / 1000.0
    N = int(T * hop)

    times, voiced, f_at = _synthesis_events(f0, fs, hop, N)
    starts = np.floor(times).astype(np.int64)
    seg_ends = np.r_[starts[1:], N]
    nlens = np.maximum(seg_ends - starts, 0)
    noffs = np.r_[0, np.cumsum(nlens[:-1])]

    # one deterministic noise stream shared by the NumPy and C++ paths
    rs = np.random.RandomState(12345)
    noise = rs.randn(int(nlens.sum()))

    from gantts_tpu_torch.frontend import native

    # The C++ twin hardcodes kPrePad=64; if PULSE_PRE_PAD is ever tuned,
    # fall back to the oracle rather than silently rendering a different
    # pulse placement (same guard pattern as the cheaptrick constants).
    if (native.has_world_synth_events() and _is_pow2(fft_size)
            and PULSE_PRE_PAD == 64):
        return native.world_synth_events(
            sp, ap, times, voiced, f_at, noffs, nlens, noise, hop, fs, N)

    out = np.zeros(N + 2 * fft_size)

    if native.available():
        def _ola(ir, offset, gain):
            native.ola_add(out, ir, offset, gain)
    else:
        def _ola(ir, offset, gain):
            s = max(0, int(offset))
            e = min(len(out), int(offset) + len(ir))
            out[s:e] += gain * ir[s - int(offset): e - int(offset)]

    import scipy.signal

    k2 = np.arange(fft_size + 1)
    for e in range(len(times)):
        t = times[e]
        p = t / hop
        i0 = min(int(p), T - 1)
        i1 = min(i0 + 1, T - 1)
        w = min(max(p - i0, 0.0), 1.0)
        spe = (1.0 - w) * sp[i0] + w * sp[i1]
        ape = (1.0 - w) * ap[i0] + w * ap[i1]
        ap2 = ape * ape
        if voiced[e]:
            H = _min_phase_spectrum(spe * (1.0 - ap2), fft_size)
            ir = np.fft.irfft(H, fft_size)
            # Fractional positioning on a zero-padded 2x grid: the linear
            # phase is exact, and the sinc pre-ring of the sharp minimum-
            # phase onset lands in the PULSE_PRE_PAD samples before the
            # pulse instead of wrapping 1 fft_size later (a circular shift
            # on the unpadded buffer sprays the wrapped pre-ring as
            # broadband noise ~15 dB over the envelope's high band).
            frac = t - starts[e]
            buf = np.zeros(2 * fft_size)
            buf[:fft_size] = ir
            sh = np.fft.irfft(
                np.fft.rfft(buf) * np.exp(
                    -2j * np.pi * k2 * (PULSE_PRE_PAD + frac)
                    / (2 * fft_size)), 2 * fft_size)
            _ola(sh, starts[e] - PULSE_PRE_PAD, np.sqrt(fs / f_at[e]))
        L = int(nlens[e])
        if L > 0:
            h_ap = _min_phase_ir(spe * ap2, fft_size)
            seg = noise[noffs[e]: noffs[e] + L]
            shaped = scipy.signal.fftconvolve(seg, h_ap)
            _ola(shaped, starts[e], 1.0)

    return out[:N]
