"""ctypes bindings for the C++ host engine (cpp/frontend.cpp): the port's
own loader, counterpart of gantts_tpu/frontend/native.py, with the same ABI
gate and the same entry points.

The library is built on first use by ``g++`` directly, with the flags of
cpp/CMakeLists.txt (``FLAGS``), into ``gantts_tpu_torch/frontend/build/``;
a library older than its source is rebuilt.  The build and the first
``dlopen`` run under an exclusive ``fcntl`` lock on ``build/.lock`` (and a
thread lock within the process), so processes that start together (pytest
workers, evaluation workers) build once and all load the one library; it is
written under a temporary name and renamed.

When there is no compiler, the build fails or the library reports another
ABI, the front end runs its NumPy versions (``world.py`` and ``sptk.py``
dispatch on ``available()`` and the ``has_*`` checks), and the reason is
printed once on stderr.  ``engine()`` says which served.

Feature extraction and TTS synthesis reach two more entry points:
``dtw_path`` (``preprocessing/alignment.py``, the VC corpus's alignment) and
``banded_cholesky_solve`` (``core/windows.py``'s host MLPG), each with a
NumPy or scipy counterpart where there is no library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import threading
from os.path import abspath, dirname, exists, getmtime, join

import numpy as np

_HERE = dirname(abspath(__file__))
_SOURCE = join(dirname(dirname(_HERE)), "cpp", "frontend.cpp")
_BUILD_DIR = join(_HERE, "build")
_LIB_NAME = "libgantts_frontend.so"
FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-std=c++17", "-fPIC",
         "-shared")

# Expected ABI of the exported surface (cpp/frontend.cpp
# gantts_frontend_abi): a library reporting anything else is refused, since
# calling it through these prototypes would be undefined behaviour.
_ABI = 2

_lib = None
_engine = None
_lock = threading.Lock()


def _build(lib_path):
    """Compile cpp/frontend.cpp into ``lib_path``; None, or why it failed."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ failed to run: {e!r}"
    if proc.returncode != 0:
        if exists(tmp):
            os.remove(tmp)
        return (f"g++ exited {proc.returncode}: "
                f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, lib_path)
    return None


def _open(lib_path):
    """(library, None) or (None, why it was refused)."""
    try:
        lib = ctypes.CDLL(lib_path)
        lib.gantts_frontend_abi.restype = ctypes.c_longlong
        abi = int(lib.gantts_frontend_abi())
        if abi != _ABI:
            return None, f"{lib_path} has ABI {abi}, expected {_ABI}"
        _bind(lib)
    except (OSError, AttributeError) as e:
        return None, f"{lib_path} did not load: {e!r}"
    return lib, None


def _load_locked(build_dir):
    """Build if needed and open, under the build directory's file lock.
    Returns (library or None, the engine's description)."""
    lib_path = join(build_dir, _LIB_NAME)
    try:
        os.makedirs(build_dir, exist_ok=True)
        with open(join(build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when closed
            why = None
            if not exists(lib_path) or getmtime(lib_path) < getmtime(_SOURCE):
                why = _build(lib_path)
            lib = None
            if why is None:
                lib, why = _open(lib_path)
    except OSError as e:
        lib, why = None, f"cannot build in {build_dir}: {e!r}"
    if lib is None:
        print(f"gantts_tpu_torch.frontend.native: the C++ engine is not "
              f"available ({why}); the front end runs its NumPy versions",
              file=sys.stderr)
        return None, f"numpy ({why})"
    return lib, f"native ({lib_path})"


def _load():
    global _lib, _engine
    if _engine is None:
        with _lock:
            if _engine is None:
                _lib, _engine = _load_locked(_BUILD_DIR)
    return _lib


def engine():
    """Which engine serves the front end: "native (<library>)" or "numpy
    (<why not native>)"."""
    _load()
    return _engine


def _bind(lib):
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
    c_int32_p = ctypes.POINTER(ctypes.c_int32)
    i64, dbl, i32 = ctypes.c_int64, ctypes.c_double, ctypes.c_int
    signatures = {
        "dtw_path": ([c_double_p, i64, c_double_p, i64, i64, c_int32_p,
                      c_int32_p], i64),
        "banded_cholesky_solve": ([c_double_p, i64, i32, c_double_p, i64],
                                  i32),
        "mlsa_synthesis": ([c_double_p, i64, c_double_p, i64, i32, dbl, i32,
                            i32, c_double_p], None),
        "ola_add": ([c_double_p, i64, c_double_p, i64, i64, dbl], None),
        "world_synth_events": ([c_double_p, c_double_p, i64, i64, c_double_p,
                                c_uint8_p, c_double_p, c_int64_p, c_int64_p,
                                i64, c_double_p, i64, dbl, dbl, c_double_p,
                                i64], None),
        "ncc_refine": ([c_double_p, i64, c_double_p, c_double_p, i64, dbl,
                        c_double_p, c_double_p], None),
        "subharmonic_fix": ([c_double_p, i64, c_double_p, c_double_p, i64,
                             dbl, dbl, i32, dbl, c_double_p], None),
        "cheaptrick_frames": ([c_double_p, i64, c_double_p, c_double_p, i64,
                               dbl, dbl, dbl, i32, i32, c_double_p], None),
        "d4c_band_cplx": ([c_double_p, c_double_p, i64, i64, c_double_p,
                           c_double_p, i64, dbl, dbl, i32, c_double_p],
                          None),
        "coherence_gate": ([c_double_p, i64, c_double_p, c_double_p, i64,
                            dbl, dbl, dbl, dbl, c_double_p], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def available() -> bool:
    return _load() is not None


# The library is built from the checkout's own source, so it carries every
# entry point or none: each has_* check is available().  They stay only so
# that world.py and sptk.py remain line-for-line copies of the JAX
# package's modules, which probe older libraries entry by entry.
def has_world_synth_events() -> bool:
    return available()


def has_analysis() -> bool:
    """True if the WORLD analysis engine (ncc_refine &c) is loaded."""
    return available()


def has_coherence_gate() -> bool:
    return available()


def has_d4c_band_cplx() -> bool:
    return available()


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def mlsa_synthesis(excitation, b_frames, alpha, hopsize, pd=5):
    lib = _load()
    excitation = np.ascontiguousarray(excitation, dtype=np.float64)
    b_frames = np.ascontiguousarray(b_frames, dtype=np.float64)
    out = np.zeros_like(excitation)
    lib.mlsa_synthesis(
        _ptr(excitation), len(excitation), _ptr(b_frames),
        b_frames.shape[0], b_frames.shape[1] - 1,
        ctypes.c_double(alpha), int(hopsize), int(pd), _ptr(out))
    return out


def world_synth_events(sp, ap, times, voiced, f_at, noffs, nlens, noise,
                       hop, fs, n_out):
    """Event-based WORLD-style synthesis in C++ (cpp/frontend.cpp).

    The event table (pulse times incl. sub-sample position, voicing flags,
    per-event f0, noise segment offsets/lengths) and the noise stream are
    computed by the caller (world._synthesis_events) so the C++ and NumPy
    renderers consume identical inputs and agree to FFT rounding."""
    lib = _load()
    sp = np.ascontiguousarray(sp, dtype=np.float64)
    ap = np.ascontiguousarray(ap, dtype=np.float64)
    times = np.ascontiguousarray(times, dtype=np.float64)
    voiced = np.ascontiguousarray(voiced, dtype=np.uint8)
    f_at = np.ascontiguousarray(f_at, dtype=np.float64)
    noffs = np.ascontiguousarray(noffs, dtype=np.int64)
    nlens = np.ascontiguousarray(nlens, dtype=np.int64)
    noise = np.ascontiguousarray(noise, dtype=np.float64)
    T, n_bins = sp.shape
    fft_size = (n_bins - 1) * 2
    out = np.zeros(n_out + 2 * fft_size, dtype=np.float64)
    lib.world_synth_events(
        _ptr(sp), _ptr(ap), T, n_bins, _ptr(times),
        voiced.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _ptr(f_at),
        noffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nlens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(times), _ptr(noise), len(noise),
        ctypes.c_double(float(hop)), ctypes.c_double(float(fs)),
        _ptr(out), int(n_out))
    return out[:n_out]


def ncc_refine(x, f0, temporal_positions, fs):
    """C++ twin of world.py _ncc_refine; returns (refined, peak_r)."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    refined = f0.copy()
    peak_r = np.zeros_like(f0)
    lib.ncc_refine(_ptr(x), len(x), _ptr(f0), _ptr(tpos), len(f0),
                   ctypes.c_double(float(fs)), _ptr(refined), _ptr(peak_r))
    return refined, peak_r


def coherence_gate(x, f0, temporal_positions, fs, horizon_s, thresh, tol):
    """C++ twin of world.py _coherence_gate_py; returns the gated f0."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    out = f0.copy()
    lib.coherence_gate(_ptr(x), len(x), _ptr(f0), _ptr(tpos), len(f0),
                       ctypes.c_double(float(fs)),
                       ctypes.c_double(float(horizon_s)),
                       ctypes.c_double(float(thresh)),
                       ctypes.c_double(float(tol)), _ptr(out))
    return out


def subharmonic_fix(x, f0, temporal_positions, fs, f0_floor,
                    max_div=6, improvement=0.12):
    """C++ twin of world.py _subharmonic_fix; returns the corrected f0."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    out = f0.copy()
    lib.subharmonic_fix(_ptr(x), len(x), _ptr(f0), _ptr(tpos), len(f0),
                        ctypes.c_double(float(fs)),
                        ctypes.c_double(float(f0_floor)), int(max_div),
                        ctypes.c_double(float(improvement)), _ptr(out))
    return out


def cheaptrick_frames(x, f0, temporal_positions, fs, q1, f0_floor, fft_size,
                      uv_clamp=True):
    """C++ twin of world.py cheaptrick's frame loop; (T, fft//2+1) power."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    sp = np.empty((len(f0), fft_size // 2 + 1), dtype=np.float64)
    lib.cheaptrick_frames(_ptr(x), len(x), _ptr(f0), _ptr(tpos), len(f0),
                          ctypes.c_double(float(fs)),
                          ctypes.c_double(float(q1)),
                          ctypes.c_double(float(f0_floor)), int(fft_size),
                          int(bool(uv_clamp)), _ptr(sp))
    return sp


def d4c_band_cplx(band_re, band_im, f0, temporal_positions, fs,
                  sub_periods, n_sub):
    """C++ twin of world.py _band_ap_subcplx_py; (T, n_bands) band ap."""
    lib = _load()
    band_re = np.ascontiguousarray(band_re, dtype=np.float64)
    band_im = np.ascontiguousarray(band_im, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    n_bands, n = band_re.shape
    band_ap = np.full((len(f0), n_bands), 1.0 - 1e-12, dtype=np.float64)
    lib.d4c_band_cplx(_ptr(band_re), _ptr(band_im), n_bands, n, _ptr(f0),
                      _ptr(tpos), len(f0), ctypes.c_double(float(fs)),
                      ctypes.c_double(float(sub_periods)), int(n_sub),
                      _ptr(band_ap))
    return band_ap


def ola_add(out, ir, offset, gain=1.0):
    """In-place clipped scatter-add: out[offset:offset+len(ir)] += gain*ir."""
    lib = _load()
    assert out.dtype == np.float64 and out.flags.c_contiguous
    ir = np.ascontiguousarray(ir, dtype=np.float64)
    lib.ola_add(_ptr(out), len(out), _ptr(ir), len(ir),
                ctypes.c_int64(int(offset)), ctypes.c_double(float(gain)))


def dtw_path(x, y):
    """C++ twin of alignment._dtw_path_numpy: the exact DTW path between
    (Tx, D) and (Ty, D) as two int64 index arrays."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] \
            or not len(x) or not len(y):
        raise ValueError(f"dtw_path: shapes {x.shape} and {y.shape}, "
                         f"expected (Tx, D) and (Ty, D), Tx and Ty > 0")
    tx, ty = x.shape[0], y.shape[0]
    px = np.zeros(tx + ty, dtype=np.int32)
    py = np.zeros(tx + ty, dtype=np.int32)
    k = lib.dtw_path(_ptr(x), tx, _ptr(y), ty, x.shape[1],
                     px.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                     py.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return px[:k].astype(np.int64), py[:k].astype(np.int64)


def banded_cholesky_solve(ab, rhs, bandwidth):
    """Solve the banded SPD system given scipy upper-banded storage ``ab``;
    rhs (T, k) solved out-of-place."""
    lib = _load()
    ab = np.ascontiguousarray(ab, dtype=np.float64)
    out = np.ascontiguousarray(rhs, dtype=np.float64).copy()
    if out.ndim != 2 or ab.shape != (int(bandwidth) + 1, out.shape[0]):
        raise ValueError(f"banded_cholesky_solve: ab {ab.shape} and rhs "
                         f"{out.shape}, expected (bandwidth + 1, T) and "
                         f"(T, k)")
    r = lib.banded_cholesky_solve(_ptr(ab), out.shape[0], int(bandwidth),
                                  _ptr(out), out.shape[1])
    if r != 0:
        raise np.linalg.LinAlgError("banded matrix not SPD")
    return out
