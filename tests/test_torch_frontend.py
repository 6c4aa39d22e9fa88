"""The port's host front end (frontend/world.py, sptk.py, native.py,
utils/analysis.py, preprocessing.modspec_smoothing) against the JAX
package's modules, on a one-second speech-like waveform from
tests/fixtures.py.

  * NumPy against NumPy: both packages with their C++ engines switched off
    (each ``native._load`` patched to give no library) run the same NumPy
    code, so every result must be equal bit for bit.
  * The port's C++ engine against its own NumPy versions, at
    tests/test_frontend.py's tolerances.  The engine is built inside the
    test, under the loader's file lock, not while pytest collects.
  * Two processes that load the engine at once, into an empty build
    directory, both get it.
"""

import json
import os
import subprocess
import sys
from os.path import dirname, exists, join
from unittest import mock

import numpy as np
import pytest
from fixtures import synth_speechlike

from gantts_tpu import preprocessing as JP
from gantts_tpu.frontend import native as jax_native
from gantts_tpu.frontend import sptk as jax_sptk
from gantts_tpu.frontend import world as jax_world
from gantts_tpu.utils import analysis as jax_analysis
from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.frontend import native, sptk, world
from gantts_tpu_torch.utils import analysis

REPO = dirname(dirname(os.path.abspath(__file__)))
FS, HOP = 16000, 80
PLAN = [("pau", 20), ("s", 15), ("aa", 45), ("l", 20), ("iy", 50),
        ("t", 15), ("ow", 35)]  # 200 frames: one second


def _wave():
    return synth_speechlike(PLAN, FS, HOP, np.random.RandomState(0), 130.0)


def _no_engines():
    return (mock.patch.object(jax_native, "_load", lambda: None),
            mock.patch.object(native, "_load", lambda: None))


def _analyze(w, s, x):
    f0, tp = w.dio(x, FS, frame_period=5)
    f0 = w.stonemask(x, f0, tp, FS)
    sp = w.cheaptrick(x, f0, tp, FS)
    ap = w.d4c(x, f0, tp, FS)
    alpha = s.mcepalpha(FS)
    mc = s.sp2mc(sp, order=24, alpha=alpha)
    return dict(f0=f0, tp=tp, sp=sp, ap=ap, mc=mc,
                sp2=s.mc2sp(mc, alpha=alpha,
                            fftlen=w.get_cheaptrick_fft_size(FS)),
                b=s.mc2b(mc, alpha=alpha),
                y=w.synthesize(f0, sp, ap, FS, 5))


def test_numpy_front_end_matches_jax_bit_for_bit():
    x = _wave()
    a, b = _no_engines()
    with a, b:
        assert not native.available() and not jax_native.available()
        ref = _analyze(jax_world, jax_sptk, x)
        got = _analyze(world, sptk, x)
        # the per-sample MLSA loop, on a quarter of a second
        n = FS // 4
        y_ref = jax_sptk.mlsa_synthesis(x[:n], ref["b"][:50], 0.42, HOP)
        y_got = sptk.mlsa_synthesis(x[:n], got["b"][:50], 0.42, HOP)
    assert (ref["f0"] > 0).mean() > 0.3  # the fixture is mostly voiced
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(y_got, y_ref)
    assert sptk.mcepalpha(FS) == jax_sptk.mcepalpha(FS)
    assert world.get_cheaptrick_fft_size(FS) == \
        jax_world.get_cheaptrick_fft_size(FS)


def test_modspec_smoothing_and_analysis_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    mc = rs.randn(230, 6).cumsum(0)
    for cutoff in (50, 150):
        np.testing.assert_array_equal(
            P.modspec_smoothing(mc, 200.0, cutoff=cutoff),
            JP.modspec_smoothing(mc, 200.0, cutoff=cutoff))
    np.testing.assert_array_equal(P.modspec(mc), JP.modspec(mc))
    feats = [rs.randn(n, 6) for n in (90, 130)]
    np.testing.assert_array_equal(analysis.global_variance(feats),
                                  jax_analysis.global_variance(feats))
    for f, r in zip(analysis.modulation_spectrum(feats, 200.0),
                    jax_analysis.modulation_spectrum(feats, 200.0)):
        np.testing.assert_array_equal(f, r)
    nat = tmp_path / "Y"
    nat.mkdir()
    for i, f in enumerate(feats):
        np.save(nat / f"u{i}.npy", f.astype(np.float32) + 1)
    reports = []
    for mod in (analysis, jax_analysis):
        path = tmp_path / f"{mod.__name__}.json"
        mod.write_analysis_report(str(path), feats, str(nat), 4, 200.0)
        reports.append(json.loads(path.read_text()))
    assert reports[0] == reports[1] and "gv_ratio" in reports[0]
    assert analysis.run_utterance_jobs(lambda a, b: a + b,
                                       [(1, 2), (3, 4)], 2) == [3, 7]


def _fixture():
    """tests/test_frontend.py's analysis fixture: a vibrato harmonic signal
    with a silent head and a known contour."""
    rs = np.random.RandomState(7)
    dur = 0.6
    t = np.arange(int(FS * dur)) / FS
    f0c = 140 + 20 * np.sin(2 * np.pi * 2.0 * t)
    ph = 2 * np.pi * np.cumsum(f0c) / FS
    x = np.sin(ph) + 0.5 * np.sin(2 * ph) + 0.3 * np.sin(3 * ph)
    x[: int(0.1 * FS)] = 0.0
    x += 0.02 * rs.randn(len(x))
    tp = np.arange(int(len(x) / FS / 0.005) + 1) * 0.005
    f0 = np.where((tp > 0.15) & (tp < dur - 0.1),
                  140 + 20 * np.sin(2 * np.pi * 2.0 * tp), 0.0)
    return x, f0, tp


def test_native_engine_matches_its_numpy_versions(monkeypatch):
    """Built here, under the lock; then each C++ twin against the port's
    NumPy version, at tests/test_frontend.py's limits."""
    assert native.available(), native.engine()
    assert native.engine().startswith("native")
    x, f0, tp = _fixture()
    r_cc, p_cc = native.ncc_refine(x, f0, tp, FS)
    r_py, p_py = world._ncc_refine_py(x, f0, tp, FS)
    np.testing.assert_allclose(r_cc, r_py, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(p_cc, p_py, rtol=1e-9, atol=1e-9)
    f0_bad = np.where(f0 > 0, f0 * 2.0, 0.0)
    np.testing.assert_allclose(
        native.subharmonic_fix(x, f0_bad, tp, FS, 71.0),
        world._subharmonic_fix_py(x, f0_bad, tp, FS, 71.0),
        rtol=1e-9, atol=1e-9)
    f0_mixed = f0.copy()
    f0_mixed[f0 == 0] = np.random.RandomState(7).uniform(
        650, 780, (f0 == 0).sum())
    g_cc = native.coherence_gate(x, f0_mixed, tp, FS, 0.012, 0.5, 0.08)
    np.testing.assert_allclose(
        g_cc, world._coherence_gate_py(x, f0_mixed, tp, FS),
        rtol=1e-9, atol=1e-9)
    assert (g_cc == 0).any()

    w = _wave()
    cc = _analyze(world, sptk, w)
    b = cc["b"][:50]
    mlsa_cc = sptk.mlsa_synthesis(w[:FS // 4], b, 0.42, HOP)
    for name in ("has_analysis", "has_coherence_gate", "has_d4c_band_cplx",
                 "has_world_synth_events", "available"):
        monkeypatch.setattr(native, name, lambda: False)
    py = _analyze(world, sptk, w)
    mlsa_py = sptk.mlsa_synthesis(w[:FS // 4], b, 0.42, HOP)
    assert np.abs(mlsa_cc - mlsa_py).max() < 1e-10
    both = (cc["f0"] > 0) & (py["f0"] > 0)
    assert both.mean() > 0.3
    assert ((cc["f0"] > 0) != (py["f0"] > 0)).mean() < 0.02
    np.testing.assert_allclose(cc["f0"][both], py["f0"][both], rtol=1e-6)
    # the envelope and aperiodicity on one contour, as test_frontend.py
    f0, tpw = py["f0"], py["tp"]
    sp_py = world.cheaptrick(w, f0, tpw, FS)
    ap_py = world.d4c(w, f0, tpw, FS)
    y_py = world.synthesize(f0, sp_py, ap_py, FS, 5)
    monkeypatch.undo()
    np.testing.assert_allclose(world.cheaptrick(w, f0, tpw, FS), sp_py,
                               rtol=1e-7)
    np.testing.assert_allclose(world.d4c(w, f0, tpw, FS), ap_py, rtol=1e-7,
                               atol=1e-9)
    y_cc = world.synthesize(f0, sp_py, ap_py, FS, 5)
    assert np.abs(y_cc - y_py).max() < 1e-6 * np.abs(y_py).max()


_LOADER = (
    "import sys\n"
    "from gantts_tpu_torch.frontend import native\n"
    "native._BUILD_DIR = sys.argv[1]\n"
    "print(native.available(), native.engine())\n")


def test_two_processes_load_the_engine_at_once(tmp_path):
    """Two interpreters started together on an empty build directory: one
    builds under the lock, the other waits for it; both load the library,
    and no temporary file is left."""
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, build],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    lib = join(build, "libgantts_frontend.so")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == f"True native ({lib})", (out, err)
    assert exists(lib)
    assert sorted(os.listdir(build)) == [".lock", "libgantts_frontend.so"]


def test_engine_falls_back_to_numpy_without_a_compiler(tmp_path, capsys):
    """No g++: the loader says why once on stderr and serves NumPy."""
    with mock.patch.object(native, "_BUILD_DIR", str(tmp_path / "b")), \
            mock.patch.object(native, "_lib", None), \
            mock.patch.object(native, "_engine", None), \
            mock.patch.object(native.shutil, "which", lambda _: None):
        assert not native.available()
        assert native.engine() == "numpy (no g++ on PATH)"
        assert not native.has_analysis()
    err = capsys.readouterr().err
    assert err.count("no g++ on PATH") == 1 and "NumPy" in err
