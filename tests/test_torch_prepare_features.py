"""The port's feature command lines (``python -m
gantts_tpu_torch.prepare_features_tts`` and ``prepare_features_vc``) against
the repository's prepare_features_tts.py and prepare_features_vc.py, both
run in this process on the same corpora (tests/fixtures.py
``make_tts_corpus`` and ``make_arctic_vc_corpus``):

  * with both front ends on their NumPy versions (each package's
    ``native._load`` patched to give no library), where the two are the
    same code: every .npy equal bit for bit;
  * with each package's C++ engine (the same cpp/frontend.cpp, each built by
    its own loader): every .npy within 1e-9 of the file's scale.

The repository's commands fan out with ``multiprocessing.Pool``; here its
``map`` runs in this process (``_SerialPool``), so that the patched loaders
hold and nothing forks a process that holds JAX's threads, and they parse
their flags into copies of the JAX package's bundles (``_jax_bundles``),
which they would otherwise change for every later test in the process.  The
port's commands run in this process with one worker; their pool of spawned
processes (``--workers=2``) runs in a subprocess of its own, whose output
must equal the in-process run's bit for bit.
"""

import os
import subprocess
import sys
from os.path import dirname, join
from unittest import mock

import numpy as np
import pytest
from fixtures import make_arctic_vc_corpus, make_question_file, make_tts_corpus

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import prepare_features_tts as jax_prep_tts
import prepare_features_vc as jax_prep_vc
from gantts_tpu import hparams as jax_hparams
from gantts_tpu.frontend import native as jax_native
from gantts_tpu_torch import prepare_features_tts, prepare_features_vc
from gantts_tpu_torch.frontend import native

TTS_DIRS = ("X_duration", "Y_duration", "X_acoustic", "Y_acoustic")


class _SerialPool:
    """multiprocessing.Pool's surface that the repository's commands use,
    run in the calling process."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(item) for item in items]


@pytest.fixture(autouse=True)
def _jax_bundles(monkeypatch):
    for name in ("tts_acoustic", "tts_duration", "vc"):
        monkeypatch.setattr(jax_hparams, name,
                            getattr(jax_hparams, name).copy())


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    tts = make_tts_corpus(str(root / "tts"), num=3)
    vc = make_arctic_vc_corpus(str(root / "vc"), num=3)
    return tts, vc, make_question_file(str(root / "questions.hed"))


@pytest.fixture(params=["numpy", "native"])
def engine(request, monkeypatch):
    """Both front ends on their NumPy versions, or both on their C++
    engines.  The JAX loader builds cpp/build at first use, which pytest's
    workers may all try at once while collecting; a worker that lost that
    race cached "no library", so it looks once more."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        if not jax_native.available():
            monkeypatch.setattr(jax_native, "_tried", False)
        assert jax_native.available()
        assert native.available(), native.engine()
    return request.param


def _compare(port_dir, jax_dir, subdirs, engine):
    n = 0
    for sub in subdirs:
        names = sorted(os.listdir(join(jax_dir, sub)))
        assert names and sorted(os.listdir(join(port_dir, sub))) == names
        for name in names:
            got = np.load(join(port_dir, sub, name))
            ref = np.load(join(jax_dir, sub, name))
            assert got.dtype == ref.dtype == np.float32
            assert got.shape == ref.shape, (sub, name)
            if engine == "numpy":
                np.testing.assert_array_equal(got, ref, err_msg=name)
            else:
                scale = max(float(np.abs(ref).max()), 1e-30)
                assert np.abs(got - ref).max() <= 1e-9 * scale, (sub, name)
            n += 1
    return n


@pytest.mark.parametrize("variant", ["defaults", "dio", "questions"])
def test_prepare_features_tts_matches_jax(corpora, engine, variant,
                                          tmp_path):
    root, _, questions = corpora
    flags = ["--workers=1"]
    if variant == "dio":  # DIO and StoneMask, V/UV from the F0 track
        flags.append("--hparams_acoustic=use_harvest=False")
    elif variant == "questions":  # the fixture's 6 + 2 questions
        flags += [f"--question_path={questions}", "--max_files=2"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert prepare_features_tts.main([root, f"--dst_dir={port}"]
                                     + flags) == 0
    with mock.patch("multiprocessing.Pool", _SerialPool):
        assert jax_prep_tts.main([root, f"--dst_dir={ref}"] + flags) == 0
    n = _compare(port, ref, TTS_DIRS, engine)
    assert n == 4 * (2 if variant == "questions" else 3)
    x = np.load(join(port, "X_acoustic", "utt_0000.npy"))
    y = np.load(join(port, "Y_acoustic", "utt_0000.npy"))
    xd = np.load(join(port, "X_duration", "utt_0000.npy"))
    assert x.shape == (len(y), 17 if variant == "questions" else 425)
    assert xd.shape[1] == x.shape[1] - 9 and y.shape[1] == 187
    assert np.isfinite(y).all()


def test_prepare_features_tts_skips_and_overwrites(corpora, tmp_path,
                                                   capsys):
    """Existing outputs are kept unless --overwrite, as in the repository's
    command."""
    root, _, _ = corpora
    dst = str(tmp_path / "f")
    argv = [root, f"--dst_dir={dst}", "--max_files=1", "--workers=1"]
    assert prepare_features_tts.main(argv) == 0
    path = join(dst, "Y_acoustic", "utt_0000.npy")
    np.save(path, np.zeros((2, 2), np.float32))
    assert prepare_features_tts.main(argv) == 0
    assert np.load(path).shape == (2, 2)
    assert "found, skipping" in capsys.readouterr().out
    assert prepare_features_tts.main(argv + ["--overwrite"]) == 0
    assert np.load(path).shape[1] == 187


@pytest.mark.parametrize("max_files", [3, 2])
def test_prepare_features_vc_matches_jax(corpora, engine, max_files,
                                         tmp_path):
    _, root, _ = corpora
    flags = ["clb", "slt", f"--max_files={max_files}", "--workers=1"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert prepare_features_vc.main([root] + flags
                                    + [f"--dst_dir={port}"]) == 0
    with mock.patch("multiprocessing.Pool", _SerialPool):
        assert jax_prep_vc.main([root] + flags + [f"--dst_dir={ref}"]) == 0
    assert _compare(port, ref, ("X", "Y"), engine) == 2 * max_files
    x = np.load(join(port, "X", "arctic_a0000.npy"))
    y = np.load(join(port, "Y", "arctic_a0000.npy"))
    assert x.shape == y.shape and x.shape[1] == 177 and len(x) % 2 == 0
    # a second run finds the features and keeps them
    assert prepare_features_vc.main([root] + flags
                                    + [f"--dst_dir={port}"]) == 0


def test_collect_wav_files_matches_jax(corpora, tmp_path):
    _, root, _ = corpora
    for spk in ("clb", "slt"):
        assert prepare_features_vc.collect_wav_files(root, spk, 2) == \
            jax_prep_vc.collect_wav_files(root, spk, 2)
    for mod in (prepare_features_vc, jax_prep_vc):
        with pytest.raises(FileNotFoundError):
            mod.collect_wav_files(str(tmp_path), "bdl", 2)


@pytest.mark.parametrize("command", ["prepare_features_tts",
                                     "prepare_features_vc"])
def test_worker_processes_match_one_process(corpora, command, tmp_path):
    """``--workers=2``: the command's own process spawns two workers; the
    files equal those of one worker in this process, bit for bit."""
    tts_root, vc_root, _ = corpora
    args = ([tts_root] if command == "prepare_features_tts"
            else [vc_root, "clb", "slt", "--max_files=3"])
    subs = TTS_DIRS if command == "prepare_features_tts" else ("X", "Y")
    module = (prepare_features_tts if command == "prepare_features_tts"
              else prepare_features_vc)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert module.main(args + [f"--dst_dir={one}", "--workers=1"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", f"gantts_tpu_torch.{command}", *args,
         f"--dst_dir={two}", "--workers=2"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _compare(two, one, subs, "numpy") == 3 * len(subs)


def test_worker_processes_fail_fast_without_main_guard(corpora, tmp_path):
    """A script that calls ``main`` with workers at its top level, with no
    ``if __name__ == "__main__"`` guard, makes each spawned worker re-run
    it (``--overwrite``: the re-run does not skip): the command stops with
    an error instead of waiting forever."""
    _, root, _ = corpora
    script = tmp_path / "unguarded.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from gantts_tpu_torch.prepare_features_vc import main\n"
        f"main([{root!r}, 'clb', 'slt', '--max_files=1', '--workers=2', "
        f"'--overwrite', '--dst_dir={tmp_path / 'out'}'])\n")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "bootstrapping phase" in proc.stderr
