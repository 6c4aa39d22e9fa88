"""The port's VC synthesis (synthesis.py) and its evaluation command line
(``python -m gantts_tpu_torch.evaluation_vc``) against the JAX package's.

  * ``apply_vc_model`` for both generator protocols, weights converted out
    of JAX ``init``: an In2Out generator at T = 60 (the exact dense R at the
    true length) and at T = 300 (the ``MLPGStencil`` operator on the input
    padded to 320, the true length passed), and a generic LSTMRNN padded to
    ``batch_bucket_multiple`` with its MLPG outside.  Limit 2e-5 absolute,
    tests/test_fast_mlpg.py's: the models agree to about 1e-6 in float32
    (tests/test_torch_vc_models.py) and the stencil adds about 1e-6.
  * ``vc_from_waveform`` with ``diffvc`` on and off, on a 0.6 s speech-like
    waveform (121 frames, so the stencil path), both front ends on their
    NumPy versions (each package's ``native._load`` patched to give no
    library), where they are the same code: the analysis features must be
    equal bit for bit, the predicted statics within 2e-5, and the waveform
    within 1e-4 of its peak (the MLSA filter or WORLD synthesis of statics
    that differ by rounding).
  * End to end on the CPU: the port's training command line
    (``--hparams_name=vc``, a tiny In2OutRNNHighwayNet) for one epoch on a
    parallel corpus of 16 utterances, then the evaluation command line,
    with and without ``--diffvc``, on wavs named after the corpus's eval
    and test files: int16 wavs, finite and not silent, and analysis.json.
"""

import json
import os
from os.path import exists, join
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fixtures import synth_speechlike
from scipy.io import wavfile

from gantts_tpu import hparams as jax_hparams
from gantts_tpu import synthesis as jax_synthesis
from gantts_tpu.frontend import native as jax_native
from gantts_tpu.models import create_model as jax_create
from gantts_tpu_torch import convert, hparams, synthesis
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.data import NPYDataSource
from gantts_tpu_torch.frontend import native
from gantts_tpu_torch.models import create_model

torch.set_num_threads(1)

LIMIT = 2e-5
FS, HOP = 16000, 80


def _hp(module, S, generator, **gen):
    hp = module.vc.copy()
    hp.order = S
    hp.stream_sizes = [3 * S]
    hp.generator = generator
    hp.generator_params = dict(in_dim=3 * S, out_dim=3 * S, dropout=0.0,
                               **gen)
    return hp


GENERATORS = {
    "In2OutHighwayNet": dict(static_dim=8, num_hidden=2, hidden_dim=16),
    "In2OutRNNHighwayNet": dict(static_dim=8, num_hidden=2, hidden_dim=16),
    "LSTMRNN": dict(num_hidden=1, hidden_dim=16, bidirectional=True),
}


def _models(generator, S=8, seed=0, **gen):
    """(JAX model, variables, port model) with the same weights."""
    gen = dict(GENERATORS[generator], **gen)
    jhp = _hp(jax_hparams, S, generator, **gen)
    hp = _hp(hparams, S, generator, **gen)
    jm = jax_create(generator, **jhp.generator_params)
    x = jnp.zeros((1, 8, 3 * S), jnp.float32)
    lengths = jnp.asarray([8], jnp.int32)
    if generator.startswith("In2Out"):
        R = unit_variance_mlpg_matrix(jhp.windows, 8)
        variables = jm.init(jax.random.PRNGKey(seed), x, jnp.asarray(R),
                            lengths)
    else:
        variables = jm.init(jax.random.PRNGKey(seed), x, lengths)
    model = create_model(generator, device="cpu", **hp.generator_params)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return jm, variables, model, jhp, hp


@pytest.mark.parametrize("T", [60, 300])
@pytest.mark.parametrize("generator", list(GENERATORS))
def test_apply_vc_model_matches_jax(generator, T):
    jm, variables, model, jhp, hp = _models(generator)
    x = np.random.RandomState(T).randn(T, 24).astype(np.float32)
    ref = jax_synthesis.apply_vc_model(jm, variables, x, jhp)
    created = []
    real = synthesis.MLPGStencil.create
    with mock.patch.object(synthesis.MLPGStencil, "create",
                           lambda *a, **k: created.append(1) or real(*a, **k)):
        got = synthesis.apply_vc_model(model, x, hp)
    assert got.shape == ref.shape == (T, 8)
    assert np.abs(got - np.asarray(ref)).max() < LIMIT
    # the stencil serves an In2Out model from 98 frames, the dense R below
    assert bool(created) == (generator.startswith("In2Out") and T >= 98)
    assert not model.training


def _no_engines():
    return (mock.patch.object(jax_native, "_load", lambda: None),
            mock.patch.object(native, "_load", lambda: None))


PLAN = [("pau", 15), ("s", 10), ("aa", 35), ("l", 15), ("iy", 30),
        ("t", 15)]  # 120 frames: 0.6 s


@pytest.mark.parametrize("diffvc", [True, False])
def test_vc_from_waveform_matches_jax(diffvc):
    S = 24
    jm, variables, model, jhp, hp = _models("In2OutRNNHighwayNet", S=S,
                                            static_dim=S)
    x = synth_speechlike(PLAN, FS, HOP, np.random.RandomState(0), 120.0)
    x = x / np.abs(x).max() * 2 ** 14
    rs = np.random.RandomState(1)
    mean, std = rs.randn(3 * S) * 0.1, rs.rand(3 * S) + 0.5
    a, b = _no_engines()
    with a, b:
        wav_ref, in_ref, out_ref = jax_synthesis.vc_from_waveform(
            jm, variables, x, FS, mean, std, jhp, diffvc=diffvc)
        wav, inputs, outputs = synthesis.vc_from_waveform(
            model, x, FS, mean, std, hp, diffvc=diffvc)
    assert inputs.shape == (121, S)  # the stencil path: T >= 98
    np.testing.assert_array_equal(inputs, in_ref)
    assert np.abs(outputs - out_ref).max() < LIMIT
    assert wav.shape == wav_ref.shape and np.isfinite(wav).all()
    peak = np.abs(wav_ref).max()
    assert peak > 0 and np.abs(wav - wav_ref).max() < 1e-4 * peak


def _vc_corpus(root, S, num=16):
    """A parallel corpus from speech-like waveforms: X from the port's own
    analysis of each wav (static mel-cepstra, smoothed, with deltas), Y a
    fixed warp of X; the wavs go to ``root/wav`` under the files' names."""
    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.core.windows import delta_features
    from gantts_tpu_torch.frontend import sptk, world

    rs = np.random.RandomState(3)
    for d in ("data/X", "data/Y", "wav"):
        os.makedirs(join(root, d), exist_ok=True)
    for i in range(num):
        n = rs.randint(40, 140)
        plan = [("aa", n // 3), ("s", n // 4), ("iy", n - n // 3 - n // 4)]
        x = synth_speechlike(plan, FS, HOP, rs, 100.0 + 10 * i)
        x = (x / np.abs(x).max() * 2 ** 14).astype(np.int16)
        name = f"utt_{i:04d}"
        wavfile.write(join(root, "wav", name + ".wav"), FS, x)
        xd = x.astype(np.float64)
        f0, tp = world.dio(xd, FS, frame_period=5)
        f0 = world.stonemask(xd, f0, tp, FS)
        sp = world.cheaptrick(xd, f0, tp, FS)
        mc = sptk.sp2mc(sp, order=S, alpha=sptk.mcepalpha(FS))[:, 1:]
        mc = P.modspec_smoothing(mc, 200.0, cutoff=50)
        src = delta_features(mc, hparams.vc.windows)
        np.save(join(root, "data/X", name + ".npy"), src.astype(np.float32))
        np.save(join(root, "data/Y", name + ".npy"),
                (0.9 * src + 0.05).astype(np.float32))


def test_train_and_evaluate_vc_on_cpu(tmp_path):
    from gantts_tpu_torch.evaluation_vc import main as eval_main
    from gantts_tpu_torch.train.__main__ import main as train_main

    S = 12
    _vc_corpus(str(tmp_path), S)
    data = tmp_path / "data"
    gen = dict(in_dim=None, out_dim=None, num_hidden=1, hidden_dim=16,
               static_dim=S, dropout=0.5)
    disc = dict(in_dim=S, out_dim=1, num_hidden=1, hidden_dim=8, dropout=0.5,
                last_sigmoid=True)
    spec = (f"order={S},stream_sizes=[{3 * S}],generator=In2OutRNNHighwayNet,"
            f"generator_params={gen!r},discriminator_params={disc!r}")
    ck = tmp_path / "ck"
    assert train_main([str(data / "X"), str(data / "Y"), "--hparams_name=vc",
                       f"--hparams=nepoch=1,batch_size=4,{spec}",
                       f"--checkpoint-dir={ck}",
                       f"--log-event-path={ck}/log", "--w_d=1",
                       "--device", "cpu"]) == 0
    ckpt = ck / "checkpoint_epoch1_Generator.pth"
    assert exists(ckpt)
    assert exists(data / "data_mean.npy") and exists(data / "data_var.npy")

    names = {sub: [os.path.basename(f)[:-4] for f in NPYDataSource(
        str(data / "X"), train=False, test=sub == "test").collect_files()]
        for sub in ("eval", "test")}
    assert len(names["test"]) == 5 and names["eval"]
    for diffvc, out in ((True, tmp_path / "out"),
                        (False, tmp_path / "out_world")):
        argv = [str(ckpt), str(data), str(tmp_path / "wav"), str(out),
                f"--hparams={spec}", "--device", "cpu"]
        assert eval_main(argv + ["--diffvc"] * diffvc) == 0
        for sub, files in names.items():
            assert sorted(os.listdir(out / sub)) == sorted(
                n + ".wav" for n in files)
            for n in files:
                fs, y = wavfile.read(out / sub / (n + ".wav"))
                _, src = wavfile.read(tmp_path / "wav" / (n + ".wav"))
                assert fs == FS and y.dtype == np.int16
                # MLSA filters the source itself; WORLD renders whole frames
                assert (len(y) == len(src) if diffvc
                        else abs(len(y) - len(src)) <= HOP)
                assert np.abs(y).max() > 100
        report = json.loads((out / "analysis.json").read_text())
        assert np.isfinite(report["gv_ratio"]) and report["gv_ratio"] > 0
        assert len(report["gv_generated"]) == S
