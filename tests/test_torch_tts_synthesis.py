"""The port's TTS synthesis (synthesis.py) and its evaluation command line
(``python -m gantts_tpu_torch.evaluation_tts``) against the JAX package's.

  * ``gen_parameters`` in both MLPG modes (unit variances on normalized
    features, true variances on denormalized ones): within 1e-10 of scale;
    ``gen_waveform`` with the post-filter on and off: within 1e-6 of the
    peak (both front ends on their NumPy versions, the same code);
  * ``gen_duration`` and ``tts_from_label``, with and without the duration
    model, on tiny bidirectional SRU generators whose weights are converted
    out of JAX ``init``, on labels of tests/fixtures.py ``make_tts_corpus``
    with the shipped question set.  The models agree to float32 rounding,
    so the limits are: each prediction before rounding within 2e-5 of its
    scale; durations equal, except by one frame where the JAX prediction
    lies within 1e-4 of a half-integer; V/UV decisions equal, except on
    frames with |vuv - 0.5| < 1e-4; the waveform within 1e-4 of its peak
    wherever durations and V/UV agree;
  * end to end on the CPU: features by the port's prepare_features_tts, one
    epoch of the port's training command line for a tiny duration and a
    tiny acoustic model, the same weights written as JAX checkpoints, then
    the port's evaluation command line and the repository's
    evaluation_tts.py on them: the same files, wavs within 1e-4 of the
    peak (1e-3 with ``--true-variance-mlpg``, see TRUE_VARIANCE_LIMIT),
    analysis.json within 1e-5.
"""

import json
import os
import sys
from os.path import dirname, join
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fixtures import make_tts_corpus
from scipy.io import wavfile

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

import evaluation_tts as jax_evaluation_tts
from gantts_tpu import hparams as jax_hparams
from gantts_tpu import synthesis as jax_synthesis
from gantts_tpu.frontend import native as jax_native
from gantts_tpu.io import hts as jax_hts
from gantts_tpu.models import create_model as jax_create
from gantts_tpu.train.checkpoint import save_checkpoint as jax_save
from gantts_tpu.train.step import TrainState
from gantts_tpu_torch import convert, hparams, synthesis
from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.frontend import native
from gantts_tpu_torch.io import hts, merlin
from gantts_tpu_torch.models import create_model

torch.set_num_threads(1)

PRED_LIMIT = 2e-5
HALF_EPS = 1e-4
VUV_EPS = 1e-4
WAVE_LIMIT = 1e-4
# MLPG with the training variances on denormalized features leaves WORLD
# synthesis more sensitive to the prediction: on this corpus the JAX
# package's own chain moved its waveform by 1.7e-5 of the peak when its
# prediction moved by one float32 ulp, and the two packages' predictions
# differ by up to 3 ulps (1.7e-4 of the peak seen); in MGE mode the same
# ulp moved it 2e-6.
TRUE_VARIANCE_LIMIT = 1e-3
TINY = dict(num_hidden=2, hidden_dim=16, bidirectional=True, dropout=0.0,
            use_relu=1, rnn_dropout=0.0, last_sigmoid=False)


@pytest.fixture(autouse=True)
def _jax_bundles(monkeypatch):
    """The repository's evaluation_tts.py parses its flags into the JAX
    package's bundles and sets their generator dims: give it copies, so
    that no later test in the process sees them changed."""
    for name in ("tts_acoustic", "tts_duration"):
        monkeypatch.setattr(jax_hparams, name,
                            getattr(jax_hparams, name).copy())


def _no_engines():
    return (mock.patch.object(jax_native, "_load", lambda: None),
            mock.patch.object(native, "_load", lambda: None))


def _stats(rs, hp):
    """Acoustic output stats with the scale of real ones: mgc around 0, lf0
    around log 150 Hz, vuv a voiced share, bap negative."""
    mgc, lf0, vuv, bap = hp.stream_sizes
    mean = np.r_[rs.randn(mgc) * 0.3, np.r_[5.0, 0, 0][:lf0], 0.6,
                 np.r_[-2.0, 0, 0][:bap]]
    std = np.r_[rs.rand(mgc) * 0.5 + 0.1, np.r_[0.3, 0.02, 0.02][:lf0],
                0.49, np.r_[0.8, 0.1, 0.1][:bap]]
    return mean, std


def _prediction(rs, T, hp):
    """A normalized acoustic prediction: smooth statics with their deltas
    (window math of the port) plus a little noise."""
    from gantts_tpu_torch.core.windows import delta_features

    mgc, lf0, vuv, bap = hp.stream_sizes
    K = len(hp.windows)
    parts = []
    for n in (mgc // K, lf0 // K):
        parts.append(delta_features(
            np.cumsum(rs.randn(T, n), axis=0) * 0.1, hp.windows))
    parts.append(np.sign(np.sin(np.arange(T) / 9.0))[:, None] * 0.8)
    parts.append(delta_features(
        np.cumsum(rs.randn(T, bap // K), axis=0) * 0.1, hp.windows))
    return np.hstack(parts) + 0.01 * rs.randn(T, sum(hp.stream_sizes))


@pytest.mark.parametrize("mge_training", [True, False])
def test_gen_parameters_matches_jax(mge_training):
    rs = np.random.RandomState(0)
    hp, jhp = hparams.tts_acoustic, jax_hparams.tts_acoustic
    mean, std = _stats(rs, hp)
    y = _prediction(rs, 150, hp)
    got = synthesis.gen_parameters(y, mean, std, hp, mge_training)
    ref = jax_synthesis.gen_parameters(y, mean, std, jhp, mge_training)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-10 * max(np.abs(r).max(), 1e-30)
    assert got[0].shape == (150, 60) and got[2].shape == (150,)


@pytest.mark.parametrize("post_filter", [False, True])
def test_gen_waveform_matches_jax(post_filter):
    rs = np.random.RandomState(1)
    hp, jhp = hparams.tts_acoustic, jax_hparams.tts_acoustic
    mean, std = _stats(rs, hp)
    y = _prediction(rs, 120, hp)
    a, b = _no_engines()
    with a, b:
        got = synthesis.gen_waveform(y, mean, std, hp,
                                     post_filter=post_filter)
        ref = jax_synthesis.gen_waveform(y, mean, std, jhp,
                                         post_filter=post_filter)
    peak = np.abs(ref[0]).max()
    assert got[0].shape == ref[0].shape == (120 * 80,)
    assert abs(np.abs(got[0]).max() - 32767) < 1e-6 * 32767
    assert np.abs(got[0] - ref[0]).max() <= 1e-6 * peak
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("add_noise", [False, True])
def test_generator_input_matches_jax(add_noise):
    x = np.random.RandomState(0).rand(30, 8).astype(np.float32)
    hp, jhp = hparams.tts_acoustic.copy(), jax_hparams.tts_acoustic
    hp.generator_add_noise = jhp.generator_add_noise = add_noise
    got = synthesis.generator_input(hp, x)
    ref = jax_synthesis.generator_input(jhp, x)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (30, 8 + 200 * add_noise)
    # a fresh RandomState(1234) on each call: the same noise twice
    np.testing.assert_array_equal(synthesis.generator_input(hp, x), got)


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tts"))
    make_tts_corpus(root, num=2)
    return [join(root, "label_state_align", f"utt_{i:04d}.lab")
            for i in range(2)]


def _tiny_models(in_dims, out_dims, acoustic_noise):
    """(JAX models, variables, port models, JAX and port bundles): tiny
    bidirectional SRU generators with the same weights, from JAX init."""
    jhp = {"duration": jax_hparams.tts_duration,
           "acoustic": jax_hparams.tts_acoustic}
    hp = {"duration": hparams.tts_duration.copy(),
          "acoustic": hparams.tts_acoustic.copy()}
    jms, variables, models = {}, {}, {}
    for seed, typ in enumerate(("duration", "acoustic")):
        noise = acoustic_noise and typ == "acoustic"
        D = in_dims[typ] + 200 * noise
        for h in (jhp[typ], hp[typ]):
            h.generator_add_noise = noise
            h.generator_params = dict(TINY, in_dim=D, out_dim=out_dims[typ])
        jms[typ] = jax_create("SRURNN", **jhp[typ].generator_params)
        variables[typ] = jms[typ].init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8, D), jnp.float32),
            jnp.asarray([8], jnp.int32))
        models[typ] = create_model("SRURNN", device="cpu",
                                   **hp[typ].generator_params)
        models[typ].load_state_dict(convert.flax_to_torch(variables[typ]),
                                    strict=True)
    return jms, variables, models, jhp, hp


def _recorders():
    """Record every forward of both packages: the port's model_forward and
    the JAX package's jitted forward, in call order."""
    port, ref = [], []
    real = synthesis.model_forward
    real_get = jax_synthesis.get_jitted_forward

    def port_forward(model, x, hp):
        out = real(model, x, hp)
        port.append(out.copy())
        return out

    def jax_get(*args, **kwargs):
        fwd = real_get(*args, **kwargs)

        def call(x):
            out = fwd(x)
            ref.append(np.asarray(out).copy())
            return out
        return call
    return (port, ref, mock.patch.object(synthesis, "model_forward",
                                         port_forward),
            mock.patch.object(jax_synthesis, "get_jitted_forward", jax_get))


def _half_integer_near(x):
    return np.abs(np.abs(x - np.floor(x)) - 0.5) < HALF_EPS


@pytest.mark.parametrize("case", ["durations", "label_timings", "noise"])
def test_tts_from_label_matches_jax(labels, case):
    """gen_duration and tts_from_label with the duration model, without it
    (the labels' own timings), and with noise appended to the acoustic
    model's input only (each model builds its input from its own bundle)."""
    rs = np.random.RandomState(2)
    qs = hts.load_question_set(hparams.tts_acoustic.question_path)
    jqs = jax_hts.load_question_set(hparams.tts_acoustic.question_path)
    lab = [hts.load(p) for p in labels]
    feats = {
        "duration": [merlin.linguistic_features(x, *qs) for x in lab],
        "acoustic": [merlin.linguistic_features(
            x, *qs, add_frame_features=True, subphone_features="full")
            for x in lab]}
    X_min = {k: np.min([f.min(0) for f in v], 0) for k, v in feats.items()}
    X_max = {k: np.max([f.max(0) for f in v], 0) for k, v in feats.items()}
    ac_mean, ac_std = _stats(rs, hparams.tts_acoustic)
    Y_mean = {"duration": np.full(5, 3.0), "acoustic": ac_mean}
    Y_std = {"duration": np.full(5, 1.5), "acoustic": ac_std}
    jms, variables, models, jhp, hp = _tiny_models(
        {"duration": 416, "acoustic": 425}, {"duration": 5, "acoustic": 187},
        acoustic_noise=case == "noise")
    apply_dur = case != "label_timings"

    port, ref, pa, pb = _recorders()
    a, b = _no_engines()
    compared = 0
    for path in labels:
        del port[:], ref[:]
        with a, b, pa, pb:
            if apply_dur:
                got_l = synthesis.gen_duration(
                    path, models["duration"], X_min["duration"],
                    X_max["duration"], Y_mean["duration"], Y_std["duration"],
                    hp["duration"], *qs)
                ref_l = jax_synthesis.gen_duration(
                    path, jms["duration"], variables["duration"],
                    X_min["duration"], X_max["duration"], Y_mean["duration"],
                    Y_std["duration"], jhp["duration"], *jqs)
            got = synthesis.tts_from_label(
                models, path, X_min, X_max, Y_mean, Y_std, hp["duration"],
                hp["acoustic"], *qs, apply_duration_model=apply_dur)
            want = jax_synthesis.tts_from_label(
                jms, variables, path, X_min, X_max, Y_mean, Y_std,
                jhp["duration"], jhp["acoustic"], *jqs,
                apply_duration_model=apply_dur)
        # forwards: (gen_duration's, then tts_from_label's own) of each
        assert len(port) == len(ref) == (3 if apply_dur else 1)
        for g, r in zip(port, ref):
            assert g.shape == r.shape
            assert np.abs(g - r).max() <= PRED_LIMIT * np.abs(r).max()
        if case == "noise":
            assert models["acoustic"].gru.l0_fwd.w.shape[0] == 625
        agree = True
        if apply_dur:
            dur_ref = P.inv_scale(ref[0].astype(np.float64),
                                  Y_mean["duration"], Y_std["duration"])
            got_f = np.array(got_l.frame_counts()).reshape(-1, 5)
            ref_f = np.array(ref_l.frame_counts()).reshape(-1, 5)
            assert got_l.contexts == ref_l.contexts
            off = got_f != ref_f
            assert (np.abs(got_f - ref_f) <= 1).all()
            assert _half_integer_near(dur_ref[off]).all()
            agree = not off.any()
            # the write-back: rounded, values <= 0 set to 1, a line a state
            want_f = np.round(dur_ref)
            want_f[want_f <= 0] = 1
            if agree:
                np.testing.assert_array_equal(got_f, want_f)
        if agree:
            vuv, vuv_ref = np.asarray(got[3]), np.asarray(want[3])
            flip = (vuv < 0.5) != (vuv_ref < 0.5)
            assert (np.abs(vuv_ref[flip] - 0.5) < VUV_EPS).all()
            if not flip.any():
                assert got[0].shape == want[0].shape
                assert np.abs(got[0] - want[0]).max() <= \
                    WAVE_LIMIT * np.abs(want[0]).max()
                compared += 1
    assert compared == len(labels)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A TTS corpus, its features by the port's command, and one epoch of
    the port's training command line for each tiny model."""
    from gantts_tpu_torch.prepare_features_tts import main as prep_main
    from gantts_tpu_torch.train.__main__ import main as train_main

    root = tmp_path_factory.mktemp("tts_cli")
    corpus = make_tts_corpus(str(root / "corpus"), num=7)
    feats = str(root / "feats")
    assert prep_main([corpus, f"--dst_dir={feats}", "--workers=1"]) == 0
    spec = (f"generator_params={dict(TINY, in_dim=None, out_dim=None)!r},"
            "discriminator_params={'in_dim': None, 'out_dim': 1, "
            "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.0, "
            "'last_sigmoid': True}")
    ckpts = {}
    for typ in ("duration", "acoustic"):
        ck = str(root / f"ck_{typ}")
        assert train_main([join(feats, f"X_{typ}"), join(feats, f"Y_{typ}"),
                           f"--hparams_name=tts_{typ}",
                           f"--hparams=nepoch=1,batch_size=2,{spec}",
                           "--w_d=0", f"--checkpoint-dir={ck}",
                           f"--log-event-path={ck}/log",
                           "--device", "cpu"]) == 0
        ckpts[typ] = join(ck, "checkpoint_epoch1_Generator.pth")
        state_dict = torch.load(ckpts[typ], weights_only=True)["state_dict"]
        jax_save(TrainState(params=convert.torch_to_flax(state_dict),
                            opt_state={}), 1, ck, "JAXGenerator")
    return corpus, feats, ckpts, spec


@pytest.mark.parametrize("flags", [["--post-filter"],
                                   ["--disable-duraton-gen"],
                                   ["--true-variance-mlpg", "--post-filter"]])
def test_evaluation_tts_matches_jax(trained, flags, tmp_path):
    from gantts_tpu_torch.evaluation_tts import main as eval_main

    corpus, feats, ckpts, spec = trained
    jax_ckpts = {k: v.replace("_Generator", "_JAXGenerator")
                 for k, v in ckpts.items()}
    hp_flags = [f"--hparams_acoustic={spec}", f"--hparams_duration={spec}",
                "--workers=2"] + flags
    labels = join(corpus, "label_state_align")
    out, out_ref = tmp_path / "port", tmp_path / "jax"
    assert eval_main([ckpts["acoustic"], ckpts["duration"], feats, labels,
                      str(out), "--device", "cpu"] + hp_flags) == 0
    assert jax_evaluation_tts.main([jax_ckpts["acoustic"],
                                    jax_ckpts["duration"], feats, labels,
                                    str(out_ref)] + hp_flags) == 0
    for sub, n in (("eval", 1), ("test", 5)):
        names = sorted(os.listdir(out_ref / sub))
        assert len(names) == n and sorted(os.listdir(out / sub)) == names
        for name in names:
            fs, y = wavfile.read(out / sub / name)
            _, y_ref = wavfile.read(out_ref / sub / name)
            assert fs == 16000 and y.dtype == np.int16
            assert y.shape == y_ref.shape and np.abs(y).max() > 30000
            diff = np.abs(y.astype(np.float64) - y_ref).max()
            limit = (TRUE_VARIANCE_LIMIT if "--true-variance-mlpg" in flags
                     else WAVE_LIMIT)
            assert diff <= limit * 32767 + 1  # and int16 truncation
    report = json.loads((out / "analysis.json").read_text())
    report_ref = json.loads((out_ref / "analysis.json").read_text())
    assert sorted(report) == sorted(report_ref)
    assert np.isfinite(report["gv_ratio"])
    for key, value in report_ref.items():
        got, want = np.asarray(report[key]), np.asarray(value)
        assert got.shape == want.shape, key
        # the modulation-spectrum curves are rounded to 1e-4 dB
        atol = 1e-4 if key.startswith("modspec_") else 0.0
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + atol
