"""The port's training entry point against the JAX package's: its own copies
of the host code (hparams bundles, window math, preprocessing, the data
pipeline), setup, SGD, checkpoints, the epoch loop and the command line.

Host code is NumPy on both sides and must agree exactly (window and MLPG
matrices to atol 1e-6: the JAX package solves with its C++ banded solver
where that is built, the port with scipy).  The train/test split must equal
sklearn's file for file.  The epoch loop runs two epochs of a small
tts_acoustic configuration (a 2x16 unidirectional SRU, dropout off) in both
packages from converted initial weights, with torch's Adagrad rule on the
JAX side (see tests/test_torch_step.py); every logged loss, metric and count
series agrees to rtol 1e-4 (four Adagrad steps, each of which carries the
summation-order differences of test_torch_step.py's rtol 1e-5 forward).
"""

import json
import math
import os
import subprocess
import sys
from os.path import dirname, exists, join

import jax
import numpy as np
import pytest
import torch

from gantts_tpu import hparams as jax_hparams
from gantts_tpu import preprocessing as jax_pre
from gantts_tpu.core import streams as jax_streams
from gantts_tpu.core import windows as jax_windows
from gantts_tpu.data import BatchIterator as JaxBatchIterator
from gantts_tpu.data import NPYDataSource as JaxNPYDataSource
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train import loop as jax_loop
from gantts_tpu.train import optim as jax_optim
from gantts_tpu.train import setup as jax_setup
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, data, hparams, preprocessing
from gantts_tpu_torch.core import streams, windows
from gantts_tpu_torch.train import GanTrainer, StepConfig, setup
from gantts_tpu_torch.train.checkpoint import load_checkpoint, restore
from gantts_tpu_torch.train.checkpoint import save_checkpoint
from gantts_tpu_torch.train.loop import train_loop
from gantts_tpu_torch.train.optim import create_optimizer

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

BUNDLES = ("vc", "tts_duration", "tts_acoustic")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """chip_smoke.py's synthetic acoustic corpus (the layout of
    tests/make_synthetic_data.py, written by the port's own code, every
    frame voiced so that the F0 error is defined) cut to 30 linguistic
    dims, stream sizes [60, 3, 1, 3] and 14 utterances of 80-220 frames."""
    import chip_smoke

    d = str(tmp_path_factory.mktemp("acoustic"))
    chip_smoke.write_acoustic_corpus(d, num=14, lin_dim=30, mgc_dim=20,
                                     frames=(80, 221))
    return d


def _values_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_values_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_values_equal(a[k], b[k])
                                            for k in a)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", BUNDLES)
def test_hparams_bundle_matches_jax(name):
    """Every field of every bundle, and the same overrides parsed alike.
    question_path points at the same file from the other package's
    directory."""
    ours, ref = getattr(hparams, name).values(), \
        getattr(jax_hparams, name).values()
    assert ours.keys() == ref.keys()
    for k in ours:
        if k == "question_path":
            assert os.path.realpath(ours[k]) == os.path.realpath(ref[k])
        else:
            assert _values_equal(ours[k], ref[k]), k
    spec = ("batch_size=7,nepoch=3,pin_memory=False,compute_dtype=bfloat16,"
            "windows=[(0, 0, [1.0])],generator_params={'num_hidden': 2}")
    a = getattr(hparams, name).copy().parse(spec).values()
    b = getattr(jax_hparams, name).copy().parse(spec).values()
    assert all(_values_equal(a[k], b[k]) for k in a if k != "question_path")
    assert getattr(hparams, name).batch_size != 7  # copies
    assert (hparams.hparams_debug_string(getattr(hparams, name)).splitlines()
            [0] == "Hyperparameters:")
    for bad in ("nope=1", "batch_size", "stream_sizes=[1,", "use_harvest=2"):
        with pytest.raises(ValueError):
            getattr(jax_hparams, name).copy().parse(bad)
        with pytest.raises(ValueError):
            getattr(hparams, name).copy().parse(bad)


def test_windows_match_jax():
    W = hparams.tts_acoustic.windows
    for T in (1, 2, 7, 64):
        for a, b in zip(windows.build_win_mats(W, T),
                        jax_windows.build_win_mats(W, T)):
            assert np.array_equal(a, b)
        assert np.array_equal(windows._banded_precision(W, T),
                              jax_windows._banded_precision(W, T))
        np.testing.assert_allclose(windows.unit_variance_mlpg_matrix(W, T),
                                   jax_windows.unit_variance_mlpg_matrix(W, T),
                                   atol=1e-6)
    s = np.random.RandomState(0).randn(33, 5)
    for w in (W, W[:1], W[:2]):
        assert np.array_equal(windows.delta_features(s, w),
                              jax_windows.delta_features(s, w))
    assert np.array_equal(
        streams.recompute_delta_features(
            np.random.RandomState(1).randn(20, 187), W),
        jax_streams.recompute_delta_features(
            np.random.RandomState(1).randn(20, 187), W))
    with pytest.raises(ValueError, match="Malformed"):
        windows.delta_features(s, [(1, 1, np.array([1.0]))])


def test_preprocessing_matches_jax():
    rs = np.random.RandomState(2)
    X = [rs.randn(rs.randint(3, 30), 6).astype(np.float32) * 3 + 1
         for _ in range(7)]
    X[2][:, 4] = 5.0  # a constant dimension
    lengths = [len(x) - 1 for x in X]
    for fn, args in ((preprocessing.meanvar, (X,)),
                     (preprocessing.meanvar, (X, lengths)),
                     (preprocessing.minmax, (X,)),
                     (preprocessing.minmax, (X, lengths))):
        ref = getattr(jax_pre, fn.__name__)(*args)
        for a, b in zip(fn(*args), ref):
            assert np.array_equal(a, b), fn.__name__
    m, v, n = preprocessing.meanvar(X, lengths, return_last_sample_count=True)
    pooled = preprocessing.meanvar(X[:3], mean_=m, var_=v,
                                   last_sample_count=n)
    ref = jax_pre.meanvar(X[:3], mean_=m, var_=v, last_sample_count=n)
    assert all(np.array_equal(a, b) for a, b in zip(pooled, ref))
    lo, hi = preprocessing.minmax(X)
    assert all(np.array_equal(a, b) for a, b in zip(
        preprocessing.minmax_scale_params(lo, hi, (0.01, 0.99)),
        jax_pre.minmax_scale_params(lo, hi, (0.01, 0.99))))
    x = X[0]
    mean, var = preprocessing.meanvar(X)
    std = np.sqrt(var)
    std[1] = 0.0
    for fn, args in (("scale", (x, mean, std)), ("inv_scale", (x, mean, std)),
                     ("minmax_scale", (x, lo, hi, (0.01, 0.99)))):
        assert np.array_equal(getattr(preprocessing, fn)(*args),
                              getattr(jax_pre, fn)(*args)), fn


@pytest.mark.parametrize("n", [2, 9, 10, 17, 40, 103, 1132])
def test_split_matches_sklearn(n):
    """train_test_split(test_size=0.112, random_state=1234), file for file
    and in order, without sklearn."""
    from sklearn.model_selection import train_test_split

    files = [f"utt_{i:05d}.npy" for i in range(n)]
    ref_train, ref_test = train_test_split(files, test_size=0.112,
                                           random_state=1234)
    train, test = data.split_files(files)
    assert train == ref_train and test == ref_test
    assert len(test) == math.ceil(0.112 * n)


def test_split_refuses_an_empty_train_set_as_sklearn_does():
    from sklearn.model_selection import train_test_split

    with pytest.raises(ValueError):
        train_test_split(["a.npy"], test_size=0.112, random_state=1234)
    with pytest.raises(ValueError, match="empty"):
        data.split_files(["a.npy"])


def test_data_source_and_batches_match_jax(corpus):
    """The split of a corpus directory, and three epochs of bucketed
    batches (shuffle order, padding, lengths, normalized values), with and
    without the prefetching thread pool, whose look-ahead crosses each
    epoch's end."""
    xdir, ydir = join(corpus, "X_acoustic"), join(corpus, "Y_acoustic")
    for kw in (dict(train=True), dict(train=False), dict(test=True),
               dict(train=True, max_files=6)):
        assert (data.NPYDataSource(xdir, **kw).collect_files()
                == JaxNPYDataSource(xdir, **kw).collect_files())
    X, Y, lens = setup.load_arrays(xdir, ydir)
    jX, jY, jlens = jax_setup.load_arrays(xdir, ydir)
    assert all(np.array_equal(a, b) for a, b in zip(X["train"], jX["train"]))
    hp = hparams.tts_acoustic.copy()
    hp.parse("recompute_delta_features=true")
    hp.stream_sizes = [60, 3, 1, 3]
    lo, hi = preprocessing.minmax(X["train"])
    mean, var = preprocessing.meanvar(Y["train"])
    args = (X["train"], Y["train"], lo, hi, mean, np.sqrt(var), True,
            hp.windows, hp.stream_sizes, hp.has_dynamic_features)
    from gantts_tpu.data import TTSDataset as JaxTTSDataset

    for workers in (0, 1, 2):
        ours = data.BatchIterator(data.TTSDataset(*args), 3, True,
                                  bucket_multiple=16, num_workers=workers,
                                  cache_size=4)
        ref = JaxBatchIterator(JaxTTSDataset(*args), 3, True,
                               bucket_multiple=16)
        assert len(ours) == len(ref) == 3
        for _ in range(3):
            batches = list(ours)
            ref_batches = list(ref)
            assert len(batches) == len(ref_batches)
            for a, b in zip(batches, ref_batches):
                assert all(np.array_equal(u, v) for u, v in zip(a, b))
        assert batches[-1][2][-1] == 0  # 7 items: a zero-length row


def _small_hp(module):
    hp = module.tts_acoustic.copy()
    hp.parse("nepoch=2,batch_size=4,batch_bucket_multiple=16")
    hp.stream_sizes = [60, 3, 1, 3]
    hp.order = 20
    hp.generator_params.update(in_dim=None, out_dim=None, num_hidden=2,
                               hidden_dim=16, bidirectional=False,
                               dropout=0.0, rnn_dropout=0.0)
    hp.discriminator_params.update(in_dim=None, num_hidden=1, hidden_dim=16,
                                   dropout=0.0)
    return hp


def test_prepare_tts_matches_jax(corpus, tmp_path):
    """The same stats files (the evaluation scripts' names) and the same
    inferred dims."""
    xdir, ydir = join(corpus, "X_acoustic"), join(corpus, "Y_acoustic")
    out = {}
    for name, mod, stp in (("port", hparams, setup),
                           ("jax", jax_hparams, jax_setup)):
        hp = _small_hp(mod)
        d = tmp_path / name
        d.mkdir()
        X, Y, lens = stp.load_arrays(xdir, ydir)
        _, mean, std = stp.prepare_tts(X, Y, lens, hp, str(d))
        out[name] = (hp.generator_params, hp.discriminator_params, mean, std,
                     {f: np.load(d / f) for f in sorted(os.listdir(d))})
    port, ref = out["port"], out["jax"]
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[1]["in_dim"] == 20 - 2 + 30
    assert np.array_equal(port[2], ref[2]) and np.array_equal(port[3], ref[3])
    assert list(port[4]) == ["X_acoustic_data_max.npy",
                             "X_acoustic_data_min.npy",
                             "Y_acoustic_data_mean.npy",
                             "Y_acoustic_data_var.npy"] == list(ref[4])
    assert all(np.array_equal(port[4][f], ref[4][f]) for f in port[4])


def test_sgd_matches_jax():
    """SGD with momentum and weight decay behind the global-norm clip: three
    steps from the same gradients agree with the JAX package's optax chain
    to f32 rounding (atol 1e-7)."""
    rs = np.random.RandomState(3)
    p0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) * s for s in (0.1, 3.0, 0.5)]
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-3)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = create_optimizer("SGD", kw, [p])
    tx = jax_optim.create_optimizer("SGD", kw)
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        upd, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = jp + upd
    assert np.abs(p.detach().numpy() - np.asarray(jp)).max() < 1e-7
    with pytest.raises(ValueError, match="SGD"):
        create_optimizer("Lamb", {"lr": 0.1}, [p])


def _recorder():
    rows = []

    class Recorder:
        def log_value(self, name, value, step):
            rows.append((name, float(value), int(step)))

        def flush(self):
            pass
    return Recorder(), rows


def _port_states(hp, variables_g=None, variables_d=None):
    mg, md, _, _, gstate, dstate = setup.init_models_and_states(
        hp, seed=0, device="cpu")
    if variables_g is not None:
        mg.load_state_dict(convert.flax_to_torch(variables_g), strict=True)
        md.load_state_dict(convert.flax_to_torch(variables_d), strict=True)
    return gstate, dstate


def _port_loop(corpus, data_dir, hp, gstate=None, dstate=None, **kw):
    X, Y, lens = setup.load_arrays(join(corpus, "X_acoustic"),
                                   join(corpus, "Y_acoustic"))
    loaders, mean, std = setup.prepare_tts(X, Y, lens, hp, data_dir)
    if gstate is None:
        gstate, dstate = _port_states(hp)
    trainer = GanTrainer(StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True,
                                                 True), mean, std, "cpu")
    writer, rows = _recorder()
    train_loop(trainer, gstate, dstate, loaders, hp, w_d=1.0, writer=writer,
               **kw)
    return gstate, dstate, rows


def test_train_loop_matches_jax(corpus, tmp_path):
    """Two epochs (two train and one test batch each) from the same initial
    weights: the same series, in the same order, every value within rtol
    1e-4 except the wall-clock ones."""
    from test_torch_step import _torch_adagrad

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jhp = _small_hp(jax_hparams)
    X, Y, lens = jax_setup.load_arrays(join(corpus, "X_acoustic"),
                                       join(corpus, "Y_acoustic"))
    loaders, mean, std = jax_setup.prepare_tts(X, Y, lens, jhp,
                                               str(tmp_path / "jax"))
    model_g, model_d, _, _, jg, jd = jax_setup.init_models_and_states(jhp)
    g0, d0 = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    tx_g = _torch_adagrad(**jhp.optimizer_g_params)
    tx_d = _torch_adagrad(**jhp.optimizer_d_params)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    jtr = JaxTrainer(model_g, model_d, tx_g, tx_d,
                     JaxConfig.from_hparams(jhp, 1.0, 0.0, 1.0, True, True),
                     mean, std)
    writer, ref_rows = _recorder()
    jax_loop.train_loop(jtr, jg, jd, None, loaders, jhp, w_d=1.0,
                        writer=writer)

    hp = _small_hp(hparams)
    for ours, ref in ((hp.generator_params, jhp.generator_params),
                      (hp.discriminator_params, jhp.discriminator_params)):
        ours.update({k: ref[k] for k in ("in_dim", "out_dim")})
    gstate, dstate = _port_states(hp, g0, d0)
    _, _, rows = _port_loop(corpus, str(tmp_path / "port"), hp, gstate,
                            dstate)
    assert [(n, s) for n, _, s in rows] == [(n, s) for n, _, s in ref_rows]
    tags = {n for n, _, _ in rows}
    assert {"train mge loss", "test mcd metric", "E(adv)",
            "Real train acc", "train frames_per_sec"} <= tags
    for (name, v, step), (_, r, _) in zip(rows, ref_rows):
        assert np.isfinite(v), name
        if name.endswith(("frames_per_sec", "epoch_seconds")):
            assert v > 0
        else:
            assert abs(v - r) <= 1e-4 * max(abs(r), 1e-3), (name, step, v, r)


def test_checkpoint_round_trip_and_resume(corpus, tmp_path):
    """save -> load -> restore gives back the same parameters and
    optimizer state (or a fresh optimizer with ``reset_optimizer``), the
    file is written atomically, and a loop resumed at epoch 2 runs exactly
    the epochs left."""
    hp = _small_hp(hparams)
    gstate, dstate, rows = _port_loop(corpus, str(tmp_path), hp)
    ck = tmp_path / "ck"
    ck.mkdir()
    paths = [save_checkpoint(s, 2, str(ck), n)
             for s, n in ((gstate, "Generator"), (dstate, "Discriminator"))]
    assert [os.path.basename(p) for p in paths] == [
        "checkpoint_epoch2_Generator.pth", "checkpoint_epoch2_Discriminator.pth"]
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]
    sd, opt, epoch = load_checkpoint(paths[0])
    assert epoch == 2 and set(sd) == set(gstate.model.state_dict())
    for k, v in gstate.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    g2, d2 = _port_states(hp)
    assert restore(g2, paths[0]) == 2 and restore(d2, paths[1]) == 2
    for a, b in ((g2, gstate), (d2, dstate)):
        for k, v in b.model.state_dict().items():
            assert torch.equal(a.model.state_dict()[k], v), k
        sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sb["state"].items():
            for k, v in st.items():
                assert torch.equal(sa["state"][i][k], v), (i, k)
    g3, _ = _port_states(hp)
    restore(g3, paths[0], reset_optimizer=True)
    assert all(float(st["step"]) == 0 and not st["sum"].any()
               for st in g3.optimizer.state_dict()["state"].values())

    # resume: nepoch 3 from epoch 2 runs exactly epoch 3
    hp3 = _small_hp(hparams)
    hp3.nepoch = 3
    _, _, resumed = _port_loop(corpus, str(tmp_path), hp3, g2, d2,
                               global_epoch=2)
    assert {s for _, _, s in resumed} == {3}
    assert {n for n, _, _ in resumed} == {n for n, _, _ in rows}
    assert all(np.isfinite(v) for _, v, _ in resumed)


def _cli(corpus, ckpt, log, nepoch, *extra):
    hp = (f"nepoch={nepoch},batch_size=4,batch_bucket_multiple=16,order=20,"
          "stream_sizes=[60, 3, 1, 3],"
          "generator_params={'in_dim': None, 'out_dim': None, "
          "'num_hidden': 2, 'hidden_dim': 16, 'bidirectional': False, "
          "'dropout': 0.2, 'use_relu': 1, 'rnn_dropout': 0.2, "
          "'last_sigmoid': False},"
          "discriminator_params={'in_dim': None, 'out_dim': 1, "
          "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.5, "
          "'last_sigmoid': True}")
    return subprocess.run(
        [sys.executable, "-m", "gantts_tpu_torch.train",
         join(corpus, "X_acoustic"), join(corpus, "Y_acoustic"),
         "--hparams_name=tts_acoustic", f"--hparams={hp}", "--w_d=1",
         f"--checkpoint-dir={ckpt}", f"--log-event-path={log}",
         "--disable-slack", "--device", "cpu", *extra],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))


def _tags(log):
    with open(join(log, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_smoke_cpu(corpus, tmp_path):
    """The port's command line on the CPU, as tests/test_train.py drives
    train.py: one epoch, then a second stage resumed from both
    checkpoints."""
    ckpt, log = str(tmp_path / "ck"), str(tmp_path / "log")
    r = _cli(corpus, ckpt, log, 1)
    assert r.returncode == 0, r.stderr[-3000:]
    for name in ("Generator", "Discriminator"):
        assert exists(join(ckpt, f"checkpoint_epoch1_{name}.pth"))
    rows = _tags(log)
    tags = {row["tag"] for row in rows}
    assert {"train mge loss", "test mcd metric", "train discriminator loss",
            "train frames_per_sec", "test frames_per_sec"} <= tags
    assert all(math.isfinite(row["value"]) for row in rows)

    r = _cli(corpus, ckpt, log, 2,
             f"--checkpoint-g={ckpt}/checkpoint_epoch1_Generator.pth",
             f"--checkpoint-d={ckpt}/checkpoint_epoch1_Discriminator.pth")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Start training from epoch 1" in r.stdout
    for name in ("Generator", "Discriminator"):
        assert exists(join(ckpt, f"checkpoint_epoch2_{name}.pth"))
    resumed = _tags(log)[len(rows):]
    assert {row["step"] for row in resumed} == {2}
    assert {row["tag"] for row in resumed} == tags
    assert all(math.isfinite(row["value"]) for row in resumed)


def test_cli_takes_the_vc_bundle(tmp_path):
    """The vc bundle (the default, as in train.py) is taken: the command
    line goes on to read the parallel corpus, and what stops it here is the
    missing X directory.  tests/test_torch_synthesis.py trains it end to
    end."""
    from gantts_tpu_torch.train.__main__ import main

    with pytest.raises(FileNotFoundError, match="X"):
        main([str(tmp_path / "X"), str(tmp_path / "Y"), "--device", "cpu"])
