"""Multi-step dispatch on the port (``--steps-per-dispatch``), on the CPU.

* ``dispatch_groups``, the loop's grouping of a phase's batches, on shape
  sequences: groups of K, a flush at each change of shapes, the rest one
  at a time, the order kept, and the first batch of new shapes alone (the
  warm-up a CUDA graph capture needs).
* ``train_loop`` with ``steps_per_dispatch=2`` logs the series of the
  unfused loop bit for bit (but for the wall-clock series), and the series
  of the JAX package's loop with ``steps_per_dispatch=2``
  (tests/test_train.py's test of its own, here across packages: a small vc
  configuration, dropout off, converted initial weights, torch's Adagrad
  rule on the JAX side as in tests/test_torch_step.py) within rtol 1e-5.
* ``GanTrainer.multi_step`` against K ``step`` calls, bit for bit, dropout
  on: outputs, parameters, optimizer state and the generator's state.
* The port's own optimizer update (train/optim.py, which keeps the learning
  rate and the step count on the device) against torch.optim's, bit for
  bit: Adagrad, Adam and SGD, with and without weight decay and momentum,
  a learning-rate change between steps, the ``state_dict`` keys and values.
* The adversarial weight as a device scalar against the float.
* The command line's rules for ``--steps-per-dispatch``.
* ``--debug-nans``: one read a step, naming the batch and the quantity.
"""

import copy
import json
import os
import sys
from os.path import dirname, join
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from gantts_tpu import hparams as jax_hparams
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train import loop as jax_loop
from gantts_tpu.train import setup as jax_setup
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.train import GanTrainer, StepConfig, loop, setup
from gantts_tpu_torch.train.__main__ import main as train_main
from gantts_tpu_torch.train.__main__ import steps_per_dispatch
from gantts_tpu_torch.train.optim import (
    GRAD_CLIP_NORM,
    create_optimizer,
    set_learning_rate,
)

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


# ---- the grouping ----------------------------------------------------------

GROUPING = {
    # name: (shape sequence, K, warm shapes, expected dispatches)
    "groups of K": ("aaaaaa", 3, "a", ["aaa", "aaa"]),
    "the rest single": ("aaaaa", 2, "a", ["aa", "aa", "a"]),
    "flush at a change": ("aaabbb", 2, "ab",
                          ["aa", "a", "bb", "b"]),
    "order kept": ("abab", 2, "ab", ["a", "b", "a", "b"]),
    "new shape alone first": ("aaaaa", 2, "", ["a", "aa", "aa"]),
    "new shape after a flush": ("aaabbbb", 2, "a",
                                ["aa", "a", "b", "bb", "b"]),
    "K = 1 takes no warm-up": ("aab", 1, "", ["a", "a", "b"]),
    "an empty phase": ("", 4, "", []),
}


@pytest.mark.parametrize("case", list(GROUPING))
def test_dispatch_groups(case):
    shapes, K, warm, want = GROUPING[case]
    batches = list(enumerate(shapes))
    warm = set(warm)
    got = list(loop.dispatch_groups(iter(batches), lambda b: b[1], K, warm))
    assert ["".join(s for _, s in g) for g in got] == want
    assert [i for g in got for i, _ in g] == list(range(len(shapes)))
    assert all(len(g) in (1, K) for g in got)
    assert warm >= set(shapes) or K == 1


# ---- the optimizers ----------------------------------------------------------

OPTIMIZERS = {
    "Adagrad": ("Adagrad", dict(lr=0.01)),
    "Adagrad, weight decay": ("Adagrad", dict(lr=0.01, weight_decay=1e-7)),
    "Adam": ("Adam", dict(lr=0.001, betas=(0.5, 0.9))),
    "Adam, weight decay": ("Adam", dict(lr=0.001, weight_decay=1e-3)),
    "SGD": ("SGD", dict(lr=0.1)),
    "SGD, momentum and weight decay": ("SGD", dict(lr=0.1, momentum=0.9,
                                                   weight_decay=1e-4)),
}


def _torch_optim(name, kw, params):
    if name == "Adagrad":
        return torch.optim.Adagrad(params, lr=kw["lr"],
                                   weight_decay=kw.get("weight_decay", 0),
                                   initial_accumulator_value=0.0, eps=1e-10)
    if name == "Adam":
        return torch.optim.Adam(params, lr=kw["lr"],
                                betas=kw.get("betas", (0.9, 0.999)), eps=1e-8,
                                weight_decay=kw.get("weight_decay", 0))
    return torch.optim.SGD(params, lr=kw["lr"],
                           momentum=kw.get("momentum", 0.0),
                           weight_decay=kw.get("weight_decay", 0))


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_update_is_torch_optims(case):
    """Eight steps, gradients from 1 down to 1e-7 (the clip engaged, then
    not), the learning rate cut tenfold after the third: parameters bit for
    bit after every step, and the same state_dict (keys in torch's order,
    dtypes and values) at the end, also after a round trip."""
    name, kw = OPTIMIZERS[case]
    rs = np.random.RandomState(0)
    init = [rs.randn(37, 5).astype(np.float32),
            rs.randn(11).astype(np.float32)]
    ours = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    theirs = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = create_optimizer(name, kw, ours)
    ref = _torch_optim(name, kw, theirs)
    for i in range(8):
        if i == 3:
            set_learning_rate(opt, kw["lr"] * 0.1)
            for g in ref.param_groups:
                g["lr"] = kw["lr"] * 0.1
        for p, q in zip(ours, theirs):
            g = torch.from_numpy(rs.randn(*p.shape).astype(np.float32)
                                 * 10.0 ** -i)
            p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        torch.nn.utils.clip_grad_norm_(theirs, GRAD_CLIP_NORM)
        ref.step()
        for p, q in zip(ours, theirs):
            assert torch.equal(p, q), (i, (p - q).abs().max())
    a, b = opt.state_dict(), ref.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert list(a["state"]) == list(b["state"])
    for i in b["state"]:
        assert list(a["state"][i]) == list(b["state"][i])
        for k, v in b["state"][i].items():
            assert a["state"][i][k].dtype == v.dtype, (i, k)
            assert a["state"][i][k].device == v.device, (i, k)
            assert torch.equal(a["state"][i][k], v), (i, k)
    again = create_optimizer(name, kw, ours)
    again.load_state_dict(copy.deepcopy(a))
    if name != "SGD":  # torch's SGD keeps no step count
        assert float(again._step) == float(opt._step) == 8
    assert again.param_groups[0]["lr"] == kw["lr"] * 0.1


def test_optimizer_refuses_a_step_with_missing_gradients():
    ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    opt = create_optimizer("Adagrad", dict(lr=0.01), ps)
    ps[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match="1 of the optimizer's 2"):
        opt.step()


# ---- the step --------------------------------------------------------------

LIN, K, B, T = 30, 3, 4, 32


def _acoustic_hp(dropout):
    hp = hparams.tts_acoustic.copy()
    hp.stream_sizes = [60, 3, 1, 3]
    hp.order = 20
    hp.generator_params.update(in_dim=LIN, out_dim=67, num_hidden=2,
                               hidden_dim=16, dropout=dropout,
                               rnn_dropout=dropout)
    hp.discriminator_params.update(in_dim=20 - 2 + LIN, num_hidden=1,
                                   hidden_dim=8, dropout=dropout)
    return hp


def _stacked(seed=3):
    rs = np.random.RandomState(seed)
    xs = torch.from_numpy(rs.rand(K, B, T, LIN).astype(np.float32))
    ys = torch.from_numpy(rs.randn(K, B, T, 67).astype(np.float32))
    ls = torch.from_numpy(np.stack([
        np.r_[rs.randint(T // 2, T, B - 1), T] for _ in range(K)])
        .astype(np.int32))
    return xs, ys, ls


def _trainer(hp, w_d=1.0):
    cfg = StepConfig.from_hparams(hp, w_d, 0.0, 1.0, True, True)
    y_mean = np.zeros(67, np.float32)
    y_mean[63] = 2.0  # V/UV around 2: f0_rmse is a number
    return GanTrainer(cfg, y_mean, np.ones(67, np.float32), "cpu")


def _same_states(a, b):
    for (na, pa), (nb, pb) in zip(a.model.named_parameters(),
                                  b.model.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sb["state"]:
        for k, v in sb["state"][i].items():
            assert torch.equal(sa["state"][i][k], v), (i, k)


def test_multi_step_is_k_steps():
    """Dropout on: the stacked dispatch draws the generator as K step calls
    do, so every output, parameter, optimizer state and the generator's
    state agree bit for bit."""
    hp = _acoustic_hp(dropout=0.3)
    xs, ys, ls = _stacked()
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T))
    runs = []
    for fused in (False, True):
        _, _, _, _, gstate, dstate = setup.init_models_and_states(
            hp, seed=0, device="cpu")
        trainer = _trainer(hp)
        gen = torch.Generator().manual_seed(5)
        adv_w = torch.tensor(0.7)
        if fused:
            _, _, outs = trainer.multi_step(gstate, dstate, xs, ys, ls, R,
                                            adv_w, generator=gen)
        else:
            steps = [trainer.step(gstate, dstate, xs[k], ys[k], ls[k], R,
                                  adv_w, generator=gen)[2] for k in range(K)]
            outs = {key: torch.stack([o[key] for o in steps])
                    for key in steps[0]}
        runs.append((gstate, dstate, gen, outs))
    (g1, d1, gen1, o1), (g2, d2, gen2, o2) = runs
    assert o1.keys() == o2.keys() and "f0_rmse" in o1
    for key in o1:
        assert o2[key].shape == (K,)
        assert torch.equal(o1[key], o2[key]) or (
            torch.isnan(o1[key]).equal(torch.isnan(o2[key]))), key
    _same_states(g1, g2)
    _same_states(d1, d2)
    assert torch.equal(gen1.get_state(), gen2.get_state())


def test_adv_w_tensor_is_the_float():
    hp = _acoustic_hp(dropout=0.0)
    xs, ys, ls = _stacked()
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T))
    runs = []
    for adv_w in (0.37, torch.tensor(0.37, dtype=torch.float32)):
        _, _, _, _, gstate, dstate = setup.init_models_and_states(
            hp, seed=0, device="cpu")
        out = _trainer(hp).step(gstate, dstate, xs[0], ys[0], ls[0], R,
                                adv_w)[2]
        runs.append((gstate, dstate, out))
    (g1, d1, o1), (g2, d2, o2) = runs
    for key in o1:
        assert torch.equal(o1[key], o2[key]), key
    _same_states(g1, g2)
    _same_states(d1, d2)


# ---- the loop against itself and against the JAX package's ----------------

def _vc_hp(module):
    """tests/test_train.py's small vc configuration, dropout off, with a
    bucket of 128 frames so that consecutive batches share their shapes."""
    hp = module.vc.copy()
    hp.parse("nepoch=3,batch_size=4,batch_bucket_multiple=128")
    hp.order = 19
    hp.stream_sizes = [19 * 3]
    hp.generator_params.update(in_dim=57, out_dim=57, static_dim=19,
                               num_hidden=1, hidden_dim=32, dropout=0.0)
    hp.discriminator_params.update(in_dim=19, num_hidden=1, hidden_dim=16,
                                   dropout=0.0)
    return hp


@pytest.fixture(scope="module")
def vc_corpus(tmp_path_factory):
    from tests.make_synthetic_data import make_vc

    d = str(tmp_path_factory.mktemp("vcdata"))
    make_vc(d, num=24, order=19)
    return d


def _recorder():
    rows = []

    class Recorder:
        def log_value(self, name, value, step):
            rows.append((name, float(value), int(step)))

        def flush(self):
            pass
    return Recorder(), rows


def _jax_loop(corpus, data_dir, K):
    from test_torch_step import _torch_adagrad

    jhp = _vc_hp(jax_hparams)
    X, Y, lens = jax_setup.load_arrays(join(corpus, "X"), join(corpus, "Y"))
    loaders, mean, std = jax_setup.prepare_vc(X, Y, lens, jhp, data_dir)
    model_g, model_d, _, _, jg, jd = jax_setup.init_models_and_states(jhp)
    params = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    tx_g = _torch_adagrad(**jhp.optimizer_g_params)
    tx_d = _torch_adagrad(**jhp.optimizer_d_params)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    trainer = JaxTrainer(model_g, model_d, tx_g, tx_d,
                         JaxConfig.from_hparams(jhp, 0.7, 0.0, 1.0, True,
                                                True), mean, std)
    writer, rows = _recorder()
    jax_loop.train_loop(trainer, jg, jd, None, loaders, jhp, w_d=0.7,
                        writer=writer, steps_per_dispatch=K)
    return params, rows


def _port_loop(corpus, data_dir, params, K):
    hp = _vc_hp(hparams)
    X, Y, lens = setup.load_arrays(join(corpus, "X"), join(corpus, "Y"))
    loaders, mean, std = setup.prepare_vc(X, Y, lens, hp, data_dir)
    mg, md, _, _, gstate, dstate = setup.init_models_and_states(
        hp, seed=0, device="cpu")
    mg.load_state_dict(convert.flax_to_torch(params[0]), strict=True)
    md.load_state_dict(convert.flax_to_torch(params[1]), strict=True)
    trainer = GanTrainer(StepConfig.from_hparams(hp, 0.7, 0.0, 1.0, True,
                                                 True), mean, std, "cpu")
    writer, rows = _recorder()
    fused = []
    real = trainer.multi_step

    def counted(*args, **kwargs):
        fused.append(args[2].shape[0])
        return real(*args, **kwargs)
    trainer.multi_step = counted
    loop.train_loop(trainer, gstate, dstate, loaders, hp, w_d=0.7,
                    writer=writer, steps_per_dispatch=K)
    return rows, fused


def _timing(name):
    return name.endswith(("frames_per_sec", "epoch_seconds"))


def test_train_loop_steps_per_dispatch(vc_corpus, tmp_path):
    """Three epochs of the small vc configuration: the port's loop with
    K = 2 logs the unfused loop's series bit for bit (and fuses), and the
    JAX package's loop with K = 2 within rtol 1e-5."""
    for d in ("jax", "port1", "port2"):
        (tmp_path / d).mkdir()
    params, ref_rows = _jax_loop(vc_corpus, str(tmp_path / "jax"), 2)
    rows1, fused1 = _port_loop(vc_corpus, str(tmp_path / "port1"), params, 1)
    rows2, fused2 = _port_loop(vc_corpus, str(tmp_path / "port2"), params, 2)
    assert fused1 == [] and fused2 and set(fused2) == {2}
    assert [(n, s) for n, _, s in rows2] == [(n, s) for n, _, s in rows1]
    assert [(n, s) for n, _, s in rows2] == [(n, s) for n, _, s in ref_rows]
    assert "train loss_adv loss" in {n for n, _, _ in rows2}
    for (name, v1, s), (_, v2, _), (_, r, _) in zip(rows1, rows2, ref_rows):
        if _timing(name):
            continue
        assert v1 == v2 or (np.isnan(v1) and np.isnan(v2)), (name, s)
        assert abs(v2 - r) <= 1e-5 * max(abs(r), 1e-3), (name, s, v2, r)


# ---- the command line --------------------------------------------------------

@pytest.mark.parametrize("requested, device, debug_nans, want", [
    (0, "cpu", False, 1),
    (1, "cpu", False, 1),
    (0, "cuda", False, 16),
    (4, "cuda", False, 4),
    (0, "cuda", True, 1),
    (16, "cuda", True, 1),
])
def test_steps_per_dispatch_rule(requested, device, debug_nans, want):
    assert steps_per_dispatch(requested, device, debug_nans) == want


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import chip_smoke

    d = str(tmp_path_factory.mktemp("acoustic"))
    chip_smoke.write_acoustic_corpus(d, num=14, lin_dim=30, mgc_dim=20,
                                     frames=(80, 221))
    return d


def _argv(corpus, ck, *extra):
    gp = dict(hparams.tts_acoustic.generator_params, num_hidden=1,
              hidden_dim=16, bidirectional=False)
    dp = dict(hparams.tts_acoustic.discriminator_params, num_hidden=1,
              hidden_dim=8)
    return [join(corpus, "X_acoustic"), join(corpus, "Y_acoustic"),
            "--hparams_name=tts_acoustic",
            f"--hparams=nepoch=1,batch_size=4,stream_sizes=[60, 3, 1, 3],"
            f"order=20,generator_params={gp!r},"
            f"discriminator_params={dp!r}", f"--checkpoint-dir={ck}",
            f"--log-event-path={ck}/log", "--device=cpu", *extra]


def test_cli_refuses_fused_dispatch_on_the_cpu(corpus, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        train_main(_argv(corpus, str(tmp_path), "--steps-per-dispatch=4"))
    assert e.value.code == 2
    assert "--steps-per-dispatch 4 needs CUDA graphs: device 'cpu'" in \
        capsys.readouterr().err


@pytest.mark.parametrize("flags, said", [
    ([], "1 step(s) a dispatch"),
    (["--debug-nans", "--steps-per-dispatch=1"],
     "--debug-nans: one eager step at a time"),
])
def test_cli_dispatch_on_the_cpu(corpus, tmp_path, capsys, flags, said):
    ck = str(tmp_path / "ck")
    assert train_main(_argv(corpus, ck, *flags)) == 0
    assert said in capsys.readouterr().out
    with open(join(ck, "log", "scalars.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["value"]) for line in f)


# ---- --debug-nans: one read a step --------------------------------------------

def test_debug_nans_reads_once_a_step(corpus, tmp_path):
    """Each step's norms and losses are read together, once: as many reads
    as steps, each of both norms in a train step; torch's clip is never
    asked to read the norm itself."""
    reads, clips = [], []
    real_read = loop._require_finite_losses
    real_clip = torch.nn.utils.clip_grad_norm_

    def read(out, where, norms=()):
        reads.append((where, [name for name, _ in norms]))
        return real_read(out, where, norms)

    def clip(*args, **kwargs):
        clips.append(kwargs.get("error_if_nonfinite", False))
        return real_clip(*args, **kwargs)
    with mock.patch.object(loop, "_require_finite_losses", read), \
            mock.patch.object(torch.nn.utils, "clip_grad_norm_", clip):
        assert train_main(_argv(corpus, str(tmp_path), "--debug-nans",
                                "--w_d=1")) == 0
    train = [r for r in reads if "train phase" in r[0]]
    test = [r for r in reads if "test phase" in r[0]]
    assert train and test and len(reads) == len(train) + len(test)
    assert [w for w, _ in train] == [f"epoch 1, train phase, batch {i}"
                                     for i in range(len(train))]
    assert all(n == ["discriminator", "generator"] for _, n in train)
    assert all(n == [] for _, n in test)
    assert clips and not any(clips)


@pytest.mark.parametrize("bad", ["norm", "loss"])
def test_debug_nans_names_the_quantity(bad):
    out = {"mse": torch.tensor(1.0), "mge": torch.tensor(2.0)}
    norms = [("discriminator", torch.tensor(0.5)),
             ("generator", torch.tensor(3.0))]
    if bad == "norm":
        norms[1] = ("generator", torch.tensor(float("inf")))
        out["mge"] = torch.tensor(float("nan"))
        match = ("epoch 2, train phase, batch 7: the generator's gradient "
                 "norm is not finite \\(not finite: generator's gradient "
                 "norm, mge loss\\)")
    else:
        out["mse"] = torch.tensor(float("nan"))
        match = "epoch 2, train phase, batch 7: the mse loss is not finite"
    with pytest.raises(FloatingPointError, match=match):
        loop._require_finite_losses(out, "epoch 2, train phase, batch 7",
                                    norms)
