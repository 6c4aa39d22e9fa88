"""Stage 5 of the tts_acoustic curriculum in both packages, from the same
files, with nothing random: does the port's adversarial training compute
the JAX package's?

A tiny tts_acoustic bundle (a 2x16 bidirectional SRURNN, a 1x8 MLP
discriminator conditioned on the linguistic input, no dropout anywhere; the
quality dossier's ``batch_size=8`` and ``W_D=0.2``; every batch padded to
256 frames, so that each phase has one shape to compile) on
tests/make_synthetic_data.py's acoustic corpus.  The repository's train.py
trains stages 1-3 (baseline, generator warm-up, discriminator warm-up) in
this process, with the command lines train_gan.sh gives them
(``curriculum.stage_argvs``) and ``--num-devices=1`` (tests/conftest.py's
eight CPU devices would make it data-parallel).  Stage 5 (``--reset_optimizers``,
``--restart_epoch``, ``--w_d=0.2``) then trains epochs 5-7 from those same
files three times: in train.py, in the port (which reads the JAX package's
files), and in the port with its Adagrad patched to optax's rule, the
control.  Every side takes the same batches in the same order (``seed +
epoch``) and, with dropout off and no input noise, draws nothing else.

Compared each epoch: every logged value but the timings (the losses, the
metrics of both phases, E(mge), E(adv) and their ratio, which sets the next
epoch's adv_w, and the discriminator's accuracies); after the last epoch,
the generators' outputs on the test split and their GV ratio there.

The packages' Adagrad rules differ (ROADMAP section 3): torch divides by
sqrt(sum g^2) + eps, optax by sqrt(sum g^2 + eps).  The control takes
optax's rule in the port; it must agree with train.py to ``CONTROL_RTOL``
(float32 rounding of two programs, carried through seven epochs).  The
shipped port must agree to ``SHIPPED_RTOL`` (``SHIPPED_FRAME_RTOL`` for the
frame shares that a threshold decides, ``SHIPPED_OUT`` for the outputs),
about 4 times what the eps gap alone makes of this run, and the control must
close its gap more than a hundredfold: a gap beyond that is a fault of the
port, not of eps.

The corpus's targets are smooth random trajectories drawn apart from the
inputs, so the generator learns little beyond their mean and its GV ratio
stays near 0.001; the test holds the two packages to the same value, which
says nothing of the dossier's GV.
"""

import contextlib
import json
import math
import os
import sys
from os.path import join
from unittest import mock

import pytest
import torch
from make_synthetic_data import make_acoustic

import train as jax_train_cli
from gantts_tpu import hparams as jax_hparams
from gantts_tpu_torch import curriculum, hparams
from gantts_tpu_torch.core.masking import sequence_mask
from gantts_tpu_torch.models import create_model
from gantts_tpu_torch.train import GanTrainer, StepConfig, optim
from gantts_tpu_torch.train.__main__ import main as port_train_main
from gantts_tpu_torch.train.checkpoint import load_checkpoint
from gantts_tpu_torch.train.loop import RMatrixCache
from gantts_tpu_torch.train.setup import load_arrays, prepare_tts

torch.set_num_threads(1)

HP = ("batch_size=8,batch_bucket_multiple=256,order=20,"
      "stream_sizes=[60, 3, 1, 3],"
      "generator_params={'in_dim': None, 'out_dim': None, 'num_hidden': 2, "
      "'hidden_dim': 16, 'bidirectional': True, 'dropout': 0.0, "
      "'use_relu': 1, 'rnn_dropout': 0.0, 'last_sigmoid': False},"
      "discriminator_params={'in_dim': None, 'out_dim': 1, "
      "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.0, "
      "'last_sigmoid': True}")
G_WARM, D_WARM, TOTAL = "4", "2", "7"  # stage 5 trains epochs 5, 6 and 7
W_D = "0.2"
UTTERANCES = 24
LIN_DIM = 30
TIMINGS = ("frames_per_sec", "epoch_seconds")
# Limits, relative to each reference value.  Read on this CPU (torch
# 2.13.0+cpu, jax 0.9.0): the control's largest gap over every logged value
# 5.7e-7, its outputs 5.0e-7 of their largest |value| and its GV ratio 3.5e-8
# apart; the shipped port's 7.4e-4 (continuous values), 8.2e-3 (frame
# shares), 1.3e-2 (outputs) and 1.2e-3 (GV ratio).
CONTROL_RTOL = 1e-5
SHIPPED_RTOL = 3e-3
THRESHOLDED = ("acc", "vuv_err metric", "f0_rmse metric")
SHIPPED_FRAME_RTOL = 0.03
CONTROL_OUT = (1e-5, 1e-5)  # (outputs, GV ratio)
SHIPPED_OUT = (0.05, 0.01)


def _curriculum_args(data, ck):
    return curriculum.build_arg_parser().parse_args([
        "tts_acoustic", HP, join(data, "X_acoustic"),
        join(data, "Y_acoustic"), ck, G_WARM, D_WARM, TOTAL, TOTAL])


def _stages(data, ck, *enabled):
    env = {switch: "1" if stage in enabled else "0"
           for stage, (switch, _) in curriculum.STAGES.items()}
    env["W_D"] = W_D
    return curriculum.stage_argvs(_curriculum_args(data, ck), env)


@contextlib.contextmanager
def _no_tensorboard():
    """Make ``torch.utils.tensorboard`` fail to import, unless something
    imported it already (then the writer finds it at no cost)."""
    name = "torch.utils.tensorboard"
    if name in sys.modules:
        yield
        return
    sys.modules[name] = None
    try:
        yield
    finally:
        sys.modules.pop(name, None)


def _run_jax(argv):
    """train.py's main on ``argv``, on a copy of the bundle it parses its
    flags into, writing the JSONL scalars alone (no TensorBoard import)."""
    with mock.patch.object(jax_hparams, "tts_acoustic",
                           jax_hparams.tts_acoustic.copy()), \
            _no_tensorboard():
        assert jax_train_cli.main(
            argv + ["--num-devices=1", "--disable-slack"]) == 0


def _optax_adagrad(group, params, grads, state, lr, step):
    """optax's scale_by_rss after the clip: g / sqrt(sum g^2 + eps), 0 where
    the sum is 0."""
    with torch.no_grad():
        wd, eps = group["weight_decay"], group["eps"]
        for p, g in zip(params, grads):
            if wd != 0:
                g = g + wd * p
            s = state[p]["sum"]
            s.addcmul_(g, g, value=1)
            scale = torch.where(s > 0, torch.rsqrt(s + eps),
                                torch.zeros_like(s))
            p.add_(g * scale * (-lr).float())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage5")
    data = str(tmp / "data")
    make_acoustic(data, UTTERANCES, lin_dim=LIN_DIM, mgc_order=20)
    warm = str(tmp / "warm")
    for _, argv in _stages(data, warm, "baseline", "generator_warmup",
                           "discriminator_warmup"):
        _run_jax(argv)
    sides = {}
    for side in ("jax", "port", "control"):
        ck = str(tmp / side)
        os.makedirs(join(ck, "gan"))
        for name, epoch in (("Generator", G_WARM),
                            ("Discriminator", D_WARM)):
            f = f"checkpoint_epoch{epoch}_{name}.pth"
            os.link(join(warm, "gan", f), join(ck, "gan", f))
        (_, argv), = _stages(data, ck, "adversarial")
        if side == "jax":
            _run_jax(argv)
        else:
            with mock.patch.dict(optim._UPDATES, {"Adagrad": _optax_adagrad}
                                 if side == "control" else {}):
                assert port_train_main(argv + ["--device=cpu"]) == 0
        sides[side] = ck
    return data, sides


def _logged(ck):
    rows = {}
    with open(join(ck, "gan", "log", "scalars.jsonl")) as f:
        for r in map(json.loads, f):
            if not r["tag"].endswith(TIMINGS):
                rows[(r["step"], r["tag"])] = r["value"]
    return rows


def _gaps(got, ref):
    """Each logged value's gap from the reference, relative to its size;
    0 where both are NaN (f0_rmse of a phase with no frame that both call
    voiced)."""
    assert got.keys() == ref.keys()
    gaps = {}
    for k, r in ref.items():
        if math.isnan(r) and math.isnan(got[k]):
            gaps[k] = 0.0
        else:
            gaps[k] = abs(got[k] - r) / max(abs(r), 1e-6)
            assert math.isfinite(gaps[k]), (k, got[k], r)
    return gaps


def _test_outputs(data, sides):
    """For each side, the final generator's outputs (normalized, after
    MLPG) on the test split's valid frames, and the GV ratio of their
    static mel-cepstra to the natural ones there (per dimension, then the
    mean; a ratio per dimension is the same before and after
    denormalization)."""
    hp = hparams.tts_acoustic.copy()
    hp.parse(HP)
    X, Y, lengths = load_arrays(join(data, "X_acoustic"),
                                join(data, "Y_acoustic"))
    loaders, y_mean, y_std = prepare_tts(X, Y, lengths, hp, data)
    cfg = StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True, True)
    trainer = GanTrainer(cfg, y_mean, y_std, "cpu")
    r_cache = RMatrixCache(hp.windows, "cpu")
    mgc = hp.stream_sizes[0] // len(hp.windows)
    batches = [tuple(torch.as_tensor(a) for a in b)
               for b in loaders["test"]]
    natural = torch.cat([
        y[sequence_mask(lh, y.shape[1]) > 0.5][:, :mgc]
        for _, y, lh in batches])
    found = {}
    for side, ck in sides.items():
        state, _, epoch = load_checkpoint(
            join(ck, "gan", f"checkpoint_epoch{TOTAL}_Generator.pth"))
        assert epoch == int(TOTAL)
        model = create_model(hp.generator, device="cpu",
                             **dict(hp.generator_params,
                                    in_dim=LIN_DIM, out_dim=67)).eval()
        model.load_state_dict(state)
        outs = []
        with torch.no_grad():
            for x, y, lh in batches:
                y_hat, _ = trainer._gen_forward(
                    model, x, r_cache.get(x.shape[1]), lh, None)
                outs.append(y_hat[sequence_mask(lh, x.shape[1]) > 0.5])
        out = torch.cat(outs).double()
        gv = out[:, :mgc].var(0) / natural.double().var(0)
        found[side] = (out, float(gv.mean()))
    return found


def test_stage5_control_logs_match_jax(runs):
    """With optax's Adagrad rule the port logs the JAX package's values,
    epoch by epoch, to float32 rounding: the packages compute the same
    adversarial training."""
    _, sides = runs
    ref = _logged(sides["jax"])
    assert sorted({step for step, _ in ref}) == [5, 6, 7]
    assert len(ref) == 3 * 29
    gaps = _gaps(_logged(sides["control"]), ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < CONTROL_RTOL, (worst, gaps[worst])


def test_stage5_shipped_logs_match_jax(runs):
    """The shipped port (torch's Adagrad rule) parts from the JAX package
    by what the eps gap makes: each epoch's continuous values within
    SHIPPED_RTOL, the frame shares that thresholds decide within
    SHIPPED_FRAME_RTOL, and the control closes the gap."""
    _, sides = runs
    ref = _logged(sides["jax"])
    shipped = _gaps(_logged(sides["port"]), ref)
    control = _gaps(_logged(sides["control"]), ref)
    for key, gap in shipped.items():
        limit = (SHIPPED_FRAME_RTOL if key[1].endswith(THRESHOLDED)
                 else SHIPPED_RTOL)
        assert gap < limit, (key, gap, limit)
    assert max(shipped.values()) > 100 * max(control.values())


def test_stage5_outputs_and_gv_match_jax(runs):
    """After epoch 4: the generators' outputs on the test split and their
    GV ratio there."""
    data, sides = runs
    found = _test_outputs(data, sides)
    ref, ref_gv = found["jax"]
    scale = float(ref.abs().max())
    assert math.isfinite(scale) and scale > 0
    for side, (limit, gv_limit) in {"control": CONTROL_OUT,
                                    "port": SHIPPED_OUT}.items():
        out, gv = found[side]
        gap = float((out - ref).abs().max()) / scale
        assert gap < limit, (side, gap, limit)
        assert abs(gv - ref_gv) < gv_limit * ref_gv, (side, gv, ref_gv)
