"""The port's curriculum command (``python -m gantts_tpu_torch.curriculum``)
against the repository's train_gan.sh.

Argv parity: train_gan.sh runs with ``PYTHON`` set to a recorder that writes
the command line it is given, and the port's command runs with the training
``main`` replaced by a recorder.  Each stage's argv must be the same, once
train.py's path and the port's ``--device`` are dropped.

End to end on the CPU: stages 1-3 and 5 of a tiny tts_duration model on
tests/make_synthetic_data.py's duration corpus (30 phone features, 5
durations): every checkpoint train_gan.sh's naming gives, finite logged
values, and no MLPG matrix built for a stream without dynamic features.
The generator warm-up run after the baseline in the same process must give
the same weights as one run alone, so a stage leaves nothing behind that
changes the next.

The vc bundle: vc_demo.sh's call of train_gan.sh (``vc``, its hparams,
``X``, ``Y``, four epoch counts) with ``RUN_SPOOFING_MODEL=1``, argv for
argv; then all five stages end to end on the CPU with a tiny
In2OutRNNHighwayNet on tests/make_synthetic_data.py's parallel corpus, so
that stage 5 loads stage 4's reference discriminator (``--checkpoint-r``;
the vc discriminator reads the static mel-cepstra alone) and logs the
spoofing rate.
"""

import json
import math
import os
import subprocess
import sys
from os.path import dirname, exists, join
from unittest import mock

import pytest
import torch
from make_synthetic_data import make_duration, make_vc

from gantts_tpu_torch import curriculum
from gantts_tpu_torch.train.checkpoint import load_checkpoint

REPO = dirname(dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

SWITCHES = ("W_D", "ADV_HPARAMS", "RUN_BASELINE", "RUN_GENERATOR_WARMUP",
            "RUN_DISCRIMINATOR_WARMUP", "RUN_SPOOFING_MODEL",
            "RUN_ADVERSARIAL")
TINY = ("batch_size=4,batch_bucket_multiple=16,"
        "generator_params={'in_dim': None, 'out_dim': None, 'num_hidden': 2, "
        "'hidden_dim': 16, 'bidirectional': True, 'dropout': 0.0, "
        "'use_relu': 1, 'rnn_dropout': 0.2, 'last_sigmoid': False},"
        "discriminator_params={'in_dim': None, 'out_dim': 1, "
        "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.0, "
        "'last_sigmoid': True}")


def _env(extra):
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env.update(extra)
    return env


def _args(tmp_path):
    return ["tts_duration", TINY, f"{tmp_path}/data/X_duration",
            f"{tmp_path}/data/Y_duration", f"{tmp_path}/ck", "3", "2", "4",
            "6"]


def _bash_argvs(tmp_path, args, extra):
    recorder, log = tmp_path / "recorder.py", tmp_path / "bash.jsonl"
    recorder.write_text(
        "import json, os, sys\n"
        "with open(os.environ['ARGV_LOG'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    env = _env(extra)
    env.update(PYTHON=f"{sys.executable} {recorder}", ARGV_LOG=str(log))
    proc = subprocess.run(["bash", join(REPO, "train_gan.sh"), *args],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert all(c[0] == join(REPO, "train.py") for c in calls)
    return [c[1:] for c in calls]


def _port_argvs(args, extra, rcs=None):
    calls = []

    def record(argv):
        calls.append(list(argv))
        return (rcs or {}).get(len(calls), 0)
    with mock.patch("gantts_tpu_torch.train.__main__.main", record):
        rc = curriculum.main(args + ["--device", "cpu"], env=_env(extra))
    assert all(c[-1] == "--device=cpu" for c in calls)
    return rc, [c[:-1] for c in calls]


@pytest.mark.parametrize("extra,n_stages", [
    ({}, 4),
    ({"RUN_SPOOFING_MODEL": "1"}, 5),
    ({"W_D": "0.2",
      "ADV_HPARAMS": "optimizer_d_params={'lr': 0.001, 'weight_decay': 1e-7}"},
     4),
    ({"RUN_BASELINE": "0", "RUN_DISCRIMINATOR_WARMUP": "",
      "RUN_ADVERSARIAL": "0", "RUN_SPOOFING_MODEL": "1"}, 3),
], ids=["defaults", "spoofing", "w_d-adv_hparams", "switches"])
def test_stage_argvs_match_train_gan_sh(tmp_path, extra, n_stages):
    """The same stages, in the same order, with the same command lines.
    An empty switch takes its default, as ${NAME:-default} does."""
    args = _args(tmp_path)
    bash = _bash_argvs(tmp_path, args, extra)
    rc, port = _port_argvs(args, extra)
    assert rc == 0
    assert port == bash and len(port) == n_stages


def test_a_failing_stage_stops_the_run(tmp_path):
    """A stage that exits non-zero ends the run with its code, as set -e
    does: stage 2 returns 3, and stage 3 never runs; a command line that
    argparse refuses exits 2."""
    rc, calls = _port_argvs(_args(tmp_path), {}, rcs={2: 3})
    assert rc == 3 and len(calls) == 2
    with mock.patch.object(sys, "stderr"):
        assert curriculum._run_stage(
            lambda argv: curriculum.build_arg_parser().parse_args(argv),
            ["--no-such-flag"]) == 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Stages 1-3 and 5 on 24 utterances: G warm-up 1 epoch, D warm-up 1,
    total 2 (the adversarial stage trains epoch 2 from both warm-ups)."""
    tmp = tmp_path_factory.mktemp("curriculum")
    make_duration(str(tmp / "data"), 24, lin_dim=30)
    args = ["tts_duration", TINY, f"{tmp}/data/X_duration",
            f"{tmp}/data/Y_duration", f"{tmp}/ck", "1", "1", "1", "2",
            "--device", "cpu"]
    # durations have no dynamic features: no stage may build an MLPG matrix
    with mock.patch("gantts_tpu_torch.train.loop.unit_variance_mlpg_matrix",
                    side_effect=AssertionError("an MLPG matrix was built")):
        assert curriculum.main(args, env=_env({})) == 0
    return tmp, args


def test_curriculum_end_to_end_on_cpu(trained):
    tmp, _ = trained
    ck = tmp / "ck"
    for path in ("baseline/checkpoint_epoch2_Generator.pth",
                 "gan/checkpoint_epoch1_Generator.pth",
                 "gan/checkpoint_epoch1_Discriminator.pth",
                 "gan/checkpoint_epoch2_Generator.pth",
                 "gan/checkpoint_epoch2_Discriminator.pth"):
        assert exists(ck / path), path
    # w_d=0 trains no discriminator; the D warm-up no generator
    assert not exists(ck / "baseline/checkpoint_epoch2_Discriminator.pth")
    assert not exists(ck / "spoofing_model")
    for stage in ("baseline", "gan"):
        rows = [json.loads(line) for line in
                (ck / stage / "log" / "scalars.jsonl").read_text()
                .splitlines()]
        assert rows and all(math.isfinite(r["value"]) for r in rows)
        tags = {r["tag"] for r in rows}
        assert {"train dur_rmse metric", "test dur_rmse metric"} <= tags
    assert "train loss_adv loss" in tags  # the adversarial stage's epoch 2
    assert not torch.backends.cuda.matmul.allow_tf32


def test_stages_leave_no_state_behind(trained, tmp_path):
    """The generator warm-up alone, in a fresh directory, gives the weights
    it gave after the baseline stage in the same process."""
    tmp, args = trained
    alone = list(args)
    alone[4] = str(tmp_path / "ck")
    env = _env({"RUN_BASELINE": "0", "RUN_DISCRIMINATOR_WARMUP": "0",
                "RUN_ADVERSARIAL": "0"})
    assert curriculum.main(alone, env=env) == 0
    got, _, epoch = load_checkpoint(
        tmp_path / "ck/gan/checkpoint_epoch1_Generator.pth")
    ref, _, _ = load_checkpoint(tmp / "ck/gan/checkpoint_epoch1_Generator.pth")
    assert epoch == 1 and set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


VC_TINY = ("batch_size=4,order=19,stream_sizes=[57],"
           "generator=In2OutRNNHighwayNet,"
           "generator_params={'in_dim': None, 'out_dim': None, "
           "'num_hidden': 1, 'hidden_dim': 16, 'static_dim': 19, "
           "'dropout': 0.5},"
           "discriminator_params={'in_dim': 19, 'out_dim': 1, "
           "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.5, "
           "'last_sigmoid': True}")


def _vc_args(tmp_path, epochs=("1", "1", "2", "2")):
    return ["vc", VC_TINY, f"{tmp_path}/data/X", f"{tmp_path}/data/Y",
            f"{tmp_path}/ck", *epochs]


def test_vc_stage_argvs_match_train_gan_sh(tmp_path):
    """vc_demo.sh's curriculum (G warm-up, D warm-up, then the spoofing
    model and the total at the same epoch count) with the spoofing model:
    five stages, stage 5 given stage 4's discriminator."""
    args = _vc_args(tmp_path, ("50", "10", "200", "200"))
    extra = {"RUN_SPOOFING_MODEL": "1"}
    bash = _bash_argvs(tmp_path, args, extra)
    rc, port = _port_argvs(args, extra)
    assert rc == 0 and port == bash and len(port) == 5
    assert port[-1][-3] == (f"--checkpoint-r={tmp_path}/ck/spoofing_model/"
                            "checkpoint_epoch200_Discriminator.pth")


def test_vc_curriculum_five_stages_on_cpu(tmp_path):
    """All five stages of the vc bundle: the spoofing model trains against
    the baseline generator, and the adversarial stage reads it as its
    reference discriminator and logs the spoofing rate, a share of frames."""
    make_vc(str(tmp_path / "data"), 16, 19)
    args = _vc_args(tmp_path) + ["--device", "cpu"]
    assert curriculum.main(args, env=_env({"RUN_SPOOFING_MODEL": "1"})) == 0
    ck = tmp_path / "ck"
    for path in ("baseline/checkpoint_epoch2_Generator.pth",
                 "gan/checkpoint_epoch1_Generator.pth",
                 "gan/checkpoint_epoch1_Discriminator.pth",
                 "gan/checkpoint_epoch2_Generator.pth",
                 "spoofing_model/checkpoint_epoch2_Discriminator.pth",
                 "gan/checkpoint_epoch2_Discriminator.pth"):
        assert exists(ck / path), path
    rows = [json.loads(line) for line in
            (ck / "gan" / "log" / "scalars.jsonl").read_text().splitlines()]
    assert rows and all(math.isfinite(r["value"]) for r in rows)
    spoof = [r for r in rows if r["tag"].endswith("spoofing rate")]
    assert {r["tag"] for r in spoof} == {"train spoofing rate",
                                         "test spoofing rate"}
    assert all(0 <= r["value"] <= 1 for r in spoof)
    assert {r["tag"] for r in rows} >= {"train mcd metric",
                                        "train loss_adv loss"}
