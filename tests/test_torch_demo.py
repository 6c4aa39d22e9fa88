"""The port's demo commands (``python -m gantts_tpu_torch.demo vc|tts``)
against the repository's vc_demo.sh and tts_demo.sh, and the port's
dossier tool.

Command-line parity: each script runs with ``PYTHON`` set to a recorder
(train_gan.sh inherits it, so every train.py stage is recorded too), and the
port's command runs with each step's ``main`` and the training ``main``
replaced by recorders.  The programs must be called in the same order with
the same command lines, once the port's ``--device`` is dropped: at the
scripts' defaults, with every knob set, and with knobs set but empty (which
take their defaults).

End to end on the CPU: the vc demo on a tiny parallel corpus from
tests/fixtures.py with a narrow generator (``HPARAMS_EXTRA``) writes both
generators, the wavs of both evaluations and analysis.json files whose
values are finite.
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
from fixtures import make_arctic_vc_corpus

from gantts_tpu_torch import demo

REPO = dirname(dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

KNOWN = sorted({k for knobs in demo.KNOBS.values() for k in knobs}
               | {"W_D", "ADV_HPARAMS", "RUN_BASELINE",
                  "RUN_GENERATOR_WARMUP", "RUN_DISCRIMINATOR_WARMUP",
                  "RUN_SPOOFING_MODEL", "RUN_ADVERSARIAL"})
SCRIPTS = {"vc": "vc_demo.sh", "tts": "tts_demo.sh"}
STEPS = {"vc": ("prepare_features_vc", "evaluation_vc"),
         "tts": ("prepare_features_tts", "evaluation_tts")}


def _env(extra):
    env = {k: v for k, v in os.environ.items() if k not in KNOWN}
    env.update(extra)
    return env


def _shell_calls(tmp_path, which, extra):
    recorder, log = tmp_path / "recorder.py", tmp_path / "calls.jsonl"
    recorder.write_text(
        "import json, os, sys\n"
        "with open(os.environ['ARGV_LOG'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    env = _env(extra)
    env.update(PYTHON=f"{sys.executable} {recorder}", ARGV_LOG=str(log))
    proc = subprocess.run(
        ["bash", join(REPO, SCRIPTS[which]), "exp1", "/corpus/root"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert all(os.path.dirname(c[0]) == REPO for c in calls)
    return [(os.path.basename(c[0]).removesuffix(".py"), c[1:])
            for c in calls]


def _port_calls(which, extra, rcs=None):
    calls = []

    def recorder(name):
        def record(argv, **_):
            calls.append((name, list(argv)))
            return (rcs or {}).get(len(calls), 0)
        return record
    prepare, evaluate = STEPS[which]
    with mock.patch(f"gantts_tpu_torch.{prepare}.main", recorder(prepare)), \
            mock.patch("gantts_tpu_torch.train.__main__.main",
                       recorder("train")), \
            mock.patch(f"gantts_tpu_torch.{evaluate}.main",
                       recorder(evaluate)):
        rc = demo.main([which, "exp1", "/corpus/root", "--device", "cpu"],
                       env=_env(extra))
    for name, argv in calls:
        if name != prepare:
            assert argv[-1] == "--device=cpu", (name, argv)
    return rc, [(name, [a for a in argv if a != "--device=cpu"])
                for name, argv in calls]


KNOBS_SET = {
    "vc": {"MAX_FILES": "7", "TOTAL_EPOCH": "4", "G_WARMUP": "2",
           "D_WARMUP": "1", "HPARAMS_EXTRA": "batch_size=3",
           "EVAL_WORKERS": "2", "RUN_SPOOFING_MODEL": "1"},
    "tts": {"DURATION_EPOCHS": "5", "ACOUSTIC_EPOCHS": "4", "G_WARMUP": "2",
            "D_WARMUP": "1", "HPARAMS_EXTRA": "batch_size=8",
            "EVAL_WORKERS": "3", "W_D": "0.2",
            "ADV_HPARAMS": "optimizer_d_params={'lr': 0.001, "
                           "'weight_decay': 1e-7}"},
}


@pytest.mark.parametrize("which,extra,n_calls", [
    ("vc", {}, 7),
    ("vc", KNOBS_SET["vc"], 8),
    ("vc", {"MAX_FILES": "", "TOTAL_EPOCH": "", "EVAL_WORKERS": ""}, 7),
    ("tts", {}, 11),
    ("tts", KNOBS_SET["tts"], 11),
    ("tts", {"DURATION_EPOCHS": "", "HPARAMS_EXTRA": "", "G_WARMUP": ""},
     11),
], ids=["vc-defaults", "vc-knobs", "vc-empty", "tts-defaults", "tts-knobs",
        "tts-empty"])
def test_demo_calls_match_the_shell_scripts(tmp_path, which, extra,
                                            n_calls):
    """The same programs in the same order with the same command lines:
    features, each curriculum stage, both evaluations."""
    shell = _shell_calls(tmp_path, which, extra)
    rc, port = _port_calls(which, extra)
    assert rc == 0
    assert port == shell and len(port) == n_calls


def test_a_failing_step_stops_the_demo():
    """A step that exits non-zero ends the demo with its code, as set -e
    does: the second training stage returns 4, and no evaluation runs."""
    rc, calls = _port_calls("vc", {}, rcs={3: 4})
    assert rc == 4 and [name for name, _ in calls] == [
        "prepare_features_vc", "train", "train"]


VC_TINY = ("generator_params={'in_dim': None, 'out_dim': None, "
           "'num_hidden': 1, 'hidden_dim': 16, 'static_dim': 59, "
           "'dropout': 0.5},"
           "discriminator_params={'in_dim': 59, 'out_dim': 1, "
           "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.5, "
           "'last_sigmoid': True}")


def _numbers(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, list):
        for v in value:
            yield from _numbers(v)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield value


def test_vc_demo_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The vc demo on 8 parallel pairs, 2 epochs, a 1x16 generator: both
    generators, the same wavs of both evaluations (the eval and test
    splits), analysis.json with finite values.  The feature command
    analyses in this process (one CPU)."""
    corpus = str(tmp_path / "arctic")
    make_arctic_vc_corpus(corpus, num=8, articulation_scatter=0.06)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    env = _env({"MAX_FILES": "8", "TOTAL_EPOCH": "2", "G_WARMUP": "1",
                "D_WARMUP": "1", "EVAL_WORKERS": "1",
                "HPARAMS_EXTRA": VC_TINY})
    assert demo.main(["vc", "t", corpus, "--device", "cpu"], env=env) == 0
    written = {}
    for kind in ("baseline", "gan"):
        assert exists(tmp_path / f"checkpoints/vc_t/{kind}/"
                      "checkpoint_epoch2_Generator.pth")
        out = tmp_path / f"generated/vc_t_{kind}"
        written[kind] = {split: sorted(p.name for p in out.glob(
            f"{split}/*.wav")) for split in ("eval", "test")}
        assert all(written[kind].values()), written
        report = json.loads((out / "analysis.json").read_text())
        values = list(_numbers(report))
        assert values and all(math.isfinite(v) for v in values)
        assert 0 < report["gv_ratio"]
    assert written["baseline"] == written["gan"]


def test_dossier_markdown_without_jax(tmp_path):
    """tools/torch_quality_dossier.py, in a fresh interpreter, renders the
    markdown from a results file and a seeds file (each seed's GV beside
    the JAX dossier's one-seed verdict), and loads neither JAX nor the JAX
    package."""
    row = {"train_mcd_db": 3.0, "test_mcd_db": 3.5, "gv_ratio": 0.95,
           "modspec_hi_band_deficit_db": 2.0}
    results = {"workload": {"device": "cuda"}, "_provenance": {"seed": 1},
               "vc_in2out_baseline": row, "vc_in2out_gan": row}
    seeds = {"rows": [dict(package="port", half="vc", seed=1,
                           device="cuda", card="c", power_limit="1 W",
                           seconds=1.0, vc_in2out_baseline=row,
                           vc_in2out_gan=dict(row, gv_ratio=0.92))]}
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {join(REPO, 'tools')!r})\n"
        "import torch_quality_dossier as d\n"
        f"d.render_md(json.loads({json.dumps(results)!r}), "
        f"json.loads({json.dumps(seeds)!r}), {str(tmp_path / 'r.md')!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gantts_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
    md = (tmp_path / "r.md").read_text()
    assert "| vc_in2out_gan | train_mcd_db 3.0 |" in md
    # |1 - 0.92| = 0.08 > max(|1 - 0.95| + 0.02, 0.05)
    assert "| vc | port | 1 | cuda | 0.95 | 0.92 | fail |" in md
