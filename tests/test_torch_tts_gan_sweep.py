"""tools/torch_tts_gan_sweep.py (the TTS GAN knob sweep on the port) against
tools/tts_gan_sweep.py (the JAX package's), on the CPU:

  * (a) the same points, epochs, warm-up and base hparams, and for every
    point and seed the same stages with the same flags: both tools' main
    run with their stage runners recording (nothing trains), the port's
    argv equal to the JAX tool's train.py command without its program
    (the port's runner adds ``--device``), paths compared after mapping
    the port's per-seed directory onto the JAX tool's layout; each stage
    runs under its seed;
  * (b) ``eval_acoustic`` of both tools on one JAX checkpoint file (a 2x32
    bidirectional SRU from JAX ``init``, written by the JAX package's
    ``save_checkpoint``; the port reads it with its flax-msgpack reader)
    over a 10-utterance ``make_tts_corpus`` and its features: every value
    equal to its rounding, within one unit of the last digit kept;
  * (c) the port's tool end to end on ``--device cpu`` at a tiny size (the
    module's constants shrunk: 3 epochs, G warm-up 1, a 2x32 generator),
    one point: finite rows stamped ``device`` cpu; ``--device cuda``
    without a card fails before anything trains;
  * (d) the committed docs/tts_gan_sweep_torch.json from the H100: every
    point at seed 1234 and the five rows of the JAX file's @250 points at
    seeds 1 and 2, every value finite, every row from ``cuda`` on a named
    card, one fixtures blob, and the baseline's test MCD at every seed
    within tests/test_results_dossier.py's ceiling rule (the JAX reading
    +15%).

Imports of the JAX package and the JAX tool are allowed in this file only.
"""

import json
import math
import os
import sys
from os.path import dirname, exists, join
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gantts_tpu.models import create_model as jax_create
from gantts_tpu.train.checkpoint import save_checkpoint as jax_save
from gantts_tpu.train.step import TrainState
from gantts_tpu_torch import hparams
from gantts_tpu_torch.train import loop
from gantts_tpu_torch.train.setup import load_arrays, prepare_tts
from tools import torch_tts_gan_sweep as sweep
from tools import tts_gan_sweep as jax_sweep

torch.set_num_threads(1)

REPO = dirname(dirname(os.path.abspath(__file__)))
COMMITTED = join(REPO, "docs", "tts_gan_sweep_torch.json")
JAX_FILE = join(REPO, "docs", "tts_gan_sweep.json")
N_UTTS = 10
TINY_G = dict(in_dim=None, out_dim=None, num_hidden=2, hidden_dim=32,
              bidirectional=True, dropout=0.0, use_relu=1, rnn_dropout=0.0,
              last_sigmoid=False)
TINY_D = ("discriminator_params={'in_dim': None, 'out_dim': 1, "
          "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.0, "
          "'last_sigmoid': True}")
# the JAX file's points at 250 utterances, which the port runs at 3 seeds
FIVE = ("baseline", "anchor_wd1", "wd0.3", "lr3e-3", "wd0.3_lr3e-3")
FAKE_EVAL = {"modspec_hi_band_deficit_db": 2.0, "gv_ratio": 1.0,
             "test_mcd_db": 3.0}


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """A 10-utterance corpus and its features, made by the port tool's own
    ``prepare`` (one feature process), with the normalization stats that the
    training command line saves beside them: (root of --num-utts 10,
    features)."""
    root = str(tmp_path_factory.mktemp("sweep") / f"n{N_UTTS}")
    with mock.patch.object(sweep, "FEATURE_WORKERS", 1):
        data = sweep.prepare(root, N_UTTS)
    X, Y, lengths = load_arrays(join(data, "X_acoustic"),
                                join(data, "Y_acoustic"))
    prepare_tts(X, Y, lengths, hparams.tts_acoustic.copy(), data)
    return root, data


def test_settings_are_the_jax_tools():
    assert sweep.POINTS == jax_sweep.POINTS
    assert len(sweep.POINTS) == 13
    assert (sweep.EPOCHS, sweep.G_WARMUP, sweep.HP_BASE) == (
        jax_sweep.EPOCHS, jax_sweep.G_WARMUP, jax_sweep.HP_BASE)


def _jax_stage_commands(root, monkeypatch):
    """The JAX tool's main at --num-utts 250 with its runner recording:
    each stage's train.py command without the program."""
    base = join(root, "n250")
    os.makedirs(join(base, "slt250"))
    os.makedirs(join(base, "data", "X_acoustic"))
    cmds = []
    monkeypatch.setattr(sys, "argv", [
        "tts_gan_sweep.py", f"--root={root}", "--num-utts=250",
        f"--out={root}/out.json"])
    with mock.patch.object(jax_sweep, "sh",
                           lambda cmd, cwd, timeout=3600: cmds.append(cmd)), \
            mock.patch.object(jax_sweep, "eval_acoustic",
                              lambda *a, **k: dict(FAKE_EVAL)), \
            mock.patch.object(jax_sweep, "final_scalar", lambda *a: 3.5):
        jax_sweep.main()
    assert all(c[:2] == [sys.executable, join(REPO, "train.py")]
               for c in cmds)
    return [c[2:] for c in cmds]


def _port_stage_argvs(root, seeds):
    """The port tool's main on the same settings with its runner recording:
    (seed in effect, device, argv) of each stage."""
    base = join(root, "n250")
    os.makedirs(join(base, "slt250"))
    os.makedirs(join(base, "data", "X_acoustic"))
    runs = []

    def record(argv, device):
        runs.append((loop.train_loop.keywords["seed"], device, argv))
        return 0.0

    with mock.patch.object(sweep, "run_stage", record), \
            mock.patch.object(sweep, "eval_acoustic",
                              lambda *a, **k: dict(FAKE_EVAL)), \
            mock.patch.object(sweep, "final_scalar", lambda *a: 3.5):
        assert sweep.main([f"--root={root}", "--num-utts=250",
                           f"--seeds={seeds}", "--device=cpu",
                           f"--out={root}/out.json", "--out-md="]) == 0
    with open(join(root, "out.json")) as f:
        return runs, json.load(f)


def test_stage_argvs_are_the_jax_tools(tmp_path, monkeypatch):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _jax_stage_commands(jax_root, monkeypatch)
    assert len(want) == 2 + 2 * 13  # the shared prefix, then 2 a point
    runs, out = _port_stage_argvs(port_root, "1234,1")
    assert len(runs) == 2 * len(want)
    for i, seed in enumerate((1234, 1)):
        got = []
        for run_seed, device, argv in runs[i * len(want):(i + 1) * len(want)]:
            assert (run_seed, device) == (seed, "cpu")
            got.append([a.replace(join(port_root, "n250", f"seed{seed}"),
                                  join(jax_root, "n250"))
                        .replace(port_root, jax_root) for a in argv])
        assert got == want
    for seed in (1234, 1):
        for name in ("baseline",) + tuple(n for n, _ in sweep.POINTS):
            row = out[f"{name}@250/seed{seed}"]
            assert row["seed"] == seed and row["device"] == "cpu"
    assert out["_provenance"]["corpus"] == (
        "tests/fixtures.py make_tts_corpus (speech-like, "
        "articulation_scatter=0.06 + per-utterance speaker scatter)")


def test_eval_acoustic_matches_jax(features, tmp_path):
    _, data = features
    in_dim = np.load(join(data, "X_acoustic_data_min.npy")).shape[-1]
    out_dim = np.load(join(data, "Y_acoustic_data_mean.npy")).shape[-1]
    model = jax_create("SRURNN", **dict(TINY_G, in_dim=in_dim,
                                        out_dim=out_dim))
    variables = model.init(jax.random.PRNGKey(3),
                           jnp.zeros((1, 8, in_dim), jnp.float32),
                           jnp.asarray([8], jnp.int32))
    path = jax_save(TrainState(params=variables, opt_state={}), 1,
                    str(tmp_path), "Generator")
    extra = f"generator_params={TINY_G!r}"
    want = jax_sweep.eval_acoustic(path, data, extra)
    got = sweep.eval_acoustic(path, data, extra, device="cpu")
    assert sorted(got) == sorted(want)
    units = {"modspec_hi_band_deficit_db": 1e-3, "gv_ratio": 1e-4,
             "test_mcd_db": 1e-4}
    for key, unit in units.items():
        assert math.isfinite(got[key]), (key, got)
        assert abs(got[key] - want[key]) <= unit * (1 + 1e-6), (key, got,
                                                                want)


def test_sweep_end_to_end_on_cpu(features, monkeypatch):
    root, _ = features
    monkeypatch.setattr(sweep, "EPOCHS", 3)
    monkeypatch.setattr(sweep, "G_WARMUP", 1)
    monkeypatch.setattr(sweep, "HP_BASE",
                        f"batch_size=4,generator_params={TINY_G!r},{TINY_D}")
    out = join(dirname(root), "sweep.json")
    md = join(dirname(root), "RESULTS.md")
    with open(md, "w") as f:
        f.write("# results\n\n" + sweep.SECTION + "\n\nan older run\n")
    assert sweep.main([f"--root={dirname(root)}", f"--num-utts={N_UTTS}",
                       "--points=anchor_wd1", "--device=cpu",
                       f"--out={out}", f"--out-md={md}"]) == 0
    with open(out) as f:
        rows = json.load(f)
    with open(md) as f:
        text = f.read()
    assert text.startswith("# results\n\n" + sweep.SECTION)
    assert "an older run" not in text and text.count(sweep.SECTION) == 1
    assert "| anchor_wd1 | w_d=1.0, d_warmup=4 | no anchor_wd1@10 row | " in text
    assert sorted(rows) == ["_provenance", f"anchor_wd1@{N_UTTS}/seed1234",
                            f"baseline@{N_UTTS}/seed1234"]
    point = rows[f"anchor_wd1@{N_UTTS}/seed1234"]
    assert point["knobs"] == dict(w_d=1.0, d_warmup=4)
    for key in (f"baseline@{N_UTTS}/seed1234",
                f"anchor_wd1@{N_UTTS}/seed1234"):
        row = rows[key]
        assert row["device"] == "cpu" and row["seed"] == 1234
        assert row["card"] is None and row["seconds"] > 0
        for k in ("modspec_hi_band_deficit_db", "gv_ratio", "test_mcd_db",
                  "train_mcd_db"):
            assert math.isfinite(row[k]), (key, k, row)
    assert math.isfinite(point["deficit_ratio_vs_baseline"])
    gan = join(root, "seed1234", "ckpt", "p_anchor_wd1", "gan")
    assert exists(join(gan, "checkpoint_epoch4_Discriminator.pth"))
    assert exists(join(gan, "checkpoint_epoch3_Generator.pth"))


def test_cuda_without_a_card_fails(tmp_path, monkeypatch):
    """No fallback: ``--device cuda`` without CUDA stops before anything is
    made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        sweep.main([f"--root={tmp_path}", "--points=anchor_wd1",
                    f"--out={tmp_path}/out.json", "--out-md="])
    assert os.listdir(tmp_path) == []


def _numbers(row):
    return [v for k, v in row.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]


def test_committed_sweep_from_the_card():
    with open(COMMITTED) as f:
        rows = json.load(f)
    with open(JAX_FILE) as f:
        jax_rows = json.load(f)
    prov = rows.pop("_provenance")
    want = {f"{name}@250/seed1234" for name in
            ("baseline",) + tuple(n for n, _ in sweep.POINTS)}
    want |= {f"{name}@250/seed{seed}" for name in FIVE for seed in (1, 2)}
    assert want <= set(rows), sorted(want - set(rows))
    assert {r["fixtures_blob"] for r in rows.values()} == {
        prov["fixtures_blob"]}
    for key, row in rows.items():
        name, _, seed = key.partition("/seed")
        assert row["seed"] == int(seed), key
        assert row["device"] == "cuda" and row["card"], (key, row)
        assert row["power_limit"], (key, row)
        assert all(math.isfinite(v) for v in _numbers(row)), (key, row)
        if not name.startswith("baseline"):
            assert row["knobs"] == dict(sweep.POINTS)[name.split("@")[0]]
            assert math.isfinite(row["deficit_ratio_vs_baseline"])
    ceiling = 1.15 * jax_rows["baseline@250"]["test_mcd_db"]
    for seed in (1234, 1, 2):
        assert rows[f"baseline@250/seed{seed}"]["test_mcd_db"] <= ceiling


def test_results_md_renders_the_committed_sweep():
    """RESULTS_torch.md's sweep section is the committed JSON's rendering,
    beside the JAX file's rows."""
    with open(COMMITTED) as f:
        rows = json.load(f)
    with open(JAX_FILE) as f:
        jax_rows = json.load(f)
    with open(join(REPO, "RESULTS_torch.md")) as f:
        text = f.read()
    section = text[text.index(sweep.SECTION):]
    assert section == sweep.render_md(rows, jax_rows)
    for name in FIVE[1:]:
        assert f"| {name} | " in section


def test_dossier_rendering_keeps_the_sweep_section(tmp_path):
    """tools/torch_quality_dossier.py rewrites RESULTS_torch.md from its own
    files and keeps the sweep's section."""
    from tools import torch_quality_dossier as dossier

    path = str(tmp_path / "RESULTS_torch.md")
    dossier.replace_section(path, sweep.SECTION,
                            sweep.SECTION + "\n\n| point | a row |\n")
    dossier.render_md({"workload": {}, "_provenance": {}}, {}, path)
    with open(path) as f:
        text = f.read()
    assert text.startswith("# RESULTS_torch")
    assert text.endswith(sweep.SECTION + "\n\n| point | a row |\n")


def test_replace_section_keeps_the_other_sections(tmp_path):
    """The one writer of RESULTS_torch.md's sections rewrites the section
    under its heading, up to the next heading of that level, and nothing
    else; a file without the section gets it at its end."""
    from tools.torch_quality_dossier import read_section, replace_section

    path = str(tmp_path / "RESULTS.md")
    with open(path, "w") as f:
        f.write("# results\n\n## a\n\nrow a\n\n## b\n\nold b\n"
                "### b.1\n\nold b.1\n\n## c\n\nrow c\n")
    replace_section(path, "## b", "## b\n\nnew b\n")
    with open(path) as f:
        assert f.read() == ("# results\n\n## a\n\nrow a\n\n## b\n\nnew b"
                            "\n\n## c\n\nrow c\n")
    replace_section(path, "## d", "## d\n\nrow d\n")
    assert read_section(path, "## d") == "## d\n\nrow d\n"
    assert read_section(path, "## c") == "## c\n\nrow c\n\n"
    assert read_section(path, "## e") == ""
