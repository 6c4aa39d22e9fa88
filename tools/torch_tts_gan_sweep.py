#!/usr/bin/env python3
"""Sweep the TTS acoustic GAN curriculum's knobs on the port (counterpart of
tools/tts_gan_sweep.py, whose points, epochs, stages, evaluation and row
format it keeps), at one or more training seeds.

The knobs are those the curriculum exposes (reference train_gan.sh:48-108
stage semantics):

  * w_d               stage-5 adversarial weight
  * d_warmup          discriminator-warmup epochs (stage 3 length)
  * lr / g_lr / d_lr  stage-5 learning rates (both optimizers are reset at
                      the stage boundary by --reset_optimizers)
  * nepoch            the adversarial stage's last epoch (it restarts at
                      G_WARMUP)

For each seed the shared prefix (the MGE baseline, EPOCHS epochs with
--w_d=0, and the G warm-up, G_WARMUP epochs) is trained once, on one corpus
and one set of features that every seed shares (tests/fixtures.py
``make_tts_corpus``, then the port's ``prepare_features_tts``).  Each point
then reruns the D warm-up (--discriminator-warmup, its d_warmup epochs) and
the adversarial stage from the warm-up's generator, and is scored by an
acoustic-model-only evaluation on the held-out test split: natural
linguistic input at natural durations -> the generator on ``--device`` in
the bundle's float32 (``synthesis.model_forward``) -> per-stream MLPG
statics -> the high-band modulation-spectrum deficit and the GV ratio
against the natural mgc statics, and the per-utterance MCD; plus the last
train MCD the stage logged.

Every stage is the port's training command line run in this process
(``gantts_tpu_torch.train.__main__.main``, with the curriculum's rule for
its exit code), on the flags that the JAX tool gives train.py, plus
``--device``; a stage that fails raises.  The seed is bound in this
process, as tools/torch_quality_dossier.py binds it (``training_seed``):
no command line gains a seed flag.

Each row goes into ``--out`` (docs/tts_gan_sweep_torch.json) under
``<point>[@<num-utts>]/seed<seed>`` (``@N`` unless N is 100, as the JAX
tool names its rows), in the JAX file's row format plus the seed, the
device, the card's name and power limit as nvidia-smi gives them, and the
seconds of the stages and evaluation that made the row; rows already in
the file are kept unless rewritten.  Where ``--out-md`` names a markdown
file (RESULTS_torch.md), its sweep section is then rendered from that
file, and nothing else in it changes: each row beside the JAX file's row
of the same name (docs/tts_gan_sweep.json), the port's range over seeds,
the order of the deficit ratio in both and the rows whose GV overshoots
1.05.  tests/test_torch_tts_gan_sweep.py gates the committed JSON.

usage:
    python tools/torch_tts_gan_sweep.py [--root DIR] [--points a,b]
        [--num-utts 100] [--seeds 1234[,1,...]] [--device cuda|cpu]
        [--out docs/tts_gan_sweep_torch.json] [--out-md RESULTS_torch.md]

This tool imports torch, the port, tests/fixtures.py (numpy only) and
tools/torch_quality_dossier.py: neither JAX nor the JAX package nor the
JAX tools.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from os.path import dirname, exists, join

import numpy as np

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.torch_quality_dossier import (  # noqa: E402
    SWEEP_SECTION as SECTION,
    replace_section,
    blob_id,
    card_line,
    training_seed,
)

EPOCHS = 30          # baseline + adversarial total (dossier setting)
G_WARMUP = 8
HP_BASE = "batch_size=8"
FEATURE_WORKERS = 0  # prepare_features_tts's processes (0: one per CPU)

# The JAX tool's grid: one anchor (its round-3 dossier setting) and
# one-knob-at-a-time variations.  Points are (name, dict) with keys w_d,
# d_warmup, lr, g_lr, d_lr, nepoch.
POINTS = [
    ("anchor_wd1", dict(w_d=1.0, d_warmup=4)),
    ("wd0.3", dict(w_d=0.3, d_warmup=4)),
    ("wd3", dict(w_d=3.0, d_warmup=4)),
    ("dwarm8", dict(w_d=1.0, d_warmup=8)),
    ("lr3e-3", dict(w_d=1.0, d_warmup=4, lr=0.003)),
    ("lr1e-3", dict(w_d=1.0, d_warmup=4, lr=0.001)),
    ("wd0.3_lr3e-3", dict(w_d=0.3, d_warmup=4, lr=0.003)),
    ("long_adv", dict(w_d=1.0, d_warmup=4, nepoch=60)),
    ("dlr3e-3", dict(w_d=1.0, d_warmup=4, d_lr=0.003)),
    ("dlr1e-3", dict(w_d=1.0, d_warmup=4, d_lr=0.001)),
    ("wd0.3_dlr1e-3", dict(w_d=0.3, d_warmup=4, d_lr=0.001)),
    ("wd3_lr1e-3", dict(w_d=3.0, d_warmup=4, lr=0.001)),
    ("lr1e-3_long", dict(w_d=1.0, d_warmup=4, lr=0.001, nepoch=60)),
]
CORPUS_TEXT = ("tests/fixtures.py make_tts_corpus (speech-like, "
               "articulation_scatter=0.06 + per-utterance speaker scatter)")


def train_argv(data, ckpt_dir, nepoch, hparams_extra="", **flags):
    """The training command line's arguments for one stage: the JAX tool's
    ``train_cmd`` without its program."""
    argv = ["--hparams_name=tts_acoustic",
            f"--hparams={HP_BASE},nepoch={nepoch}"
            + ("," + hparams_extra if hparams_extra else ""),
            f"--checkpoint-dir={ckpt_dir}",
            f"--log-event-path={ckpt_dir}/log"]
    for k, v in flags.items():
        flag = "--" + k.replace("_", "-") if k in (
            "checkpoint_g", "checkpoint_d", "discriminator_warmup") \
            else "--" + k
        argv.append(flag if v is True else f"{flag}={v}")
    return argv + [join(data, "X_acoustic"), join(data, "Y_acoustic")]


def point_hparams(knobs):
    """A point's optimizer overrides.  weight_decay stays at the bundle's
    default, as in the JAX tool (there, dropping it changes the optax
    chain, and the G warm-up's optimizer state no longer loads)."""
    parts = []
    g_lr = knobs.get("lr", knobs.get("g_lr"))
    d_lr = knobs.get("lr", knobs.get("d_lr"))
    if g_lr is not None:
        parts.append(f"optimizer_g_params={{'lr': {g_lr}, "
                     f"'weight_decay': 1e-7}}")
    if d_lr is not None:
        parts.append(f"optimizer_d_params={{'lr': {d_lr}, "
                     f"'weight_decay': 1e-7}}")
    return ",".join(parts)


def run_stage(argv, device):
    """One stage through the port's training command line in this process;
    raises unless it exits 0.  Returns its seconds."""
    from gantts_tpu_torch.curriculum import _run_stage
    from gantts_tpu_torch.train.__main__ import main as train_main

    t0 = time.perf_counter()
    rc = _run_stage(train_main, argv + [f"--device={device}"])
    if rc != 0:
        raise RuntimeError(f"training stage {argv} exited {rc}")
    return time.perf_counter() - t0


def final_scalar(log_dir, tag):
    vals = []
    with open(join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if row["tag"] == tag:
                vals.append(row["value"])
    return round(float(vals[-1]), 4) if vals else None


def eval_acoustic(ckpt_path, data_dir, hparams_extra="", device="cuda"):
    """Acoustic-model-only quality on the held-out test split: natural
    linguistic input at natural durations -> mgc statics -> modspec
    hi-band deficit + GV ratio vs natural, plus per-utterance MCD."""
    from gantts_tpu_torch import hparams
    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.data import NPYDataSource
    from gantts_tpu_torch.models import create_model
    from gantts_tpu_torch.synthesis import gen_parameters, model_forward
    from gantts_tpu_torch.train.checkpoint import load_checkpoint
    from gantts_tpu_torch.utils.analysis import _hi_band_db, global_variance

    hp = hparams.tts_acoustic.copy()
    hp.parse(HP_BASE + ("," + hparams_extra if hparams_extra else ""))
    X_min = np.load(join(data_dir, "X_acoustic_data_min.npy"))
    X_max = np.load(join(data_dir, "X_acoustic_data_max.npy"))
    Y_mean = np.load(join(data_dir, "Y_acoustic_data_mean.npy"))
    Y_std = np.sqrt(np.load(join(data_dir, "Y_acoustic_data_var.npy")))
    if hp.generator_params["in_dim"] is None:
        hp.generator_params["in_dim"] = X_min.shape[-1]
    if hp.generator_params["out_dim"] is None:
        hp.generator_params["out_dim"] = Y_mean.shape[-1]
    model = create_model(hp.generator, compute_dtype=hp.compute_dtype,
                         device=device, **hp.generator_params)
    state_dict, _, _ = load_checkpoint(ckpt_path)
    model.load_state_dict(state_dict, strict=True)

    K = len(hp.windows)
    sd = hp.stream_sizes[0] // K
    xs = NPYDataSource(join(data_dir, "X_acoustic"),
                       train=False, test=True).collect_files()
    gen_mgc, nat_mgc, mcds = [], [], []
    for xf in xs:
        x = np.load(xf)
        y_nat = np.load(xf.replace("X_acoustic", "Y_acoustic"))
        x = P.minmax_scale(x, X_min, X_max,
                           feature_range=(0.01, 0.99)).astype(np.float32)
        y_hat = model_forward(model, x, hp)
        mgc, _, _, _ = gen_parameters(
            np.asarray(y_hat, np.float64), Y_mean, Y_std, hp)
        gen_mgc.append(mgc)
        nat_mgc.append(y_nat[:, :sd])
        d = mgc[:, 1:] - y_nat[:, 1:sd]
        mcds.append(float(np.mean(
            10.0 / np.log(10.0) * np.sqrt(2.0 * np.sum(d * d, axis=1)))))
    modfs = 1000.0 / hp.frame_period
    deficit = (_hi_band_db(nat_mgc, modfs) - _hi_band_db(gen_mgc, modfs))
    gv = float(np.mean(global_variance(gen_mgc))
               / max(np.mean(global_variance(nat_mgc)), 1e-30))
    return {"modspec_hi_band_deficit_db": round(deficit, 3),
            "gv_ratio": round(gv, 4),
            "test_mcd_db": round(float(np.mean(mcds)), 4)}


def prepare(root, n):
    """The corpus and its features under ``root`` (each made once): the
    features' directory."""
    corpus = join(root, f"slt{n}")
    data = join(root, "data")
    if not os.path.isdir(corpus):
        # by its directory: an installed package named "tests" may shadow
        sys.path.insert(0, join(REPO, "tests"))
        from fixtures import make_tts_corpus

        make_tts_corpus(corpus, num=n)
    if not exists(join(data, "X_acoustic")):
        from gantts_tpu_torch.prepare_features_tts import main as prep_main

        rc = prep_main([corpus, f"--dst_dir={data}",
                        f"--workers={FEATURE_WORKERS}"])
        if rc != 0:
            raise RuntimeError(f"prepare_features_tts exited {rc}")
    return data


def train_prefix(data, shared, device):
    """The seed's MGE baseline and G warm-up under ``shared`` (each trained
    unless its last checkpoint is there): (baseline dir, warm-up dir,
    seconds of each)."""
    base_ck, gw_ck = join(shared, "baseline"), join(shared, "gwarm")
    secs = {}
    for ck, nepoch in ((base_ck, EPOCHS), (gw_ck, G_WARMUP)):
        secs[ck] = 0.0
        if not exists(join(ck, f"checkpoint_epoch{nepoch}_Generator.pth")):
            shutil.rmtree(ck, ignore_errors=True)
            secs[ck] = run_stage(train_argv(data, ck, nepoch, w_d=0,
                                            mge_w=1.0), device)
    return base_ck, gw_ck, secs[base_ck], secs[gw_ck]


def train_point(data, pdir, gw_ck, knobs, extra, device):
    """A point's D warm-up and adversarial stage in ``pdir`` from the G
    warm-up's checkpoints (unless its last generator is there): (that
    generator, seconds)."""
    nepoch = knobs.get("nepoch", EPOCHS)
    d_warm = knobs["d_warmup"]
    final_g = join(pdir, f"checkpoint_epoch{nepoch}_Generator.pth")
    secs = 0.0
    if not exists(final_g):
        shutil.rmtree(pdir, ignore_errors=True)
        os.makedirs(pdir)
        for kind in ("Generator", "Discriminator"):
            src = join(gw_ck, f"checkpoint_epoch{G_WARMUP}_{kind}.pth")
            if exists(src):
                shutil.copy(src, pdir)
        g_warm = join(pdir, f"checkpoint_epoch{G_WARMUP}_Generator.pth")
        secs += run_stage(train_argv(
            data, pdir, d_warm, extra, checkpoint_g=g_warm,
            discriminator_warmup=True, w_d=1.0, restart_epoch=0), device)
        secs += run_stage(train_argv(
            data, pdir, nepoch, extra, checkpoint_g=g_warm,
            checkpoint_d=join(
                pdir, f"checkpoint_epoch{d_warm}_Discriminator.pth"),
            reset_optimizers=True, restart_epoch=G_WARMUP,
            w_d=knobs["w_d"]), device)
    return final_g, secs


METRICS = ("deficit_ratio_vs_baseline", "gv_ratio", "test_mcd_db")


def _cell(row, missing="not run"):
    """deficit ratio, GV, test MCD of a row (the baseline has no ratio)."""
    if row is None:
        return missing
    return ", ".join(str(row.get(k, "-")) for k in METRICS)


def _ranked(rows, names):
    """``names``, each with a row in ``rows``, by deficit ratio, lowest
    first."""
    return sorted(names, key=lambda n: rows[n]["deficit_ratio_vs_baseline"])


def _order(rows, names):
    return " < ".join(f"{n} {rows[n]['deficit_ratio_vs_baseline']}"
                      for n in _ranked(rows, names))


def render_md(results, jax_results, suffix="@250"):
    """The sweep's markdown section: each point's row of the port at each
    seed beside the JAX file's row of the same name, the port's range over
    the seeds it ran at, the order of the deficit ratio in both, and the
    rows whose GV overshoots 1.05."""
    seeds = sorted({r["seed"] for k, r in results.items()
                    if k != "_provenance" and suffix in k},
                   key=lambda s: (s != 1234, s))
    names = ["baseline"] + [n for n, _ in POINTS]
    port = {s: {n: results.get(f"{n}{suffix}/seed{s}") for n in names}
            for s in seeds}
    jax = {n: jax_results.get(f"{n}{suffix}") for n in names}
    first = next((r for s in seeds for r in port[s].values() if r), {})
    md = [SECTION, "",
          f"`python tools/torch_tts_gan_sweep.py --num-utts "
          f"{suffix.lstrip('@')}` on `{first.get('device')}` "
          f"({first.get('card')}, {first.get('power_limit')}), training "
          f"seeds {', '.join(map(str, seeds))}: the JAX tool's points, "
          f"stages and acoustic-only evaluation (natural durations, the 5 "
          f"held-out utterances), {EPOCHS} epochs, G warm-up {G_WARMUP}, "
          f"{HP_BASE}; rows in `docs/tts_gan_sweep_torch.json`.  The JAX "
          f"rows are `docs/tts_gan_sweep.json`'s (one run each, on a TPU).  "
          f"Each cell: deficit ratio against its seed's baseline, GV ratio, "
          f"test MCD dB.", "",
          "| point | knobs | JAX | " + " | ".join(
              f"port, seed {s}" for s in seeds) + " | port range over seeds "
          "(ratio; GV; test MCD) |",
          "|---|---|---|" + "---|" * len(seeds) + "---|"]
    for n in names:
        rows = [port[s][n] for s in seeds if port[s][n]]
        if not rows and jax[n] is None:
            continue
        span = "; ".join(
            f"{min(r[k] for r in rows)} - {max(r[k] for r in rows)}"
            for k in METRICS if k in rows[0]) if len(rows) > 1 else ""
        knobs = dict(POINTS).get(n, {})
        md.append(f"| {n} | {', '.join(f'{k}={v}' for k, v in knobs.items())}"
                  f" | {_cell(jax[n], f'no {n}{suffix} row')} | "
                  + " | ".join(_cell(port[s][n]) for s in seeds)
                  + f" | {span} |")
    both = [n for n in names[1:]
            if jax[n] and all(port[s][n] for s in seeds)]
    over = [f"{n} (seed {s}, {port[s][n]['gv_ratio']})" for n in names
            for s in seeds if port[s][n] and port[s][n]["gv_ratio"] > 1.05]
    md += ["", "Deficit ratio, lowest first, over the points both ran: "
           f"JAX {_order(jax, both)}; "
           + "; ".join(f"port, seed {s}, {_order(port[s], both)}"
                       for s in seeds) + ".", "",
           "GV above 1.05: " + (", ".join(over) or "none") + ".", ""]
    same = [s for s in seeds
            if _ranked(port[s], both) == _ranked(jax, both)]
    md += [f"The port orders these points as the JAX file does at "
           f"{len(same)} of {len(seeds)} seeds"
           + (f" ({', '.join(map(str, same))})" if same else "") + ".  "
           "W_D=0.2's neighbours (the dossier's default stage-5 weight, "
           "tools/torch_quality_dossier.py): " + "; ".join(
               f"{n} GV {min(r['gv_ratio'] for r in rows)} - "
               f"{max(r['gv_ratio'] for r in rows)} over {len(rows)} "
               f"seed(s), above 1.05 at "
               f"{sum(r['gv_ratio'] > 1.05 for r in rows)}"
               for n in ("wd0.3", "anchor_wd1")
               for rows in [[port[s][n] for s in seeds if port[s][n]]]
               if rows) + ".", ""]
    return "\n".join(md)


def write_json(path, results):
    os.makedirs(dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=join(REPO, "dossier_work", "sweep"),
                   help="working directory for the corpus, features and "
                        "checkpoints (default: dossier_work/sweep in the "
                        "repository, which git ignores)")
    p.add_argument("--points", default="",
                   help="comma list of point names (default: all)")
    p.add_argument("--num-utts", type=int, default=100, dest="num_utts",
                   help="corpus size (utterances); rows measured at other "
                        "sizes than 100 are suffixed @N")
    p.add_argument("--seeds", default="1234",
                   help="comma-separated training seeds, each with its own "
                        "shared prefix (default: 1234, the programs' "
                        "default)")
    p.add_argument("--device", default="cuda",
                   help="torch device of training and evaluation "
                        "(default: cuda)")
    p.add_argument("--out", default=join(REPO, "docs",
                                         "tts_gan_sweep_torch.json"))
    p.add_argument("--out-md", default="", dest="out_md",
                   help="markdown file (RESULTS_torch.md) whose sweep "
                        "section is rewritten from --out at the end, the "
                        "rows beside docs/tts_gan_sweep.json's (default: "
                        "none)")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available "
                         "(ask for --device cpu to run on the CPU)")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    names = [name for name, _ in POINTS]
    wanted = [s for s in args.points.split(",") if s]
    unknown = sorted(set(wanted) - set(names))
    if unknown:
        raise SystemExit(f"unknown points {unknown}; known: {names}")
    n = args.num_utts
    root = os.path.abspath(join(args.root, f"n{n}") if n != 100
                           else args.root)
    os.makedirs(root, exist_ok=True)
    suffix = f"@{n}" if n != 100 else ""
    data = prepare(root, n)

    card = card_line(args.device)
    card_name, _, power_limit = (card or "").partition(", ")
    stamp = {"device": args.device, "card": card_name or None,
             "power_limit": power_limit or None}
    fix_rev = blob_id(join(REPO, "tests", "fixtures.py"))
    results = {}
    if exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    prov = results.setdefault("_provenance", {})
    if prov.get("fixtures_blob") not in (None, fix_rev):
        print(f"NOTE: fixtures.py changed ({prov['fixtures_blob'][:10]} -> "
              f"{fix_rev[:10]}); older rows in {args.out} were measured on "
              "a different corpus (each row carries its own fixtures_blob)",
              file=sys.stderr)
    prov.update(fixtures_blob=fix_rev, corpus=CORPUS_TEXT,
                torch=torch.__version__, cuda=torch.version.cuda,
                epochs=EPOCHS, g_warmup=G_WARMUP, hparams=HP_BASE)

    for seed in seeds:
        seed_root = join(root, f"seed{seed}")
        t0 = time.perf_counter()
        with training_seed(seed):
            base_ck, gw_ck, base_s, gw_s = train_prefix(
                data, join(seed_root, "ckpt", "shared"), args.device)
        base_key = f"baseline{suffix}/seed{seed}"
        results[base_key] = {
            **eval_acoustic(
                join(base_ck, f"checkpoint_epoch{EPOCHS}_Generator.pth"),
                data, device=args.device),
            "train_mcd_db": final_scalar(join(base_ck, "log"),
                                         "train mcd metric"),
            "fixtures_blob": fix_rev,
            "seed": seed, **stamp,
            "seconds": round(time.perf_counter() - t0 - gw_s, 1),
            "g_warmup_seconds": round(gw_s, 1),
        }
        print(base_key, json.dumps(results[base_key]), flush=True)
        write_json(args.out, results)
        for name, knobs in POINTS:
            if wanted and name not in wanted:
                continue
            t0 = time.perf_counter()
            extra = point_hparams(knobs)
            with training_seed(seed):
                final_g, _ = train_point(
                    data, join(seed_root, "ckpt", f"p_{name}", "gan"), gw_ck,
                    knobs, extra, args.device)
            key = f"{name}{suffix}/seed{seed}"
            row = {
                "knobs": knobs,
                **eval_acoustic(final_g, data, extra, device=args.device),
                "train_mcd_db": final_scalar(
                    join(dirname(final_g), "log"), "train mcd metric"),
                "fixtures_blob": fix_rev,
            }
            row["deficit_ratio_vs_baseline"] = round(
                row["modspec_hi_band_deficit_db"]
                / results[base_key]["modspec_hi_band_deficit_db"], 3)
            row.update(seed=seed, **stamp,
                       seconds=round(time.perf_counter() - t0, 1))
            results[key] = row
            print(key, json.dumps(row), flush=True)
            write_json(args.out, results)
    if args.out_md:
        with open(join(REPO, "docs", "tts_gan_sweep.json")) as f:
            replace_section(args.out_md, SECTION,
                            render_md(results, json.load(f), suffix))
    print("wrote", args.out, "and", args.out_md or "no markdown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
