#!/usr/bin/env python3
"""The quality dossier on the port: the five BASELINE configs through the
port's demo commands, on the card (counterpart of tools/quality_dossier.py,
whose corpora, epochs, settings and metrics it keeps).

    python tools/torch_quality_dossier.py [--root DIR] [--quick]
        [--only vc|tts|all] [--n-tts 250] [--adv-hparams H] [--w-d 0.2]
        [--device cuda|cpu] [--seeds 1234[,1,...]]
        [--out-json results_torch.json] [--out-md RESULTS_torch.md]
        [--seeds-json docs/dossier_seeds_torch.json]

Configs: #1 VC In2OutHighwayNet MGE-only baseline and #2 its 5-stage GAN
curriculum (``python -m gantts_tpu_torch.demo vc``); #3 the TTS duration
model, #4 the TTS acoustic MGE-only baseline and #5 its adversarial stage
(``python -m gantts_tpu_torch.demo tts``).  The corpora are
tests/fixtures.py's speech-like synthetic ones: 40 parallel VC utterances
(``articulation_scatter=0.06``, 40 epochs, G warm-up 10, D warm-up 5) and
``--n-tts`` labelled TTS utterances (duration and acoustic 30 epochs, G
warm-up 8, D warm-up 4, ``batch_size=8``, ``W_D=0.2``); ``--quick`` cuts
them to 12 and 10 utterances and 3 epochs (a smoke run; its numbers mean
nothing).  Recorded for each config: the last logged train/test
distortions, and from each evaluation's analysis.json the GV ratio and the
high-band modulation-spectrum deficit against natural speech.

The demos run in this process, so that the training seed can be bound here:
``init_models_and_states`` and ``train_loop`` take ``seed`` (1234, the
programs' default, unless ``--seeds`` names others); no command line gains
a seed flag.  The run at the first seed writes ``--out-json`` and
``--out-md``; with ``--seeds``, every seed's row of each half goes into
``--seeds-json`` beside the rows there of other packages (tools/torch_dossier_vs_jax.py
writes the JAX package's), replacing a row of the same package, half and
seed; the markdown shows the seeds file's rows too.
tests/test_torch_dossier.py gates the committed files.

This tool imports torch, the port and tests/fixtures.py (numpy only):
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from os.path import dirname, join
from unittest import mock

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = {"vc": ("vc_in2out_baseline", "vc_in2out_gan"),
           "tts": ("tts_duration", "tts_acoustic_baseline",
                   "tts_acoustic_gan")}
# the JAX dossier's one-seed GV rule (tests/test_results_dossier.py), shown
# beside each seed's numbers in the markdown
PAIRS = {"vc": ("vc_in2out_baseline", "vc_in2out_gan"),
         "tts": ("tts_acoustic_baseline", "tts_acoustic_gan")}


# the heading of tools/torch_tts_gan_sweep.py's section of --out-md, which
# a new rendering keeps
SWEEP_SECTION = "## TTS GAN knob sweep"


def split_section(text, heading):
    """(before, section, after) of a markdown text: ``section`` runs from
    the line ``heading`` to the next heading of its level, or the end ('',
    with the whole text before it, where the text has no such line)."""
    before, found, rest = ("\n" + text).partition("\n" + heading)
    if not found:
        return text, "", ""
    end = rest.find("\n" + heading.split(" ", 1)[0] + " ")
    end = len(rest) if end < 0 else end + 1
    return before[1:], heading + rest[:end], rest[end:]


def read_section(path, heading):
    """The section under ``heading`` of the markdown file at ``path`` (''
    where the file or the section is missing)."""
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return split_section(f.read(), heading)[1]


def replace_section(path, heading, text):
    """Put ``text`` (a section starting with ``heading``) into the markdown
    file at ``path`` in place of its section under ``heading``, or at its
    end; everything else in the file stays."""
    old = ""
    if os.path.exists(path):
        with open(path) as f:
            old = f.read()
    before, _, after = split_section(old, heading)
    before = before.strip("\n")
    with open(path, "w") as f:
        f.write((before + "\n\n" if before else "")
                + (text.rstrip("\n") + "\n\n" + after if after else text))


def read_series(jsonl_path, tag):
    with open(jsonl_path) as f:
        return [(r["step"], r["value"]) for r in map(json.loads, f)
                if r["tag"] == tag]


def final(jsonl_path, tag):
    series = read_series(jsonl_path, tag)
    return round(float(series[-1][1]), 4) if series else None


def analysis_summary(analysis_path):
    with open(analysis_path) as f:
        rep = json.load(f)
    out = {"gv_ratio": round(rep.get("gv_ratio", float("nan")), 4)}
    g = rep.get("modspec_generated_hi_band_db")
    n = rep.get("modspec_natural_hi_band_db")
    if g is not None and n is not None:
        out["modspec_hi_band_deficit_db"] = round(n - g, 3)
    return out


def settings(quick, n_tts, w_d, adv_hparams):
    """(vc corpus size, tts corpus size, vc environment, tts environment):
    tools/quality_dossier.py's."""
    if quick:
        n_vc, n_tts = 12, 10
        vc_env = dict(MAX_FILES=str(n_vc), TOTAL_EPOCH="3", G_WARMUP="1",
                      D_WARMUP="1")
        tts_env = dict(DURATION_EPOCHS="3", ACOUSTIC_EPOCHS="3",
                       G_WARMUP="1", D_WARMUP="1")
    else:
        n_vc = 40
        vc_env = dict(MAX_FILES=str(n_vc), TOTAL_EPOCH="40", G_WARMUP="10",
                      D_WARMUP="5")
        tts_env = dict(DURATION_EPOCHS="30", ACOUSTIC_EPOCHS="30",
                       G_WARMUP="8", D_WARMUP="4",
                       HPARAMS_EXTRA="batch_size=8")
    if adv_hparams:
        tts_env["ADV_HPARAMS"] = adv_hparams
    if w_d:
        tts_env["W_D"] = w_d
    return n_vc, n_tts, vc_env, tts_env


def workload(n_vc, n_tts, vc_env, tts_env):
    knobs = "".join(f", {v}" if k == "HPARAMS_EXTRA" else f", {k}={v}"
                    for k, v in tts_env.items()
                    if k in ("HPARAMS_EXTRA", "ADV_HPARAMS", "W_D"))
    return {
        "vc": (f"{n_vc} synthetic parallel utterances (tests/fixtures.py "
               f"make_arctic_vc_corpus, articulation_scatter=0.06), "
               f"{vc_env['TOTAL_EPOCH']} epochs"),
        "tts": (f"{n_tts} synthetic labelled utterances (make_tts_corpus, "
                f"speech-like + articulation scatter), duration "
                f"{tts_env['DURATION_EPOCHS']} / acoustic "
                f"{tts_env['ACOUSTIC_EPOCHS']} epochs" + knobs)}


def make_corpora(root, n_vc, n_tts):
    """The fixtures' corpora under ``root`` (made once; the names carry
    their sizes)."""
    # by its directory: an installed package named "tests" may shadow ours
    sys.path.insert(0, join(REPO, "tests"))
    from fixtures import make_arctic_vc_corpus, make_tts_corpus

    vc_corpus = join(root, f"arctic{n_vc}_scatter")
    tts_corpus = join(root, f"slt{n_tts}")
    if not os.path.isdir(vc_corpus):
        make_arctic_vc_corpus(vc_corpus, num=n_vc, articulation_scatter=0.06)
    if not os.path.isdir(tts_corpus):
        make_tts_corpus(tts_corpus, num=n_tts)
    return {"vc": vc_corpus, "tts": tts_corpus}


def clear_half(root, half):
    """Remove a half's earlier outputs (the scalar logs append, and
    ``final`` must read this run's epochs alone)."""
    data = {"vc": "cmu_arctic_vc_dossier", "tts": "slt_arctic_tts_dossier"}
    for d in (join(root, "checkpoints", f"{half}_dossier"),
              join(root, "generated", f"{half}_dossier_baseline"),
              join(root, "generated", f"{half}_dossier_gan"),
              join(root, "data", data[half])):
        shutil.rmtree(d, ignore_errors=True)


def collect(root, half):
    """The half's configs from its logs and analysis files under
    ``root``."""
    gen = join(root, "generated")
    if half == "vc":
        ck = join(root, "checkpoints", "vc_dossier")
        return {key: {
            "train_mcd_db": final(join(ck, kind, "log", "scalars.jsonl"),
                                  "train mcd metric"),
            "test_mcd_db": final(join(ck, kind, "log", "scalars.jsonl"),
                                 "test mcd metric"),
            **analysis_summary(join(gen, f"vc_dossier_{kind}",
                                    "analysis.json"))}
            for key, kind in zip(CONFIGS["vc"], ("baseline", "gan"))}
    ck = join(root, "checkpoints", "tts_dossier")
    dur = join(ck, "duration", "baseline", "log", "scalars.jsonl")
    out = {"tts_duration": {
        "train_dur_rmse_frames": final(dur, "train dur_rmse metric"),
        "test_dur_rmse_frames": final(dur, "test dur_rmse metric")}}
    for key, kind in zip(CONFIGS["tts"][1:], ("baseline", "gan")):
        log = join(ck, "acoustic", kind, "log", "scalars.jsonl")
        out[key] = {
            "train_mcd_db": final(log, "train mcd metric"),
            "test_mcd_db": final(log, "test mcd metric"),
            "test_bap_mcd_db": final(log, "test bap_mcd metric"),
            "test_f0_rmse": final(log, "test f0_rmse metric"),
            "test_vuv_err": final(log, "test vuv_err metric"),
            **analysis_summary(join(gen, f"tts_dossier_{kind}",
                                    "analysis.json"))}
    return out


@contextlib.contextmanager
def training_seed(seed):
    """Bind ``seed`` into the port's model initialization and training
    loop for the runs inside (the training command line imports both when
    it runs)."""
    from gantts_tpu_torch.train import loop, setup

    with mock.patch.object(setup, "init_models_and_states", functools.partial(
            setup.init_models_and_states, seed=seed)), \
            mock.patch.object(loop, "train_loop", functools.partial(
                loop.train_loop, seed=seed)):
        yield


def run_demo(half, root, corpus, env_extra, device):
    """``python -m gantts_tpu_torch.demo <half> dossier <corpus>`` in this
    process with ``root`` as the working directory; returns its seconds."""
    from gantts_tpu_torch import demo

    env = dict(os.environ, **env_extra)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    os.chdir(root)
    try:
        rc = demo.main([half, "dossier", corpus, f"--device={device}"],
                       env=env)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise SystemExit(f"demo {half} exited {rc}")
    return time.perf_counter() - t0


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them (None on
    the CPU)."""
    if device == "cpu":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def blob_id(path):
    """git's blob id of a file (``git hash-object``), without git."""
    with open(path, "rb") as f:
        data = f.read()
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def seed_row(package, half, seed, device, card, seconds, configs):
    name, _, limit = (card or "").partition(", ")
    return {"package": package, "half": half, "seed": seed,
            "device": device, "card": name or None,
            "power_limit": limit or None, "seconds": round(seconds, 1),
            **configs}


def load_json(path, default):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return default


def write_seed_rows(path, rows, workload_text):
    """Put ``rows`` into the seeds file, replacing any row of the same
    package, half and seed and keeping every other."""
    doc = load_json(path, {"workload": workload_text, "rows": []})
    doc["workload"] = workload_text
    key = lambda r: (r["package"], r["half"], r["seed"])  # noqa: E731
    new = {key(r) for r in rows}
    doc["rows"] = [r for r in doc["rows"] if key(r) not in new] + rows
    doc["rows"].sort(key=lambda r: (r["half"], r["package"], r["seed"]))
    os.makedirs(dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def jax_gv_verdict(base_gv, gan_gv):
    """tests/test_results_dossier.py's one-seed GV rule: the adversarial
    GV at least as close to 1 as the baseline's (+0.02), or within 0.05."""
    return abs(1.0 - gan_gv) <= max(abs(1.0 - base_gv) + 0.02, 0.05)


def render_md(results, seeds_doc, path):
    def row(name, d):
        return f"| {name} | " + " | ".join(f"{k} {v}" for k, v in d.items()) \
            + " |"

    wl = results.get("workload", {})
    prov = results.get("_provenance", {})
    corpora = "; ".join(wl[k] for k in ("vc", "tts") if k in wl)
    md = ["# RESULTS_torch — quality dossier on the port",
          "",
          f"Generated by `python tools/torch_quality_dossier.py` on "
          f"`{wl.get('device')}` ({prov.get('card')}), training seed "
          f"{prov.get('seed')}; torch {prov.get('torch')}, CUDA "
          f"{prov.get('cuda')}; corpora: {corpora}.",
          "",
          "The JAX package's dossier, on a TPU, is `RESULTS.md` / "
          "`results.json`.  Gated by `tests/test_torch_dossier.py` over "
          "this file and the seed rows below: the same ceilings and MCD "
          "blow-up bound at every seed, the high-band modulation-spectrum "
          "rule at every seed, and GV judged over the seeds rather than "
          "on one draw.",
          "",
          "| config | metrics |",
          "|---|---|"]
    for key in CONFIGS["vc"] + CONFIGS["tts"]:
        if key in results:
            md.append(row(key, results[key]))
    md += ["",
           "## GV ratio by training seed",
           "",
           "From `docs/dossier_seeds_torch.json`.  \"JAX gate\" is the "
           "JAX dossier's one-seed GV rule (tests/test_results_dossier.py: "
           "|1 - GAN GV| <= max(|1 - baseline GV| + 0.02, 0.05)) applied to "
           "that seed alone.",
           "",
           "| half | package | seed | device | baseline GV | GAN GV | "
           "JAX gate | GAN hi-band deficit dB (baseline) | GAN test MCD "
           "(baseline) | seconds |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in seeds_doc.get("rows", []):
        base_k, gan_k = PAIRS[r["half"]]
        base, gan = r[base_k], r[gan_k]
        verdict = "pass" if jax_gv_verdict(base["gv_ratio"],
                                           gan["gv_ratio"]) else "fail"
        md.append(
            f"| {r['half']} | {r['package']} | {r['seed']} | "
            f"{r['device']} | {base['gv_ratio']} | {gan['gv_ratio']} | "
            f"{verdict} | {gan['modspec_hi_band_deficit_db']} "
            f"({base['modspec_hi_band_deficit_db']}) | "
            f"{gan['test_mcd_db']} ({base['test_mcd_db']}) | "
            f"{r['seconds']} |")
    by = {}
    for r in seeds_doc.get("rows", []):
        gan = r[PAIRS[r["half"]][1]]["gv_ratio"]
        by.setdefault((r["half"], r["package"]), []).append(gan)
    if by:
        md += ["", "| half | package | seeds | median \\|1 - GAN GV\\| | "
               "GAN GV range |", "|---|---|---|---|---|"]
        for (half, package), gvs in sorted(by.items()):
            med = statistics.median(abs(1.0 - g) for g in gvs)
            md.append(f"| {half} | {package} | {len(gvs)} | {med:.4f} | "
                      f"{min(gvs)} - {max(gvs)} |")
    md.append("")
    sweep = read_section(path, SWEEP_SECTION)  # the sweep tool's section
    if sweep:
        md += [sweep.rstrip("\n"), ""]
    with open(path, "w") as f:
        f.write("\n".join(md))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None,
                   help="working directory for corpora, features, "
                        "checkpoints and wavs (default: dossier_work/ in "
                        "the repository, which git ignores)")
    p.add_argument("--quick", action="store_true",
                   help="tiny epochs/corpus (smoke only, numbers meaningless)")
    p.add_argument("--only", choices=["vc", "tts", "all"], default="all",
                   help="run one half; the other half's configs are kept "
                        "from the existing --out-json")
    p.add_argument("--n-tts", type=int, default=250, dest="n_tts",
                   help="TTS corpus size (utterances)")
    p.add_argument("--adv-hparams", default="", dest="adv_hparams",
                   help="extra hparams for the GAN stages only "
                        "(the curriculum's ADV_HPARAMS)")
    p.add_argument("--w-d", default="0.2", dest="w_d",
                   help="the TTS stage-5 adversarial weight (W_D)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", default=None,
                   help="comma-separated training seeds, run in turn, each "
                        "written to --seeds-json (default: 1234 alone, "
                        "and no seed rows)")
    p.add_argument("--out-json", default=join(REPO, "results_torch.json"))
    p.add_argument("--out-md", default=join(REPO, "RESULTS_torch.md"))
    p.add_argument("--seeds-json",
                   default=join(REPO, "docs", "dossier_seeds_torch.json"))
    args = p.parse_args(argv)

    import torch

    seeds = [int(s) for s in (args.seeds or "1234").split(",")]
    halves = ["vc", "tts"] if args.only == "all" else [args.only]
    n_vc, n_tts, vc_env, tts_env = settings(args.quick, args.n_tts, args.w_d,
                                            args.adv_hparams)
    envs = {"vc": vc_env, "tts": tts_env}
    root = os.path.abspath(args.root or join(REPO, "dossier_work"))
    os.makedirs(root, exist_ok=True)
    corpora = make_corpora(root, n_vc, n_tts)
    card = card_line(args.device)
    wl = workload(n_vc, n_tts, vc_env, tts_env)

    results = load_json(args.out_json, {}) if args.only != "all" else {}
    results.setdefault("workload", {})["device"] = args.device
    results["workload"].update({h: wl[h] for h in halves})
    prov = results.setdefault("_provenance", {})
    prov.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                seed=seeds[0])
    rows = []
    for seed in seeds:
        for half in halves:
            clear_half(root, half)
            with training_seed(seed):
                secs = run_demo(half, root, corpora[half], envs[half],
                                args.device)
            configs = collect(root, half)
            rows.append(seed_row("port", half, seed, args.device, card, secs,
                                 configs))
            print(f"{half} port seed {seed} ({secs:.1f} s): "
                  f"{json.dumps(configs)}", flush=True)
            if seed == seeds[0]:
                results.update(json.loads(json.dumps(configs)))
                results[PAIRS[half][1]]["wall_clock_s_full_demo"] = round(
                    secs, 1)
                prov[f"fixtures_blob_{half}"] = blob_id(
                    join(REPO, "tests", "fixtures.py"))
                prov[f"seconds_{half}"] = round(secs, 1)
    with open(args.out_json, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    if args.seeds:
        write_seed_rows(args.seeds_json, rows, wl)
    render_md(results, load_json(args.seeds_json, {}), args.out_md)
    print(json.dumps(results, indent=2))
    print("wrote", args.out_json, "and", args.out_md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
