#!/usr/bin/env python3
"""The quality dossier's VC half in the JAX package, on the CPU, at several
training seeds: the JAX side of the port's seed spread.

    python tools/torch_dossier_vs_jax.py [--seeds 1234,1,2,3,4] [--root DIR]
        [--seeds-json docs/dossier_seeds_torch.json]

It runs vc_demo.sh's three steps at tools/quality_dossier.py's settings (40
utterances of ``make_arctic_vc_corpus(articulation_scatter=0.06)``, 40
epochs, G warm-up 10, D warm-up 5): the repository's prepare_features_vc.py
(once, in a subprocess: the features take no seed), the curriculum's stages
1-3 and 5 through train.py's ``main`` in this process (train_gan.sh's
command lines, ``curriculum.stage_argvs``), and evaluation_vc.py
``--diffvc`` on the baseline and the adversarial generator (subprocesses).
The training seed is bound here, in this process, through the ``seed``
arguments of the JAX package's ``init_models_and_states`` and
``train_loop``; no command line gains a seed flag.  The JAX package runs on
the CPU, one device.

Each seed's row (the dossier's metrics of both VC configs, the seconds, the
device) goes into ``--seeds-json`` through tools/torch_quality_dossier.py's
writer, beside the port's rows, as soon as the seed ends.  This tool
imports both packages; it is a tool, not part of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import platform
import shutil
import subprocess
import sys
import time
from os.path import dirname, join
from unittest import mock

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, join(REPO, "tools"))
sys.path.insert(0, join(REPO, "tests"))
os.environ["GANTTS_TPU_PLATFORM"] = "cpu"
os.environ["JAX_PLATFORMS"] = "cpu"

import torch_quality_dossier as dossier  # noqa: E402


@contextlib.contextmanager
def jax_training(seed):
    """Bind ``seed`` into the JAX package's initialization and training
    loop, and give train.py a copy of the vc bundle to parse its flags
    into."""
    import gantts_tpu.train
    import gantts_tpu.train.setup
    from gantts_tpu import hparams

    with mock.patch.object(gantts_tpu.train.setup, "init_models_and_states",
                           functools.partial(
                               gantts_tpu.train.setup.init_models_and_states,
                               seed=seed)), \
            mock.patch.object(gantts_tpu.train, "train_loop",
                              functools.partial(gantts_tpu.train.train_loop,
                                                seed=seed)), \
            mock.patch.object(hparams, "vc", hparams.vc.copy()):
        yield


def script(name, argv, cwd):
    """One of the repository's root scripts in a subprocess on the CPU."""
    env = dict(os.environ, GANTTS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, join(REPO, name), *argv],
                          cwd=cwd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise SystemExit(f"{name} exited {proc.returncode}")


def run_seed(seed, root, corpus, vc_env):
    """The VC half at ``seed`` under ``root``; returns its seconds (the
    features, made once, not counted)."""
    import train as jax_train_cli
    from gantts_tpu_torch import curriculum

    data = "data/cmu_arctic_vc_dossier"
    for kind in ("checkpoints/vc_dossier", "generated/vc_dossier_baseline",
                 "generated/vc_dossier_gan"):
        shutil.rmtree(join(root, kind), ignore_errors=True)
    total = vc_env["TOTAL_EPOCH"]
    args = curriculum.build_arg_parser().parse_args([
        "vc", "", f"{data}/X", f"{data}/Y", "checkpoints/vc_dossier",
        vc_env["G_WARMUP"], vc_env["D_WARMUP"], total, total])
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for stage, argv in curriculum.stage_argvs(args, {}):
            with jax_training(seed):
                rc = jax_train_cli.main(argv + ["--disable-slack"])
            if rc != 0:
                raise SystemExit(f"train.py ({stage}) exited {rc}")
    finally:
        os.chdir(cwd)
    for kind in ("baseline", "gan"):
        script("evaluation_vc.py", [
            "--diffvc", "--workers=4", "--hparams=",
            f"checkpoints/vc_dossier/{kind}/checkpoint_epoch{total}_"
            f"Generator.pth", data, f"{corpus}/cmu_us_clb_arctic/wav",
            f"generated/vc_dossier_{kind}"], root)
    return time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="1234,1,2,3,4")
    p.add_argument("--root", default=join(REPO, "dossier_work", "jax"))
    p.add_argument("--seeds-json",
                   default=join(REPO, "docs", "dossier_seeds_torch.json"))
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    device = f"cpu ({platform.processor() or platform.machine()}, " \
        f"{os.cpu_count()} cores, {len(jax.devices())} JAX device)"
    n_vc, n_tts, vc_env, tts_env = dossier.settings(False, 250, "0.2", "")
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    corpus = join(root, f"arctic{n_vc}_scatter")
    if not os.path.isdir(corpus):
        from fixtures import make_arctic_vc_corpus

        make_arctic_vc_corpus(corpus, num=n_vc, articulation_scatter=0.06)
    data = join(root, "data", "cmu_arctic_vc_dossier")
    if not os.path.isdir(join(data, "Y")):
        t0 = time.perf_counter()
        script("prepare_features_vc.py", [
            corpus, "clb", "slt", f"--max_files={vc_env['MAX_FILES']}",
            f"--dst_dir={data}"], root)
        print(f"features in {time.perf_counter() - t0:.1f} s", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        secs = run_seed(seed, root, corpus, vc_env)
        configs = dossier.collect(root, "vc")
        dossier.write_seed_rows(args.seeds_json, [dossier.seed_row(
            "jax", "vc", seed, device, None, secs, configs)],
            dossier.workload(n_vc, n_tts, vc_env, tts_env))
        print(f"vc jax seed {seed} ({secs:.1f} s): {configs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
