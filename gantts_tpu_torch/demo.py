"""The repository's two demo commands on the port (counterparts of
vc_demo.sh and tts_demo.sh):

    python -m gantts_tpu_torch.demo vc <experiment_id> <cmu_arctic_root> \\
        [--device cuda|cpu]
    python -m gantts_tpu_torch.demo tts <experiment_id> <slt_arctic_root> \\
        [--device cuda|cpu]

Each runs the script's steps, in this process, with the same command lines
into the same paths relative to the working directory:

  vc   1. ``prepare_features_vc`` (clb -> slt) into
          ``data/cmu_arctic_vc_<id>``;
       2. the curriculum (train_gan.sh: ``vc``, stages 1-3 and 5) into
          ``checkpoints/vc_<id>``;
       3. ``evaluation_vc --diffvc`` of the baseline and the adversarial
          generator into ``generated/vc_<id>_{baseline,gan}``.
  tts  1. ``prepare_features_tts`` into ``data/slt_arctic_tts_<id>``;
       2. the curriculum for ``tts_duration`` and then ``tts_acoustic`` into
          ``checkpoints/tts_<id>/{duration,acoustic}``;
       3. ``evaluation_tts --post-filter`` of both baselines and both
          adversarial generators into ``generated/tts_<id>_{baseline,gan}``.

The scripts' environment knobs, with their defaults: ``MAX_FILES`` (500),
``TOTAL_EPOCH`` (200), ``G_WARMUP`` (vc 50, tts 10), ``D_WARMUP`` (vc 10,
tts 5), ``DURATION_EPOCHS`` (100), ``ACOUSTIC_EPOCHS`` (50),
``HPARAMS_EXTRA`` (empty), ``EVAL_WORKERS`` (4), and what the curriculum
reads (``W_D``, ``ADV_HPARAMS``, the ``RUN_*`` switches).  A knob that is
set but empty takes its default, as ``${NAME:-default}`` does.  Training
and synthesis run on the card unless ``--device cpu`` is given; the feature
commands are host work.  A step that fails ends the command with its exit
code, as ``set -e`` does; each step prints its wall time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from os.path import join

# knob -> default, per demo (vc_demo.sh, tts_demo.sh)
KNOBS = {
    "vc": {"MAX_FILES": "500", "HPARAMS_EXTRA": "", "TOTAL_EPOCH": "200",
           "G_WARMUP": "50", "D_WARMUP": "10", "EVAL_WORKERS": "4"},
    "tts": {"DURATION_EPOCHS": "100", "ACOUSTIC_EPOCHS": "50",
            "G_WARMUP": "10", "D_WARMUP": "5", "HPARAMS_EXTRA": "",
            "EVAL_WORKERS": "4"},
}


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.demo",
        description="The VC and TTS demos (vc_demo.sh, tts_demo.sh) on "
                    "PyTorch")
    p.add_argument("demo", choices=sorted(KNOBS))
    p.add_argument("experiment_id")
    p.add_argument("data_root")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and synthesize on "
                        "(default: cuda)")
    return p


def knobs(demo, env):
    """The demo's knobs from ``env``, each unset or empty one at its
    default."""
    return {name: env.get(name) or default
            for name, default in KNOBS[demo].items()}


def ckpt(directory, epoch):
    return join(directory, f"checkpoint_epoch{epoch}_Generator.pth")


def steps(args, env):
    """[(name, module, argv)]: the demo's steps, each a module's ``main``
    and the command line the shell script gives it (plus ``--device``
    where the step trains or synthesizes)."""
    k = knobs(args.demo, env)
    exp, root, dev = args.experiment_id, args.data_root, \
        f"--device={args.device}"
    extra, workers = k["HPARAMS_EXTRA"], f"--workers={k['EVAL_WORKERS']}"
    if args.demo == "vc":
        data, ck = f"data/cmu_arctic_vc_{exp}", f"checkpoints/vc_{exp}"
        total = k["TOTAL_EPOCH"]
        run = [("features", "prepare_features_vc",
                [root, "clb", "slt", f"--max_files={k['MAX_FILES']}",
                 f"--dst_dir={data}"]),
               ("curriculum", "curriculum",
                ["vc", extra, f"{data}/X", f"{data}/Y", ck, k["G_WARMUP"],
                 k["D_WARMUP"], total, total, dev])]
        for kind in ("baseline", "gan"):
            run.append((f"evaluation {kind}", "evaluation_vc", [
                "--diffvc", workers, f"--hparams={extra}",
                ckpt(f"{ck}/{kind}", total), data,
                f"{root}/cmu_us_clb_arctic/wav",
                f"generated/vc_{exp}_{kind}", dev]))
        return run
    data, ck = f"data/slt_arctic_tts_{exp}", f"checkpoints/tts_{exp}"
    dur, ac = k["DURATION_EPOCHS"], k["ACOUSTIC_EPOCHS"]
    run = [("features", "prepare_features_tts", [root, f"--dst_dir={data}"])]
    for model, epochs in (("duration", dur), ("acoustic", ac)):
        run.append((f"curriculum {model}", "curriculum", [
            f"tts_{model}", extra, f"{data}/X_{model}", f"{data}/Y_{model}",
            f"{ck}/{model}", k["G_WARMUP"], k["D_WARMUP"], epochs, epochs,
            dev]))
    for kind in ("baseline", "gan"):
        run.append((f"evaluation {kind}", "evaluation_tts", [
            "--post-filter", workers, f"--hparams_acoustic={extra}",
            f"--hparams_duration={extra}", ckpt(f"{ck}/acoustic/{kind}", ac),
            ckpt(f"{ck}/duration/{kind}", dur), data,
            f"{root}/label_state_align", f"generated/tts_{exp}_{kind}",
            dev]))
    return run


def run_step(module, argv, env):
    """The step's exit code: its ``main``'s return value, or the code it
    exits with."""
    from importlib import import_module

    from gantts_tpu_torch import curriculum

    main = import_module(f"gantts_tpu_torch.{module}").main
    if module == "curriculum":
        return curriculum._run_stage(lambda a: main(a, env=env), argv)
    return curriculum._run_stage(main, argv)


def main(argv=None, env=None):
    args = build_arg_parser().parse_args(argv)
    env = os.environ if env is None else env
    since = time.perf_counter()
    for name, module, step_argv in steps(args, env):
        print(f"demo {args.demo}: {name} (python -m gantts_tpu_torch."
              f"{module} {' '.join(step_argv)})", flush=True)
        t0 = time.perf_counter()
        rc = run_step(module, step_argv, env)
        print(f"demo {args.demo}: {name} exited {rc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            return rc
    out = f"generated/{args.demo}_{args.experiment_id}"
    print(f"demo {args.demo}: wavs in {out}_{{baseline,gan}}/{{eval,test}} "
          f"({time.perf_counter() - since:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
