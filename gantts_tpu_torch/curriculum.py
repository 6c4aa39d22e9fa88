"""The five-stage GAN training curriculum on the port (counterpart of the
repository's train_gan.sh):

    python -m gantts_tpu_torch.curriculum <hparams_name> <hparams> \\
        <inputs_dir> <outputs_dir> <checkpoint_dir> <generator_warmup_epoch> \\
        <discriminator_warmup_epoch> <spoofing_total_epoch> <total_epoch> \\
        [--device cuda|cpu]

It takes train_gan.sh's nine arguments and its environment switches, and
runs the same stages with the same command lines, each through
``gantts_tpu_torch.train``'s ``main`` in this process (plus ``--device``,
``cuda`` unless asked for ``cpu``).  State passes from stage to stage only
through the checkpoint files ``checkpoint_epoch{N}_{Generator|
Discriminator}.pth``:

  1. baseline      MGE only, ``total_epoch`` epochs, in ``baseline/``
                   (``--w_d=0``);
  2. G warm-up     MGE only, ``generator_warmup_epoch`` epochs, in ``gan/``;
  3. D warm-up     the discriminator against the frozen warm-up generator
                   (``--discriminator-warmup``), in ``gan/``;
  4. spoofing D    optional: a reference discriminator against the baseline
                   generator, in ``spoofing_model/``;
  5. adversarial   joint training from both warm-ups (``--reset_optimizers``,
                   ``--restart_epoch=<generator_warmup_epoch>``, ``--w_d``
                   and, after stage 4, ``--checkpoint-r``), in ``gan/``.

Environment: ``W_D`` (stage 5's adversarial weight, default 1.0),
``ADV_HPARAMS`` (appended to the hparams of stages 3-5), and
``RUN_BASELINE``, ``RUN_GENERATOR_WARMUP``, ``RUN_DISCRIMINATOR_WARMUP``,
``RUN_ADVERSARIAL`` (default 1) and ``RUN_SPOOFING_MODEL`` (default 0): a
stage runs when its switch is ``1``.  A stage that exits non-zero stops the
run with its exit code.

As in the reference, the spoofing rate feeds the reference discriminator the
selected static stream alone, so ``--checkpoint-r`` (``RUN_SPOOFING_MODEL=1``)
works only with ``discriminator_linguistic_condition=False``.

Why a copy of train_gan.sh's stage table (``stage_argvs``) rather than the
script run with a ``PYTHON`` that calls the port: the stages run in one
process, so the card's context and the kernels built on its first call
serve every stage, and a caller can read the kernels' launch counters around
each stage's ``main`` (chip_smoke.py phase 7 checks them against the steps
each stage must take).  ``tests/test_torch_curriculum.py`` holds this table
to the script's own command lines: it runs train_gan.sh with a recording
``PYTHON``.
"""

from __future__ import annotations

import argparse
import os
import sys

# stage -> (its switch, the switch's default), in train_gan.sh's order
STAGES = {"baseline": ("RUN_BASELINE", "1"),
          "generator_warmup": ("RUN_GENERATOR_WARMUP", "1"),
          "discriminator_warmup": ("RUN_DISCRIMINATOR_WARMUP", "1"),
          "spoofing_model": ("RUN_SPOOFING_MODEL", "0"),
          "adversarial": ("RUN_ADVERSARIAL", "1")}


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.curriculum",
        description="The five-stage GAN training curriculum on PyTorch")
    for name in ("hparams_name", "hparams", "inputs_dir", "outputs_dir",
                 "checkpoint_dir", "generator_warmup_epoch",
                 "discriminator_warmup_epoch", "spoofing_total_epoch",
                 "total_epoch"):
        p.add_argument(name)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def _env(env, name, default):
    """A shell's ${NAME:-default}: unset or empty gives the default."""
    return env.get(name) or default


def ckpt(directory, epoch, name):
    return f"{directory}/checkpoint_epoch{epoch}_{name}.pth"


def stage_argvs(args, env):
    """[(stage, argv)] of the stages the switches in ``env`` enable, each
    argv the command line train_gan.sh gives train.py for it."""
    ck, g_warm, d_warm = (args.checkpoint_dir, args.generator_warmup_epoch,
                          args.discriminator_warmup_epoch)
    spoof, total = args.spoofing_total_epoch, args.total_epoch
    adv = _env(env, "ADV_HPARAMS", "")
    enabled = [stage for stage, (switch, default) in STAGES.items()
               if _env(env, switch, default) == "1"]

    def argv(nepoch, adversarial, *flags):
        spec = f"{args.hparams},nepoch={nepoch}"
        if adversarial and adv:  # stages 3-5 train a discriminator
            spec += f",{adv}"
        return [f"--hparams_name={args.hparams_name}", f"--hparams={spec}",
                *flags, args.inputs_dir, args.outputs_dir]

    spoof_d = ckpt(f"{ck}/spoofing_model", spoof, "Discriminator")
    checkpoint_r = ([f"--checkpoint-r={spoof_d}"]
                    if "spoofing_model" in enabled else [])
    argvs = {
        "baseline": argv(
            total, False, f"--checkpoint-dir={ck}/baseline",
            f"--log-event-path={ck}/baseline/log", "--w_d=0", "--mge_w=1.0"),
        "generator_warmup": argv(
            g_warm, False, f"--checkpoint-dir={ck}/gan",
            f"--log-event-path={ck}/gan/log", "--w_d=0", "--mge_w=1.0"),
        "discriminator_warmup": argv(
            d_warm, True, f"--checkpoint-dir={ck}/gan",
            f"--checkpoint-g={ckpt(f'{ck}/gan', g_warm, 'Generator')}",
            f"--log-event-path={ck}/gan/log", "--discriminator-warmup",
            "--w_d=1.0", "--restart_epoch=0"),
        "spoofing_model": argv(
            spoof, True, f"--checkpoint-dir={ck}/spoofing_model",
            f"--log-event-path={ck}/spoofing_model/log",
            f"--checkpoint-g={ckpt(f'{ck}/baseline', total, 'Generator')}",
            "--discriminator-warmup", "--w_d=1.0", "--restart_epoch=0"),
        "adversarial": argv(
            total, True, f"--checkpoint-dir={ck}/gan",
            f"--checkpoint-g={ckpt(f'{ck}/gan', g_warm, 'Generator')}",
            f"--checkpoint-d={ckpt(f'{ck}/gan', d_warm, 'Discriminator')}",
            f"--log-event-path={ck}/gan/log", "--reset_optimizers",
            f"--restart_epoch={g_warm}", f"--w_d={_env(env, 'W_D', '1.0')}",
            *checkpoint_r),
    }
    return [(stage, argvs[stage]) for stage in enabled]


def _run_stage(train_main, argv):
    """The stage's exit code: main's return value, or the code it exits
    with (argparse's 2 on a bad command line)."""
    try:
        rc = train_main(argv)
    except SystemExit as e:
        rc = e.code
    if rc is None:
        return 0
    return rc if isinstance(rc, int) else 1


def main(argv=None, env=None):
    args = build_arg_parser().parse_args(argv)
    env = os.environ if env is None else env
    from gantts_tpu_torch.train.__main__ import main as train_main

    for stage, stage_argv in stage_argvs(args, env):
        print(f"curriculum: stage {list(STAGES).index(stage) + 1} ({stage})",
              flush=True)
        rc = _run_stage(train_main, stage_argv + [f"--device={args.device}"])
        if rc != 0:
            print(f"curriculum: stage {stage} exited {rc}", file=sys.stderr)
            return rc
    print("curriculum: all requested stages finished.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
