"""``python -m gantts_tpu_torch.parallel --dryrun N``: one data-parallel
GAN step and the time-sharded MLPG on N gloo ranks on the CPU
(``parallel/dryrun.py``)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gantts_tpu_torch.parallel",
        description="Dry run of data-parallel GAN training on gloo CPU "
                    "ranks")
    p.add_argument("--dryrun", type=int, metavar="N", required=True,
                   help="number of ranks (processes)")
    args = p.parse_args(argv)
    if args.dryrun < 1:
        p.error("--dryrun needs at least one rank")
    from gantts_tpu_torch.parallel.dryrun import dryrun

    dryrun(args.dryrun)
    return 0


if __name__ == "__main__":
    sys.exit(main())
