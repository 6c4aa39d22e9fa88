#!/usr/bin/env python3
"""The benchmark of gantts_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA card.  The cell
(a configuration under a traffic mix) is found by name in BENCHMARK.json;
its configuration is ``perfbench/configs/<config>.json``, its traffic
``perfbench/traffic/<traffic>.json``, each per-layer metric
``perfbench/metrics/<metric>.py`` (``harness.py`` says what a run does).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
comparison with the plain reference read, beside its limit.  The same
numbers are the last lines of standard error.

It exits with 2, and prints no result, without a CUDA device; with 3 if a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from perfbench import harness, peaks

    cell, config, traffic, end_to_end, per_layer = harness.find_cell(
        args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = peaks.card()

    def say(line):
        print(line, file=sys.stderr, flush=True)

    say(f"perfbench: {args.workload}, seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}, card: {card}")
    result = harness.run_cell(
        config, traffic, end_to_end, per_layer, args.seed, args.seconds,
        bool(args.trace), "cuda:0", T_START, say=say)
    found = harness.forbidden_modules()
    if found:
        say(f"perfbench: modules of JAX or the JAX package were loaded: "
            f"{found}")
        return 3
    say(f"perfbench: window {json.dumps(result['window'])}; shares of "
        f"peaks and rooflines are against the H100's published peaks, "
        f"card: {card}")
    say(f"correct {result['correct']}; the numbers compared, each beside "
        f"its limit:")
    for name, c in result["compared"].items():
        say(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
