#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 [--faults]

For each seed: the program's first training steps as the window's own call
drives them in its epoch 1 (``harness.drive`` without a window) against the
plain reference (the sound reading); with ``--faults`` also the control, the
reference computed with TF32 products in the program's place, and the
fault of half of each batch left out (the mean over the rest), the
reference so broken in the program's place, and the state left unchanged;
and the look at what rounding alone does: the float32 reference judged
against a float64 one.  One JSON line a seed, then one with,
for each number, the largest sound reading and the smallest control and
fault readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# the control, each fault planted in the reference put in the program's
# place, and the look: the float32 reference against a float64 one
FAULTS = (("control", {"tf32": True}),
          ("half_batch", {"half_batch": True}),
          ("unchanged_state", {"update": False}),
          ("float32_vs_float64", "look"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--detail", action="store_true",
                   help="each seed's losses and widest leaves too")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import torch

    from perfbench import check, corpus, harness, peaks

    _, config, traffic, _, _ = harness.find_cell(args.workload)
    family, _ = harness.family(config)
    hp = harness.hparams_of(config)
    device = torch.device(args.device)
    print(f"calibrate: {args.workload}, card: {peaks.card()}", flush=True)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        sd = harness.seeds(seed)
        tmp = tempfile.mkdtemp(prefix="perfbench-")
        try:
            raw = corpus.make(config, traffic, sd["corpus"], device)
            with harness.program_output_to_stderr():
                prog, _, clock, record, _ = harness.drive(config, raw, sd,
                                                          device, tmp)
            clock.graphs = clock.end_of_setup = None
            del prog, clock
            gc.collect()
            weights = harness.weights_of(config, sd, device)
            ref = check.reference_record(family, hp, config["run"], raw,
                                         weights, sd["loop"], device)
            row = {"seed": seed, "sound": check.readings(record, ref)}
            if args.detail:
                row["detail"] = check.detail(record, ref)
            if args.faults:
                for name, kw in FAULTS:
                    judge = ref
                    if kw == "look":
                        judge = check.reference_record(
                            family, hp, config["run"], raw, weights,
                            sd["loop"], device, dtype=torch.float64)
                        other = ref
                    else:
                        other = check.reference_record(
                            family, hp, config["run"], raw, weights,
                            sd["loop"], device, **kw)
                    row[name] = check.readings(other, judge)
                    if args.detail:
                        row[f"{name}_detail"] = check.detail(other, judge)
            rows.append(row)
            print(json.dumps(row), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    def over(name, pick):
        return {k: pick(r[name][k] for r in rows) for k in check.NUMBERS
                if k in rows[0][name]}

    summary = {"sound_max": over("sound", max)}
    for name, _ in FAULTS:
        if args.faults:
            summary[f"{name}_min"] = over(name, min)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
