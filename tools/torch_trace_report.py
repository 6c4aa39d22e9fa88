#!/usr/bin/env python3
"""Summarize device time from a torch.profiler Chrome trace (counterpart of
tools/trace_report.py, which reads jax.profiler traces).

Point it at the trace that the port's training command line writes with
``--profile-dir DIR`` (``DIR/trace_epoch{N}.json``), at one that
``tools/torch_profile_step.py --trace-dir DIR`` writes, or at a directory
holding such files: ``*.json`` and ``*.json.gz`` are searched recursively
and the newest wins, as in the JAX tool.  It keeps the device events
(kernels, copies and fills; not the ``gpu_user_annotation`` ranges, which
mirror host annotations on the device and are no device work), names each
kernel by its function (no return type, template arguments or parameter
list: the counterpart of stripping XLA's numeric fusion suffixes), and
prints per step:

  * device busy: the union of the device events' intervals;
  * the sum of the device events;
  * the traced wall: the extent of the trace's events, host and device;
  * the idle share, 1 - busy / wall;

then each category's ms and launches per step, the ``--top`` largest and
``(other)``.

usage: python tools/torch_trace_report.py PATH [--steps N] [--top K] [--raw]

--steps divides totals into per-step numbers; by default the steps are the
sum of K over the training loop's dispatch annotations (``gan_dispatch:K``,
one host range per dispatch of K steps, gantts_tpu_torch/train/loop.py).
--raw lists the largest single device events with their full names.  A
trace without device events (a run on the CPU) is an error.

``device_ms(trace, steps)`` is the library counterpart of the JAX tool's
``jit_device_ms``; ``KERNEL_GROUPS`` groups kernel names into the port's
kernels for chip_smoke.py's breakdowns.  This tool imports torch and the
port, and neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import math
import os
import re
import sys
import tempfile
from os.path import dirname

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

from gantts_tpu_torch.train.graphs import KERNEL_FUNCTIONS  # noqa: E402
from gantts_tpu_torch.train.loop import DISPATCH_SPAN  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_DISPATCH = re.compile(rf"^{DISPATCH_SPAN}:(\d+)$")

# The port's kernels and the library's GEMMs, by substrings of the
# lower-cased kernel names, for a breakdown of a step's device time; the
# first group a name matches takes it.
KERNEL_GROUPS = (("sru_proj_gemm", ("proj_gemm",)),
                 ("sru_fwd_scan", ("sru_fwd_scan",)),
                 ("sru_bwd_scan", ("sru_bwd_scan",)),
                 ("lstm_fwd_scan", ("lstm_fwd_kernel",
                                    "lstm_fwd_cluster_kernel",
                                    "lstm_fwd_flag_kernel")),
                 ("lstm_bwd_scan", ("lstm_bwd_kernel",
                                    "lstm_bwd_cluster_kernel",
                                    "lstm_bwd_flag_kernel")),
                 ("linear_recurrence_fwd", ("linear_recurrence_fwd",)),
                 ("linear_recurrence_bwd", ("linear_recurrence_bwd",)),
                 ("library GEMMs (dx, dW, D, head, MLPG)",
                  ("gemm", "cutlass", "xmma", "cublas", "nvjet")))


class NoDeviceEvents(ValueError):
    """The trace holds no kernel, copy or fill."""


def trace_file(path):
    """``path`` itself, or the newest ``*.json`` / ``*.json.gz`` under the
    directory ``path``."""
    if os.path.isfile(path):
        return path
    found = [p for pattern in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(path, "**", pattern), recursive=True)]
    if not found:
        raise FileNotFoundError(f"no *.json or *.json.gz under {path}")
    return max(found, key=lambda p: (os.path.getmtime(p), p))


def load_events(path):
    """The events of the Chrome trace at ``path`` (a file, or a directory:
    see ``trace_file``), metadata and flow events included."""
    path = trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def profile_events(prof):
    """The events of a stopped ``torch.profiler.profile``, read back from
    its Chrome trace: the one reader serves live profiles and written
    traces alike."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return load_events(path)


def device_events(events):
    """Kernels, copies and fills."""
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X"]


def function_name(name):
    """A demangled kernel name's function: ``void (anonymous
    namespace)::proj_gemm_f32<F32Tile<128, 256, 8, 16> >(float const*,
    ...)`` -> ``proj_gemm_f32``.  The return type (anything before the last
    space outside brackets that precedes the parameter list), template
    arguments, parameters and anonymous namespaces go; named namespaces
    stay."""
    s = name.strip().replace("(anonymous namespace)::", "")
    depth, start = 0, 0
    for i, ch in enumerate(s):
        if ch == "(" and depth == 0:
            break
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == " " and depth == 0:
            start = i + 1
    return re.match(r"[^<(]*", s[start:]).group(0).strip() or name


def category(event):
    """A device event's row in the table: a kernel's function name, a
    copy's or fill's own name."""
    if event.get("cat") == "kernel":
        return function_name(event["name"])
    return event["name"]


def dispatch_steps(events):
    """The steps of the training loop's dispatch annotations (the host
    ranges ``gan_dispatch:K``; their device mirrors are not counted), or
    None when the trace has none."""
    ks = [int(m.group(1)) for e in events if e.get("ph") == "X"
          and e.get("cat") != "gpu_user_annotation"
          for m in [_DISPATCH.match(e.get("name", ""))] if m]
    return sum(ks) if ks else None


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _span(e):
    return e["ts"], e["ts"] + e.get("dur", 0)


Reading = collections.namedtuple(
    "Reading", "steps busy_ms summed_ms wall_ms idle ms n")
Reading.__doc__ = """Per-step figures of a trace: ``busy_ms`` (the union of
the device intervals), ``summed_ms``, ``wall_ms``, ``idle`` (1 - busy /
wall), ``ms`` and ``n`` (each key's ms and launches per step)."""


def read(events, steps=None, span=None, key=category):
    """Per-step figures of ``events``.  ``steps``: the divisor (default:
    ``dispatch_steps``); ``span``: the name of a host range that holds the
    steps, whose length is the traced wall and outside which device events
    are not read (default: the extent of all events, and all of them);
    ``key(event)``: the table's rows (default: ``category``)."""
    events = [e for e in events if e.get("ph") == "X"]
    dev = device_events(events)
    if span is not None:
        ranges = [_span(e) for e in events if e.get("name") == span
                  and e.get("cat") != "gpu_user_annotation"]
        if not ranges:
            raise ValueError(f"the trace holds no host range {span!r}")
        t0, t1 = ranges[0]
        dev = [e for e in dev if t0 <= e["ts"] <= t1]
    elif events:
        t0 = min(e["ts"] for e in events)
        t1 = max(_span(e)[1] for e in events)
    if not dev:
        raise NoDeviceEvents("the trace holds no device events (kernels, "
                             "copies or fills): was it taken on the CPU?")
    steps = steps or dispatch_steps(events)
    if not steps:
        raise ValueError("the trace holds no dispatch annotation "
                         f"({DISPATCH_SPAN}:K): give the steps it holds")
    ms, n = collections.Counter(), collections.Counter()
    for e in dev:
        ms[key(e)] += e.get("dur", 0) / 1e3 / steps
        n[key(e)] += 1 / steps
    busy = union_us([_span(e) for e in dev]) / 1e3 / steps
    wall = (t1 - t0) / 1e3 / steps
    return Reading(steps, busy, sum(ms.values()), wall, 1 - busy / wall, ms,
                   n)


def device_ms(trace, steps=None, span=None):
    """Device busy ms per step of a trace (a path as ``load_events`` takes
    it, or its events), within the host range ``span`` if given (see
    ``read``): the counterpart of the JAX tool's ``jit_device_ms``."""
    events = load_events(trace) if isinstance(trace, (str, os.PathLike)) \
        else trace
    return read(events, steps, span).busy_ms


def group_ms(per_name):
    """``per_name`` (kernel name -> ms) summed into KERNEL_GROUPS, in their
    order, and "the rest"."""
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    rest = 0.0
    for name, t in per_name.items():
        low = name.lower()
        for g, keys in KERNEL_GROUPS:
            if any(k in low for k in keys):
                groups[g] += t
                break
        else:
            rest += t
    return list(groups.items()) + [("the rest", rest)]


def kernel_launches(events):
    """Launches of each of the port's kernels among the device events, by
    its counter's name (graphs.KERNEL_FUNCTIONS: the kernel its wrapper
    launches once a call)."""
    names = collections.Counter(e["name"] for e in device_events(events)
                                if e.get("cat") == "kernel")
    return {k: sum(n for name, n in names.items() if pattern.search(name))
            for k, pattern in KERNEL_FUNCTIONS.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Device time by kernel in a torch.profiler Chrome trace")
    p.add_argument("trace", help="a trace file, or a directory holding one")
    p.add_argument("--steps", type=int, default=0,
                   help="traced step count (default: from the dispatch "
                        "annotations)")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--raw", action="store_true",
                   help="largest single device events, full names")
    args = p.parse_args(argv)

    path = trace_file(args.trace)
    events = load_events(path)
    dev = device_events(events)
    print(f"trace: {path}, {len(events)} events, {len(dev)} device events")
    if not dev:
        sys.exit("the trace holds no device events (kernels, copies or "
                 "fills): was it taken on the CPU?")
    if args.raw:
        for e in sorted(dev, key=lambda e: -e.get("dur", 0))[:args.top]:
            print(f"{e.get('dur', 0) / 1e3:8.3f} ms  {e.get('cat'):10s} "
                  f"{e['name'][:160]}")
        return
    try:
        r = read(events, args.steps or None)
    except ValueError as e:
        sys.exit(str(e))
    how = "--steps" if args.steps else "dispatch annotations"
    print(f"steps traced: {r.steps} (from the {how})")
    print(f"per step: device busy {r.busy_ms:.3f} ms, device events summed "
          f"{r.summed_ms:.3f} ms, traced wall {r.wall_ms:.3f} ms, idle share "
          f"{r.idle:.4f}")
    print(f"{'category':64s} {'ms/step':>9s} {'n/step':>8s}")
    shown = 0.0
    for name, ms in r.ms.most_common(args.top):
        shown += ms
        print(f"{name[:64]:64s} {ms:9.3f} {r.n[name]:8.2f}")
    rest = r.summed_ms - shown
    if len(r.ms) > args.top:
        print(f"{'(other)':64s} {rest:9.3f}")


if __name__ == "__main__":
    main()
