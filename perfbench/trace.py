"""Reading a torch.profiler Chrome trace: device events, busy time as the
union of their intervals, kernels by function and group, the training
loop's dispatch ranges, and the idle gaps named by what the host was doing.

The arithmetic is a frozen copy of the repository's trace report
(``tools/torch_trace_report.py``), with the kernel-name patterns of the
port's launch counters, so that a change to the program cannot move the
yardstick.
"""

from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
DISPATCH = re.compile(r"^gan_dispatch:(\d+)$")
FETCH = re.compile(r"^perfbench\.fetch:(\w+)$")

# The kernel each of the port's launch counters counts, by the counter's
# name (a wrapper launches one a call; the f32 GEMM's split-K sum is a
# second kernel of the same call, not counted).
COUNTED_KERNELS = {name: re.compile(pattern) for name, pattern in (
    ("sru_proj_gemm", r"proj_gemm_(?:f32|bf16)(?!_split)"),
    ("sru_fwd_scan", r"sru_fwd_scan_kernel"),
    ("sru_bwd_scan", r"sru_bwd_scan_kernel"),
    ("lstm_fwd_scan", r"lstm_fwd_(?:cluster_|flag_)?kernel"),
    ("lstm_bwd_scan", r"lstm_bwd_(?:cluster_|flag_)?kernel"),
    ("linear_recurrence_fwd", r"linear_recurrence_fwd_kernel"),
    ("linear_recurrence_bwd", r"linear_recurrence_bwd_kernel"))}

# Groups of kernels by substrings of their lower-cased function names; the
# first group a name matches takes it.
RECURRENCE = ("sru_fwd_scan", "sru_bwd_scan", "lstm_fwd", "lstm_bwd",
              "linear_recurrence")
GEMM = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitkreduce",
        "dot_kernel")


def load(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def device_events(events):
    """Kernels, copies and fills."""
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def span(e):
    return e["ts"], e["ts"] + e.get("dur", 0)


def union(intervals):
    """The union of (start, end) intervals: its length and its pieces."""
    total, pieces = 0.0, []
    for a, b in sorted(intervals):
        if pieces and a <= pieces[-1][1]:
            if b > pieces[-1][1]:
                total += b - pieces[-1][1]
                pieces[-1][1] = b
        else:
            total += b - a
            pieces.append([a, b])
    return total, pieces


def function_name(name):
    """A demangled kernel name's function: no return type, template
    arguments, parameter list or anonymous namespace."""
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


def category(e):
    return function_name(e["name"]) if e.get("cat") == "kernel" \
        else e["name"]


def group(e):
    """``recurrence``, ``gemm``, or None."""
    if e.get("cat") != "kernel":
        return None
    low = function_name(e["name"]).lower()
    if any(k in low for k in RECURRENCE):
        return "recurrence"
    if any(k in low for k in GEMM):
        return "gemm"
    return None


def counted_launches(events):
    """Launches of the port's counted kernels among the device events."""
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: sum(bool(p.search(n)) for n in names)
            for k, p in COUNTED_KERNELS.items()}


def host_ranges(events):
    return [e for e in events if e.get("cat") in HOST_CATS]


def dispatches(events):
    """(start, K, phase) of each of the loop's dispatch ranges
    (``gan_dispatch:K``), the phase that of the latest fetch range
    (``perfbench.fetch:<phase>``) begun before it."""
    fetches = sorted((e["ts"], m.group(1)) for e in events
                     if e.get("cat") == "user_annotation"
                     for m in [FETCH.match(e.get("name", ""))] if m)
    out = []
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        m = DISPATCH.match(e.get("name", ""))
        if not m:
            continue
        phase = None
        for ts, p in fetches:
            if ts > e["ts"]:
                break
            phase = p
        out.append((e["ts"], int(m.group(1)), phase))
    return sorted(out)


def idle_gaps(pieces, t0, t1, hosts, top=10):
    """The ``top`` longest stretches of [t0, t1] without device work, each
    named by the innermost host range over its middle: [[name, s], ...]."""
    edges = [t0] + [x for p in pieces for x in p] + [t1]
    gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        inside = [h for h in hosts if h["ts"] <= mid <= h["ts"] + h["dur"]]
        name = min(inside, key=lambda h: h["dur"])["name"] if inside \
            else "(no host range)"
        out.append([name, length / 1e6])
    return out


def top_ops(dev, top=10):
    """The device operations that took most time: [[name, s], ...]."""
    acc = {}
    for e in dev:
        acc[category(e)] = acc.get(category(e), 0.0) + e.get("dur", 0) / 1e6
    return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[
        :top]


def seconds(dev, which):
    """Summed device seconds of the events of group ``which``."""
    return sum(e.get("dur", 0) for e in dev if group(e) == which) / 1e6


def extent(events):
    """The first and the last moment of a trace's events."""
    return (min(e["ts"] for e in events),
            max(e["ts"] + e.get("dur", 0) for e in events))
