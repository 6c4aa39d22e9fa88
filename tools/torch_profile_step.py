#!/usr/bin/env python3
"""Ablation profile of the GAN step on the port (counterpart of
tools/profile_step.py, which profiles the JAX package on a TPU).

Times each component of the step at the JAX tool's workload shape (B=20,
T=512, 425 -> 187, the shipped 6x512 bidirectional relu SRU generator, the
3x256 MLP discriminator, float32 by default) to localize the bottleneck:
the full G+D step, eager (one step a dispatch) and at the command line's
default of 16 steps a CUDA graph replay (``GanTrainer.multi_step``); G
forward; G forward and backward through the MGE loss (``multi_stream_mlpg``);
MLPG forward; D forward; the SRU trunk (``models/sru.py`` ``SRU``, no
head) forward and forward+backward; the G optimizer update (Adagrad over
G's parameters); a 3-layer bidirectional ``StackedLSTM`` trunk forward and
forward+backward; and a pure-matmul lower bound for the SRU trunk: 12
``torch.matmul`` of (B*T, 2H) @ (2H, 4H) in the compute dtype, the trunk's
projection FLOPs (TF32 stays off in float32), and 3x that for forward and
backward.  ``--layer-ablation`` decomposes one bidirectional layer's
direction: ``SRULayer`` forward and forward+backward, its projection
matmul, ``kernels.fused_sru_layer`` (the scan from u) forward and
forward+backward, and the concat of both directions.

Timing.  On the card each component's time is the median of synchronized
calls, each timed by CUDA events, after warm-up calls; beside it stands the
device busy time of a few more calls in a torch.profiler trace, read by
tools/torch_trace_report.py's ``device_ms`` (the JAX tool's method; calls
before and after them open and close the trace and are not read).  A trace can drop the
kernel events of graph replays, so both columns are printed.  Each row also gives the port's kernels launched a call, from the
kernels' launch counters.  On the CPU (``--device cpu``, where every kernel
wrapper takes its plain version) the host clock times the calls and no
device column is printed.

One row differs from the JAX tool's on purpose: the layer ablation slices
the layer input as x[..., :2H], which at full width holds x's 425 columns
only (the JAX tool's layer is then a first layer, and its projection row
reshapes 10240 x 425 into 4250 x 1024); here x's columns are repeated to
2H, so that the layer and its projection have the trunk's middle-layer
shapes (D = 1024).  Where x has 2H columns or more the two agree.

usage: python tools/torch_profile_step.py [--trace-dir DIR]
           [--compute-dtype float32|bfloat16] [--mlpg dense|stencil]
           [--batch 20] [--layer-ablation] [--device cuda|cpu]
           [--steps-per-dispatch 16] [--hparams ...] [--frames 512]
           [--json FILE]

``--trace-dir`` writes a Chrome trace of 3 more eager full steps there,
which ``python tools/torch_trace_report.py DIR`` reads; ``--json`` writes
the rows (name, wall_ms, device_ms, launches a call, calls), the G
parameter count and frames/s to FILE.  ``--hparams`` (the
command line's override syntax) and ``--frames`` serve the CPU tests' small
sizes.  ``build_components`` returns the components as plain callables.
This tool imports torch and the port, and neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from os.path import dirname

import numpy as np
import torch

sys.path.insert(0, dirname(dirname(os.path.abspath(__file__))))

LIN_DIM, OUT_DIM = 425, 187
DISC_IN = 60 - 2 + LIN_DIM
WARMUP, CALLS, TRACED = 2, 10, 3      # calls a component
K_WARMUP, K_CALLS, K_TRACED = 2, 5, 2  # replays of the K-step row
TRACE_DIR_STEPS = 3
TRACE_RANGE = "profile_step_calls"  # a row's traced calls, on the host


def make_hp(compute_dtype="float32", mlpg="dense", overrides=""):
    """The tts_acoustic bundle at the JAX tool's widths (425 -> 187, the
    discriminator on [linguistic | mgc statics 2..59]), after
    ``overrides``."""
    from gantts_tpu_torch import hparams

    hp = hparams.tts_acoustic.copy()
    hp.parse(overrides)
    hp.compute_dtype = compute_dtype
    hp.mlpg_impl = mlpg
    hp.generator_params.update(in_dim=LIN_DIM, out_dim=OUT_DIM)
    hp.discriminator_params.update(in_dim=DISC_IN)
    return hp


class Component:
    """A named callable: one call runs ``steps`` training steps (1 but for
    the K-step row) and returns what it computes."""

    def __init__(self, name, fn, steps=1):
        self.name, self.fn, self.steps = name, fn, steps

    def __call__(self):
        return self.fn()


class Components:
    """What ``build_components`` made: ``rows`` (Components in the JAX
    tool's order), ``arrays`` (the numpy inputs, drawn in the JAX tool's
    order), ``modules`` (generator, discriminator, sru, layer, lstm),
    ``full`` (one eager step) and ``frames`` (the batch's valid
    frames)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def row(self, name):
        return next(c for c in self.rows if c.name == name)


def _evaluate(module, *args):
    module.eval()
    with torch.no_grad():
        return module(*args)


def _grads(loss, module):
    return torch.autograd.grad(loss, list(module.parameters()))


def build_components(hp, B, T, device, seed=0, layer_ablation=False,
                     steps_per_dispatch=16):
    """The components of the step for ``hp`` at B x T on ``device``, with
    weights from ``seed`` and the JAX tool's inputs from
    ``RandomState(seed)``."""
    from gantts_tpu_torch.core.masking import masked_mse_loss, sequence_mask
    from gantts_tpu_torch.core.paramgen import multi_stream_mlpg
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.kernels.sru_scan import fused_sru_layer
    from gantts_tpu_torch.models.recurrent import StackedLSTM
    from gantts_tpu_torch.models.sru import SRU, SRULayer
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.loop import dispatch_span
    from gantts_tpu_torch.train.setup import init_models_and_states

    device = torch.device(device)
    gp = hp.generator_params
    H, L = gp["hidden_dim"], gp["num_hidden"]
    K = steps_per_dispatch
    cd = hp.compute_dtype
    mm_dtype = torch.bfloat16 if cd == "bfloat16" else torch.float32
    f32 = np.float32

    rs = np.random.RandomState(seed)
    a = {}
    a["x"] = rs.rand(B, T, LIN_DIM).astype(f32)
    a["y"] = rs.rand(B, T, OUT_DIM).astype(f32)
    a["lengths"] = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    a["R"] = unit_variance_mlpg_matrix(hp.windows, T)
    a["xd"] = rs.rand(B, T, hp.discriminator_params["in_dim"]).astype(f32)
    a["xs_mm"] = rs.rand(B * T, 2 * H).astype(f32)
    a["ws_mm"] = (rs.rand(12, 2 * H, 4 * H) * 0.01).astype(f32)
    if layer_ablation:
        a["w1"] = (rs.rand(2 * H, 4 * H) * 0.01).astype(f32)
        a["u1"] = rs.rand(T, B, 4 * H).astype(f32)
        a["h2"] = rs.rand(T, B, H).astype(f32)

    def on(name, dtype=None):
        t = torch.as_tensor(a[name], device=device)
        return t if dtype is None else t.to(dtype)

    x, y, lengths, R, xd = (on(n) for n in ("x", "y", "lengths", "R", "xd"))
    streams = (tuple(hp.stream_sizes), tuple(hp.has_dynamic_features))

    model_g, model_d, _, _, gstate, dstate = init_models_and_states(
        hp, seed=seed, device=device)
    cfg = StepConfig.from_hparams(hp, w_d=1.0, mse_w=0.0, mge_w=1.0,
                                  update_d=True, update_g=True)
    trainer = GanTrainer(cfg, np.zeros(OUT_DIM, f32), np.ones(OUT_DIM, f32),
                         device, windows=hp.windows)
    gen = torch.Generator(device=device)  # the step's dropout stream
    gen.manual_seed(seed)
    init = torch.Generator(device=device)  # the trunks' weights
    init.manual_seed(seed + 1)
    adv_w = torch.full((), 1.0, dtype=torch.float32, device=device)
    xs, ys, ls = (t.unsqueeze(0).expand(K, *t.shape)
                  for t in (x, y, lengths))

    def full():
        with dispatch_span(1):
            return trainer.step(gstate, dstate, x, y, lengths, R, adv_w,
                                generator=gen)[2]

    def full_k():
        with dispatch_span(K):
            return trainer.multi_step(gstate, dstate, xs, ys, ls, R, adv_w,
                                      generator=gen)[2]

    y_static_ref = multi_stream_mlpg(y, R, *streams)
    mask = sequence_mask(lengths, T)[..., None]

    def g_fwd_bwd():
        model_g.eval()
        yhs = multi_stream_mlpg(model_g(x, lengths), R, *streams)
        return _grads(masked_mse_loss(yhs, y_static_ref, mask=mask), model_g)

    sru = SRU(LIN_DIM, H, L, gp["bidirectional"], 0.0, 0.0, gp["use_relu"],
              cd, generator=init, device=device)

    def sru_fwd_bwd():
        sru.eval()
        return _grads(torch.sum(sru(x, lengths) ** 2), sru)

    xs_mm, ws_mm = on("xs_mm", mm_dtype), on("ws_mm", mm_dtype)

    def mm_bound():
        with torch.no_grad():
            return sum(torch.sum(xs_mm @ ws_mm[i]) for i in range(12))

    rows = [Component("full G+D step", full),
            Component(f"full G+D step, {K} a replay", full_k, K),
            Component("G forward", lambda: _evaluate(model_g, x, lengths)),
            Component("G fwd+bwd (mge)", g_fwd_bwd),
            Component("MLPG fwd", lambda: multi_stream_mlpg(y, R, *streams)),
            Component("D forward", lambda: _evaluate(model_d, xd, lengths)),
            Component("SRU trunk fwd", lambda: _evaluate(sru, x, lengths)),
            Component("SRU trunk fwd+bwd", sru_fwd_bwd),
            Component("trunk matmul bound fwd", mm_bound)]
    modules = dict(generator=model_g, discriminator=model_d, sru=sru)

    if layer_ablation:
        # the JAX tool's x[..., :2H], with x's columns repeated where it
        # has fewer than 2H (see the module docstring)
        xw = np.concatenate([a["x"]] * math.ceil(2 * H / LIN_DIM), -1)
        a["xe"] = np.ascontiguousarray(np.swapaxes(xw[..., :2 * H], 0, 1))
        xe = on("xe", mm_dtype)
        layer = SRULayer(2 * H, H, gp["use_relu"], cd, generator=init,
                         device=device)
        modules["layer"] = layer
        w1, h2 = on("w1", mm_dtype), on("h2", mm_dtype)
        u1 = on("u1", mm_dtype).requires_grad_(True)
        bias4 = torch.zeros(4 * H, dtype=torch.float32, device=device)

        def layer_fwd_bwd():
            return _grads(torch.sum(layer(xe.float(), lengths).float() ** 2),
                          layer)

        def proj():
            with torch.no_grad():
                return xe.reshape(-1, 2 * H) @ w1

        def kernel_fwd():
            with torch.no_grad():
                return fused_sru_layer(u1, lengths, bias4=bias4,
                                       use_relu=gp["use_relu"])

        def kernel_fwd_bwd():
            h = fused_sru_layer(u1, lengths, bias4=bias4,
                                use_relu=gp["use_relu"])
            return torch.autograd.grad(torch.sum(h.float() ** 2), u1)[0]

        def concat():
            with torch.no_grad():
                return torch.cat([h2, h2], dim=-1) * 1.0

        rows += [Component("1 SRULayer fwd",
                           lambda: _evaluate(layer, xe.float(), lengths)),
                 Component("1 SRULayer fwd+bwd", layer_fwd_bwd),
                 Component("1 layer proj matmul fwd", proj),
                 Component("1 fused kernel fwd", kernel_fwd),
                 Component("1 fused kernel fwd+bwd", kernel_fwd_bwd),
                 Component("1 layer fwd/bwd concat", concat)]

    # the G update alone: clip + Adagrad on gradients of ones, written
    # into the gradients' storage before each call (the clip scales them)
    g_params = list(model_g.parameters())

    def g_update():
        for p in g_params:
            if p.grad is None:
                p.grad = torch.ones_like(p)
            else:
                p.grad.fill_(1.0)
        gstate.optimizer.step()

    lx = x[..., :512] if x.shape[-1] >= 512 else x
    lstm = StackedLSTM(lx.shape[-1], H, 3, bidirectional=True,
                       compute_dtype=cd, generator=init, device=device)
    modules["lstm"] = lstm

    def lstm_fwd_bwd():
        lstm.eval()
        return _grads(torch.sum(lstm(lx, lengths).float() ** 2), lstm)

    rows += [Component("G optimizer update", g_update),
             Component("LSTM trunk 3x fwd",
                       lambda: _evaluate(lstm, lx, lengths)),
             Component("LSTM trunk 3x fwd+bwd", lstm_fwd_bwd)]
    return Components(rows=rows, arrays=a, modules=modules, full=full,
                      frames=float(a["lengths"].sum()))


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    from gantts_tpu_torch.kernels import launch_counts

    return dict(launch_counts)


def trace_calls(fn, calls):
    """The events of a trace (CPU and CUDA) of one call of ``fn``, then
    ``calls`` calls inside the host range TRACE_RANGE, the card idle at
    both ends of it, then ``calls`` more.  A trace can lose the records of
    its first and last kernels (on an H100, in a process that had traced
    much before, a row of one kernel a call kept 1 of its 3), so only the
    range between the opening and closing calls is read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tools.torch_trace_report import profile_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(TRACE_RANGE):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return profile_events(prof)


def measure(component, device, warmup, calls, traced):
    """(wall ms a step: the median of ``calls`` synchronized calls; device
    ms a step from a trace of ``traced`` more calls, None on the CPU; the
    kernels launched a call; the calls made)."""
    from tools.torch_trace_report import device_ms

    before = _launches()
    for _ in range(warmup):
        component()
    _synchronize(device)
    times = []
    for _ in range(calls):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            component()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            component()
            times.append((time.perf_counter() - t0) * 1e3)
    dev_ms = None
    if device.type == "cuda":
        dev_ms = device_ms(trace_calls(component, traced),
                           traced * component.steps, span=TRACE_RANGE)
    n = warmup + calls + (2 * traced + 1 if device.type == "cuda" else 0)
    launched = {k: (v - before[k]) / n for k, v in _launches().items()
                if v != before[k]}
    return statistics.median(times) / component.steps, dev_ms, launched, n


def profile_rows(comps, device):
    """Measure every component: rows of dicts (name, wall_ms, device_ms,
    launches a call, calls); the matmul bound's 3x row derived, as in the
    JAX tool."""
    rows = []
    for c in comps.rows:
        fused = c.steps > 1
        wall, dev, launched, calls = measure(
            c, device, K_WARMUP if fused else WARMUP,
            K_CALLS if fused else CALLS, K_TRACED if fused else TRACED)
        rows.append(dict(name=c.name, wall_ms=wall, device_ms=dev,
                         launches=launched, calls=calls))
        if c.name == "trunk matmul bound fwd":
            rows.append(dict(name="trunk matmul bound f+b (3x)",
                             wall_ms=3 * wall,
                             device_ms=None if dev is None else 3 * dev,
                             launches={}, calls=0))
    return rows


def write_trace(comps, device, trace_dir):
    """A Chrome trace of TRACE_DIR_STEPS more eager full steps in
    ``trace_dir``, each inside its dispatch span (``gan_dispatch:1``: the
    trace is read as one phase of the training loop)."""
    from torch.profiler import ProfilerActivity, profile

    from gantts_tpu_torch import tracing

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, tracing.phase("train"):
        for _ in range(TRACE_DIR_STEPS):
            comps.full()
        _synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace_full_step.json")
    prof.export_chrome_trace(path)
    return path


def build_arg_parser():
    p = argparse.ArgumentParser(
        description="Ablation profile of the port's GAN step")
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--mlpg", default="dense", choices=["dense", "stencil"])
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--layer-ablation", action="store_true",
                   help="decompose one biSRU layer: projection matmul vs "
                        "the scan kernel from u vs concat (fwd and fwd+bwd)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps-per-dispatch", type=int, default=16,
                   help="steps of the replayed full-step row (the command "
                        "line's default)")
    p.add_argument("--hparams", default="",
                   help="overrides of the tts_acoustic bundle (the command "
                        "line's syntax), for small CPU runs")
    p.add_argument("--frames", type=int, default=512,
                   help="T, the batch's padded length")
    p.add_argument("--json", default=None,
                   help="also write the rows to this file as JSON")
    return p


def main(argv=None):
    """Profile as ``argv`` says and print the table; returns a dict of the
    rows, the G parameter count, frames/s and the device."""
    args = build_arg_parser().parse_args(argv)
    if args.steps_per_dispatch < 1:
        raise SystemExit("--steps-per-dispatch must be at least 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu")
    from gantts_tpu_torch.core import paramgen  # noqa: F401  (TF32 off)

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    hp = make_hp(args.compute_dtype, args.mlpg, args.hparams)
    B, T, K = args.batch, args.frames, args.steps_per_dispatch
    print(f"device: {name}; compute_dtype: {hp.compute_dtype}, mlpg: "
          f"{hp.mlpg_impl}, {K} steps a replay", flush=True)
    comps = build_components(hp, B, T, device, layer_ablation=(
        args.layer_ablation), steps_per_dispatch=K)
    rows = profile_rows(comps, device)

    n_params = sum(p.numel() for p in comps.modules["generator"].parameters())
    card = device.type == "cuda"
    print(f"\nG params: {n_params / 1e6:.1f}M   B={B} T={T}")
    print(f"{'component':30s} {'wall ms' if card else 'host ms':>10s} "
          f"{'device ms' if card else '':>10s}  kernels launched a call")
    for r in rows:
        dev = f"{r['device_ms']:10.3f}" if r["device_ms"] is not None \
            else " " * 10
        kern = ", ".join(f"{k} {n:g}" for k, n in r["launches"].items())
        print(f"{r['name']:30s} {r['wall_ms']:10.3f} {dev}  {kern}")
    fps = {}
    for r in rows[:2]:
        fps[r["name"]] = {
            "wall": comps.frames / (r["wall_ms"] / 1e3),
            "device": (comps.frames / (r["device_ms"] / 1e3)
                       if r["device_ms"] else None)}
        dev = f" / {fps[r['name']]['device']:,.0f} device" if card else ""
        print(f"frames/sec, {r['name']}: "
              f"{fps[r['name']]['wall']:,.0f} wall{dev}")

    if args.trace_dir:
        print("trace ->", write_trace(comps, device, args.trace_dir))
    result = dict(device=name, rows=rows, g_params=n_params,
                  frames_per_sec=fps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return dict(result, components=comps)


if __name__ == "__main__":
    main()
