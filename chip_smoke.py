#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gantts_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from gantts_tpu_torch/kernels/csrc/;
  3. hold each kernel against its plain PyTorch version at the training
     step's shapes (T=512, B=20, H=512, D in {425, 1024}, both directions,
     relu, float32 and bfloat16), and time both;
  4. the main path: full-width tts_acoustic GAN training steps (6x512
     bidirectional SRU generator, MLP discriminator, dense MLPG, Adagrad,
     bfloat16 compute, dropout on) through the kernels, with every launch
     counter checked;
  5. one small float32 step on the card against the same step on the CPU
     (where every kernel wrapper takes its plain version), same weights,
     and the same step on the card with TF32 matmuls as a control that the
     comparison's limit must catch.

Phase 4 ends with a torch.profiler trace of a few more main-path steps,
which prints where the device time goes and the idle share the trace
measured (nothing is written to disk).

The last lines are a JSON object describing each kernel, the card's name
and power limit as nvidia-smi reports them, and the JSON status line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

T, B, H = 512, 20, 512
LIN_DIM, OUT_DIM = 425, 187
DISC_IN = 60 - 2 + LIN_DIM
SOURCE = "gantts_tpu_torch/kernels/csrc/sru_scan.cu"
REPLACES = {
    "sru_proj_gemm": "gantts_tpu/kernels/sru_scan.py:560",
    "sru_fwd_scan": "gantts_tpu/kernels/sru_scan.py:569",
    "sru_bwd_scan": "gantts_tpu/kernels/sru_scan.py:272",
}
# Limits on max|kernel - plain| / max(max|plain|, 1).  float32: the kernels
# contract multiply-adds and use libm's expf/tanhf where PyTorch runs
# separate elementwise kernels, and sum in another order; the scans compound
# that over 512 sequential steps.  bfloat16: one rounding of an output to
# bf16 is 2^-8 relative, so two roundings apart stay under 1e-2.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_F32_STATE = 1e-4  # c and db are float32 in both I/O dtypes
# Phase 5 limits on |card - cpu| / max(|cpu|, 1e-6), see phase_small_step.
PRE_RTOL = 3e-6   # losses and metrics taken before any parameter update
POST_RTOL = 2e-4  # loss_adv and generator: through the just-updated D
POST_UPDATE = ("loss_adv", "generator")
STEPS, WARMUP = 5, 2  # phase 4: timed steps, after untimed warm-up steps
PROFILE_STEPS = 5     # phase 4's traced steps, after the timed ones


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0), \
        float((a - b).abs().max())


def time_ms(fn, reps):
    for _ in range(3):  # warm-up
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def bench_lengths(rs):
    return np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)


def phase_kernels(dev, card, errs):
    """Phase 3: each kernel against its plain version, and both timed."""
    from gantts_tpu_torch.kernels import sru_scan as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lengths = torch.as_tensor(bench_lengths(np.random.RandomState(0)),
                              device=dev)
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for D in (LIN_DIM, 2 * H):
            x = torch.randn((T, B, D), generator=gen, device=dev).to(dt)
            w = uniform(D, 4 * H)
            zeros = torch.zeros(H, device=dev)
            bias4 = torch.cat([zeros, uniform(H), uniform(H), zeros])
            gh = torch.randn((T, B, H), generator=gen, device=dev).to(dt)
            w_c = w.to(dt)
            x2 = x.reshape(T * B, D)
            u_p = K.sru_proj_gemm_plain(x2, w_c).reshape(T, B, 4 * H)
            checks = [("sru_proj_gemm", "u",
                       K.sru_proj_gemm(x2, w_c).reshape(T, B, 4 * H), u_p,
                       tol)]
            for reverse in (False, True):
                h_k, c_k = K.sru_fwd_scan(u_p, bias4, lengths, reverse, 1)
                h_p, c_p = K.sru_fwd_scan_plain(u_p, bias4, lengths,
                                                reverse, 1)
                du_k, db_k = K.sru_bwd_scan(u_p, bias4, lengths, c_p, gh,
                                            reverse, 1)
                du_p, db_p = K.sru_bwd_scan_plain(u_p, bias4, lengths, c_p,
                                                  gh, reverse, 1)
                dx_k = K.mm_f32(du_k.reshape(T * B, -1), w_c.t())
                dx_p = K.mm_f32(du_p.reshape(T * B, -1), w_c.t())
                dw_k = K.mm_f32(x2.t(), du_k.reshape(T * B, -1))
                dw_p = K.mm_f32(x2.t(), du_p.reshape(T * B, -1))
                checks += [
                    ("sru_fwd_scan", "h", h_k, h_p, tol),
                    ("sru_fwd_scan", "c", c_k, c_p, TOL_F32_STATE),
                    ("sru_bwd_scan", "du", du_k, du_p, tol),
                    ("sru_bwd_scan", "db", db_k, db_p, TOL_F32_STATE),
                    ("sru_bwd_scan", "dx", dx_k, dx_p, tol),
                    ("sru_bwd_scan", "dW", dw_k, dw_p, tol),
                ]
                # the autograd path (kernels chained by fused_sru_proj_layer)
                # against the plain chain fed with the kernel's own u
                xr = x.detach().float().clone().requires_grad_(True)
                wr = w.clone().requires_grad_(True)
                br = bias4.clone().requires_grad_(True)
                h_a = K.fused_sru_proj_layer(
                    xr, wr, lengths, bias4=br, reverse=reverse, use_relu=1,
                    compute_dtype="bfloat16" if dt == torch.bfloat16
                    else "float32")
                h_a.backward(gh)
                u_k = checks[0][2]
                h_q, c_q = K.sru_fwd_scan_plain(u_k, bias4, lengths, reverse,
                                                1)
                du_q, db_q = K.sru_bwd_scan_plain(u_k, bias4, lengths, c_q,
                                                  gh, reverse, 1)
                du_q = du_q.reshape(T * B, -1)
                checks += [
                    ("layer", "h", h_a, h_q, tol),
                    ("layer", "dx", xr.grad,
                     K.mm_f32(du_q, w_c.t()).to(dt).reshape(T, B, D), tol),
                    ("layer", "dW", wr.grad, K.mm_f32(x2.t(), du_q), tol),
                    ("layer", "db", br.grad, db_q, TOL_F32_STATE),
                ]
            for kernel, what, got, ref, lim in checks:
                rel, ab = rel_err(got, ref)
                ok = rel <= lim and math.isfinite(rel)
                print(f"[3] {kernel:13s} {what:2s} {str(dt)[6:]:8s} D={D:4d}"
                      f" rel_err={rel:.3e} abs_err={ab:.3e} limit={lim:.0e}"
                      f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{kernel} {what} disagrees with its plain version")
                if kernel in errs:
                    errs[kernel] = max(errs[kernel], ab)

    # times at the main path's shapes: bf16 I/O, D=1024 (layers 1-5)
    times = {}
    for dt in (torch.bfloat16, torch.float32):
        for D in (2 * H, LIN_DIM):
            x2 = torch.randn((T * B, D), generator=gen, device=dev).to(dt)
            w_c = uniform(D, 4 * H).to(dt)
            times[("sru_proj_gemm", dt, D)] = (
                time_ms(lambda: K.sru_proj_gemm(x2, w_c), 20),
                time_ms(lambda: K.sru_proj_gemm_plain(x2, w_c), 20))
        u = torch.randn((T, B, 4 * H), generator=gen, device=dev).to(dt)
        bias4 = uniform(4 * H)
        gh = torch.randn((T, B, H), generator=gen, device=dev).to(dt)
        _, c = K.sru_fwd_scan(u, bias4, lengths, False, 1)
        times[("sru_fwd_scan", dt, None)] = (
            time_ms(lambda: K.sru_fwd_scan(u, bias4, lengths, False, 1), 20),
            time_ms(lambda: K.sru_fwd_scan_plain(u, bias4, lengths, False,
                                                 1), 2))
        times[("sru_bwd_scan", dt, None)] = (
            time_ms(lambda: K.sru_bwd_scan(u, bias4, lengths, c, gh, False,
                                           1), 20),
            time_ms(lambda: K.sru_bwd_scan_plain(u, bias4, lengths, c, gh,
                                                 False, 1), 2))
    for (kernel, dt, D), (ms, plain_ms) in times.items():
        shape = f"D={D} " if D else ""
        print(f"[3] time {kernel:13s} {str(dt)[6:]:8s} {shape}"
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]")
    return {k: times[(k, torch.bfloat16, 2 * H if k == "sru_proj_gemm"
                      else None)] for k in REPLACES}


def acoustic_hp(compute_dtype, **gen_overrides):
    from gantts_tpu_torch._shared import hparams

    hp = hparams.tts_acoustic.copy()
    hp.compute_dtype = compute_dtype
    hp.generator_params.update(in_dim=LIN_DIM, out_dim=OUT_DIM,
                               **gen_overrides)
    hp.discriminator_params.update(in_dim=DISC_IN)
    return hp


def make_trainer(hp, dev):
    from gantts_tpu_torch.train import GanTrainer, StepConfig

    cfg = StepConfig.from_hparams(hp, w_d=1.0, mse_w=0.0, mge_w=1.0,
                                  update_d=True, update_g=True)
    return GanTrainer(cfg, np.zeros(OUT_DIM, np.float32),
                      np.ones(OUT_DIM, np.float32), dev)


def phase_main_path(dev, card):
    """Phase 4: full-width bf16 training steps through the kernels."""
    from gantts_tpu_torch._shared import unit_variance_mlpg_matrix
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = acoustic_hp("bfloat16")
    model_g, model_d, _, _, gstate, dstate = init_models_and_states(
        hp, seed=0, device=dev)
    n_params = sum(p.numel() for p in model_g.parameters())
    print(f"[4] generator {n_params} parameters, discriminator "
          f"{sum(p.numel() for p in model_d.parameters())}")
    trainer = make_trainer(hp, dev)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(B, T, LIN_DIM).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.rand(B, T, OUT_DIM).astype(np.float32), device=dev)
    lh = bench_lengths(rs)
    lengths = torch.as_tensor(lh, device=dev)
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    for _ in range(WARMUP):
        gstate, dstate, out = trainer.step(gstate, dstate, x, y, lengths, R,
                                           1.0, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    for _ in range(STEPS):
        gstate, dstate, out = trainer.step(gstate, dstate, x, y, lengths, R,
                                           1.0, gen)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)

    for i, out in enumerate(outs):
        vals = {k: float(v) for k, v in out.items()}
        print(f"[4] step {i}: " + " ".join(
            f"{k}={v:.6g}" for k, v in vals.items()))
        for k in ("discriminator", "loss_real_d", "loss_fake_d", "mge",
                  "mse", "loss_adv", "generator", "mcd", "bap_mcd",
                  "vuv_err"):
            if not math.isfinite(vals[k]):
                fail(f"step {i}: {k} is not finite ({vals[k]})")
    for p in list(model_g.parameters()) + list(model_d.parameters()):
        if not torch.isfinite(p).all():
            fail("a parameter is not finite after the steps")
    for name, n in counts.items():
        print(f"[4] launches {name}: {n} in {STEPS} steps")
        if n != 12 * STEPS:
            fail(f"{name} launched {n} times in {STEPS} steps, "
                 f"expected {12 * STEPS}")
    ms = dt / STEPS * 1e3
    fps = float(lh.sum()) * STEPS / dt
    print(f"[4] tts_acoustic step B={B} T={T} bf16: {ms:.3f} ms/step, "
          f"{fps:.1f} frames/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)  [{card}]")

    def run_steps(n):
        nonlocal gstate, dstate
        for _ in range(n):
            gstate, dstate, _ = trainer.step(gstate, dstate, x, y, lengths,
                                             R, 1.0, gen)
    return counts, ms, run_steps


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


KERNEL_GROUPS = (("sru_proj_gemm", ("proj_gemm",)),
                 ("sru_fwd_scan", ("sru_fwd_scan",)),
                 ("sru_bwd_scan", ("sru_bwd_scan",)),
                 ("library GEMMs (dx, dW, D, head, MLPG)",
                  ("gemm", "cutlass", "xmma", "cublas", "nvjet")))


def phase_profile(run_steps, ms_unprofiled, card):
    """Trace PROFILE_STEPS more main-path steps with torch.profiler.

    Device busy time is the union of the trace's device intervals (kernels,
    copies, fills; not annotations); the idle share is 1 - busy / the traced wall span of
    the steps, both from this one trace.  The profiler adds host time per
    launch, so that idle share is an upper bound for an unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_steps"):
            run_steps(PROFILE_STEPS)
            torch.cuda.synchronize()
    events = prof.events()
    span = [e for e in events if e.name == "chip_smoke_steps"]
    # Device-side copies of host ranges (record_function and the optimizer's
    # annotations) are user annotations, not device work: leave them out.
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in host_names
           and e.time_range.end > e.time_range.start]
    if not span or not dev:
        print(f"[P] the trace holds no device activity: device time not "
              f"measured  [{card}]")
        return
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    wall = (t1 - t0) / 1e3 / PROFILE_STEPS
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in dev]) / 1e3 / PROFILE_STEPS
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3 / PROFILE_STEPS
    summed = sum(per_name.values())
    print(f"[P] {PROFILE_STEPS} traced steps: wall {wall:.3f} ms/step "
          f"(unprofiled {ms_unprofiled:.3f}), device busy {busy:.3f} "
          f"ms/step, idle share {1 - busy / wall:.4f} of the traced wall; "
          f"device events summed {summed:.3f} ms/step  [{card}]")
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
    for g, t in list(groups.items()) + [("the rest", rest)]:
        print(f"[P]   {g:40s} {t:8.3f} ms/step {100 * t / summed:5.1f}%")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[P]   top {t:8.3f} ms/step  {name[:90]}")


def phase_small_step(dev):
    """Phase 5: a small float32 step (dropout off) on the card against the
    same step on the CPU, from the same weights.

    Losses and metrics taken before any update must agree to PRE_RTOL: the
    card and the CPU differ there only in summation order and in libm's
    exp/tanh against PyTorch's.  loss_adv and generator are taken through
    the discriminator after its Adagrad step, whose first update is about
    +-lr * sign(g) for any |g|, so an element whose gradient is rounding
    noise may move the other way: POST_RTOL.  The control is the same step
    on the card with TF32 matmuls (10-bit mantissa) in the discriminator,
    the head, MLPG and dx/dW; its pre-update gap must exceed PRE_RTOL, or
    the comparison could not see such a slip.  Both limits sit between
    readings on an H100 (700 W): the largest sound gaps were 2.7e-7
    (pre-update) and 7.1e-6 (post-update), the control's 3.9e-5 and
    5.9e-3."""
    from gantts_tpu_torch._shared import unit_variance_mlpg_matrix
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = acoustic_hp("float32", num_hidden=2, hidden_dim=64, dropout=0.0,
                     rnn_dropout=0.0)
    hp.discriminator_params.update(dropout=0.0)
    Ts, Bs = 64, 4
    rs = np.random.RandomState(1)
    batch = [rs.rand(Bs, Ts, LIN_DIM).astype(np.float32),
             rs.rand(Bs, Ts, OUT_DIM).astype(np.float32),
             np.r_[rs.randint(Ts // 2, Ts, Bs - 1), Ts].astype(np.int32),
             unit_variance_mlpg_matrix(hp.windows, Ts)]
    states = []

    def run(device, tf32):
        _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=1,
                                                            device=device)
        if not states:  # copies: the step updates parameters in place
            states.extend({k: v.detach().clone()
                           for k, v in s.model.state_dict().items()}
                          for s in (gstate, dstate))
        else:
            gstate.model.load_state_dict(states[0])
            dstate.model.load_state_dict(states[1])
        x, y, lengths, R = (torch.as_tensor(a, device=device) for a in batch)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            _, _, out = make_trainer(hp, device).step(gstate, dstate, x, y,
                                                      lengths, R, 1.0)
            out = {k: float(v) for k, v in out.items()}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return out

    cpu = run(torch.device("cpu"), False)
    card, control = run(dev, False), run(dev, True)

    def gap(a, b):
        if math.isnan(a) and math.isnan(b):
            return 0.0
        return abs(a - b) / max(abs(b), 1e-6)

    worst, worst_control = 0.0, 0.0
    for k in cpu:
        lim = POST_RTOL if k in POST_UPDATE else PRE_RTOL
        g, gc = gap(card[k], cpu[k]), gap(control[k], cpu[k])
        ok = g <= lim
        print(f"[5] {k:20s} card={card[k]:.8g} cpu={cpu[k]:.8g} "
              f"gap={g:.2e} limit={lim:.0e} {'ok' if ok else 'FAIL'}  "
              f"control(tf32) gap={gc:.2e}")
        if not ok:
            fail(f"small step: {k} on the card differs from the CPU")
        if k not in POST_UPDATE:
            worst, worst_control = max(worst, g), max(worst_control, gc)
    print(f"[5] pre-update: largest gap {worst:.2e}, limit {PRE_RTOL:.0e}, "
          f"control's largest gap {worst_control:.2e}")
    if not worst_control > PRE_RTOL:
        fail("small step: the TF32 control stays within the limit, so the "
             "comparison cannot see a TF32 matmul")


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    from gantts_tpu_torch.core import paramgen  # noqa: F401  (TF32 off)
    from gantts_tpu_torch.kernels import _build, sru_scan

    print(f"[1] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    sru_scan._lib()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in _build.build_log.items():
        print(f"[2] nvcc {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[2]   {line.strip()}")

    errs = {k: 0.0 for k in REPLACES}
    times = phase_kernels(dev, card, errs)
    counts, ms, run_steps = phase_main_path(dev, card)
    phase_profile(run_steps, ms, card)
    phase_small_step(dev)

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": counts[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
