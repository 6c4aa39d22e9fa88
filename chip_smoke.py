#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gantts_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from gantts_tpu_torch/kernels/csrc/, one nvcc
     per source, all started together, and check with cuobjdump that the
     bf16 GEMM's SASS holds wgmma (HGMMA) and TMA loads (UTMALDG), and
     that each instance of the f32 GEMM holds FFMA and vector shared-memory
     loads (LDS.64/128), and each f32 LSTM kernel (the flag design's and
     the cooperative one's) FFMA, and that none of these f32 kernels holds
     local-memory traffic (LDL/STL, a spill) or a tensor-core instruction
     (HMMA/HGMMA);
  3. hold each kernel against its plain PyTorch version at the training
     steps' shapes (T=512, B=20, H=512, D in {425, 1024}, float32 and
     bfloat16; the SRU kernels in both directions with relu, the LSTM
     kernels with two directions and with one, forward and reversed; (3c)
     the linear recurrence of the k=3 SRU layer in float32, with ragged
     lengths; the bf16 GEMM also at the LSTM path's N = 8H; the SRU
     kernels also at (4d)'s shapes, B=32, T=96, D in {416, 1024}; the
     one-direction LSTM kernels and the GEMM also at the VC path's shapes,
     D in {177, 512}, in float32 (the flag design) and bfloat16, and the
     f32 LSTM kernels at phase 9's B=1 and phase 8's batches padded with
     zero-length rows, every LSTM check launched twice for identical bits;
     the SRU GEMM and forward scan also at TTS synthesis's shapes, float32
     at B=1, T=64 with D in {416, 1024} and T=608 with D in {425, 1024};
     the f32 GEMM at every shape the f32 paths give it, F32_GEMM_SHAPES,
     also launched twice for identical bits and timed beside torch.mm
     with TF32 off), and time both,
     beside the library call that computes the same function where there
     is one (cuBLAS for the GEMM, at every (K, N) the main paths give it; a
     cuDNN LSTM layer for the LSTM scans, and the port's f32 layer broken
     down by kernel); the LSTM kernels' launches print the design they took
     (bf16 must take the thread-block-cluster kernels, f32 the flag
     design), beside how many of each kernel's clusters can be resident at
     once;
  4. the main paths, each with its launch counters set to 0 just before
     and checked just after, and every plain version refused while it
     runs: full-width tts_acoustic GAN training steps (MLP discriminator,
     dense MLPG, Adagrad, bfloat16 compute, dropout on) with (4) the 6x512
     bidirectional SRU generator, (4b) the 6x512 bidirectional LSTMRNN
     generator of bench.py's LSTM configuration and (4c) the 6x512
     unidirectional SRU generator, whose layers 1-5 are k=3 layers; and
     (4d) the full-width tts_duration step: the 6x512 bidirectional SRU on
     416 phone-level inputs and 5 durations, the conditioned 3x256 MLP
     discriminator, Adam, B=32 phone sequences of 20-80 phones padded to a
     multiple of 32; the full-width vc GAN step (177 -> 177 at B=20,
     T=512, the 59 -> 2x256 -> 1 discriminator on the static mel-cepstra,
     dense MLPG, Adagrad, bfloat16) with (4e) In2OutRNNHighwayNet, a 3x512
     unidirectional LSTM, and (4f) the bundle's In2OutHighwayNet, whose MLP
     trunk launches none of the kernels; (4g) the shipped tts_acoustic
     step in the bundle's own float32: (4)'s 6x512 bidirectional SRU, the
     f32 kernels (sru_proj_gemm's FMA kernel, 12 launches a step); (4h)
     the vc step of (4e) in the bundle's own float32: the f32 GEMM and the
     flag design's LSTM scans, 3 + 3 + 3 launches a step;
  5. one small float32 step on the card against the same step on the CPU
     (where every kernel wrapper takes its plain version), same weights,
     and the same step on the card with TF32 matmuls as a control that the
     comparison's limit must catch: (5) with an SRU generator, (5b) with an
     LSTMRNN, (5c) with a unidirectional SRU (5-5c with V/UV denormalized
     around 2, so that the F0 error is a number), (5d) with the tts_duration
     bundle (Adam, no MLPG matrix), (5e) with the vc bundle and an
     In2OutRNNHighwayNet (MLPG inside the generator);
  6. the port's training command line (gantts_tpu_torch.train) on a
     synthetic acoustic corpus written by the port's own code: two epochs
     of (4c)'s configuration, then a second stage resumed from both
     checkpoints for one more epoch;
  7. the port's curriculum command (gantts_tpu_torch.curriculum, the
     counterpart of train_gan.sh) with the full-width tts_duration bundle
     on a synthetic phone-level corpus: stages 1-3 and 5, one or two epochs
     each, with each stage's checkpoints, logs and kernel launches checked;
  8. the curriculum command with the vc bundle in its own float32 and a
     full-width In2OutRNNHighwayNet, on a parallel corpus the script makes
     from speech-like waveforms with the port's own WORLD/SPTK analysis:
     all five stages, the spoofing model included, so that stage 5 logs
     the spoofing rate;
  9. the port's VC evaluation command line (gantts_tpu_torch.evaluation_vc)
     with phase 8's generator, with --diffvc and without, over the corpus's
     eval and test wavs: launches per utterance, finite and non-silent
     waveforms, analysis.json, the seconds an utterance takes, and the
     first utterance's prediction against a CPU copy of the generator;
 10. tts_demo.sh on the card: a TTS corpus of wavs and state-aligned HTS
     labels that the script writes, its features by the port's
     prepare_features_tts (in a subprocess), the curriculum command's
     stages 1-3 and 5 for the full-width tts_duration and tts_acoustic
     bundles in their own float32, then the port's TTS evaluation command
     line (gantts_tpu_torch.evaluation_tts) on the baseline and the
     adversarial generators and without the duration model: launches per
     step and per utterance, the wavs and analysis.json, the seconds an
     utterance takes, and the first utterance's predictions of both models
     against CPU copies of the generators.

Each of (4) to (4h) ends with a torch.profiler trace of a few more
of its steps, which prints where the device time goes and the idle share
the trace measured (nothing is written to disk).

The last lines are a JSON object describing each kernel (its launches on
the main paths, its largest error against its plain version, its time, the
plain version's and the library call's, and the least time the card could
take for the same work), the card's name and power limit as nvidia-smi
reports them, and the JSON status line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T, B, H = 512, 20, 512
LIN_DIM, OUT_DIM = 425, 187
DISC_IN = 60 - 2 + LIN_DIM
PHONE_DIM, DUR_DIM, DUR_B = 416, 5, 32  # tts_duration (4d, 7)
VC_DIM, VC_STATIC, VC_FS = 177, 59, 16000  # the vc bundle (4e, 4f, 8, 9)
SRU_SOURCE = "gantts_tpu_torch/kernels/csrc/sru_scan.cu"
LSTM_SOURCE = "gantts_tpu_torch/kernels/csrc/lstm_scan.cu"
LINEAR_SOURCE = "gantts_tpu_torch/kernels/csrc/linear_scan.cu"
# kernel -> (source, the Pallas kernels it replaces)
KERNELS = {
    "sru_proj_gemm": (SRU_SOURCE, "gantts_tpu/kernels/sru_scan.py:560"),
    "sru_fwd_scan": (SRU_SOURCE, "gantts_tpu/kernels/sru_scan.py:569"),
    "sru_bwd_scan": (SRU_SOURCE, "gantts_tpu/kernels/sru_scan.py:272"),
    "lstm_fwd_scan": (LSTM_SOURCE, "gantts_tpu/kernels/lstm_scan.py:624, "
                      "also :162 and :421"),
    "lstm_bwd_scan": (LSTM_SOURCE, "gantts_tpu/kernels/lstm_scan.py:665, "
                      "also :190"),
    "linear_recurrence_fwd": (LINEAR_SOURCE,
                              "gantts_tpu/kernels/sru_scan.py:85"),
    "linear_recurrence_bwd": (LINEAR_SOURCE,
                              "gantts_tpu/kernels/sru_scan.py:101"),
}
# The card's published peaks (H100 SXM, dense): the bound of a kernel is
# the larger of its bytes over HBM_BPS and its operations over the peak of
# their type.
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Limits on max|kernel - plain| / max(max|plain|, 1).  float32: the kernels
# contract multiply-adds and use libm's expf/tanhf where PyTorch runs
# separate elementwise kernels, and sum in another order; the scans compound
# that over 512 sequential steps.  bfloat16: one rounding of an output to
# bf16 is 2^-8 relative, so two roundings apart stay under 1e-2.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_F32_STATE = 1e-4  # c and db are float32 in both I/O dtypes
# LSTM kernels, from readings on an H100 (700 W) at these shapes: float32
# y, c, g4, dxp and db within 2.5e-7, so 1e-5; bfloat16 y, g4 and dxp
# within one output rounding (3.9e-3), so TOL.  In bf16 I/O, c and db are
# float32 but fed by the bf16-rounded h (forward) or dxp (backward) of
# earlier steps: readings 1.4e-4 and 7.9e-5, limit 2e-3.
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSTM_TOL_STATE = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# Phase 5 limits on |card - cpu| / max(|cpu|, 1e-6), see phase_small_step.
PRE_RTOL = 3e-6   # losses and metrics taken before any parameter update
POST_RTOL = 2e-4  # loss_adv and generator: through the just-updated D
# Tensors on max|card - cpu| / max|cpu|, f32, TF32 off: 5e's probe (the
# In2Out generator's own term and its gradients) and phase 9's predicted
# statics.  On an H100 (700 W) the card read 1.16e-6 and 7.43e-7 (summation
# order, libm), the TF32 controls 2.10e-4 to 3.70e-4 in every tensor (a
# 10-bit mantissa): the limit sits about 17x from both.
PROBE_RTOL = 2e-5
VC_Y_RTOL = 2e-5
POST_UPDATE = ("loss_adv", "generator")
# Linear recurrence (3c): the kernels round each product and sum on its
# own, as the plain version's separate PyTorch ops do, but both start each
# chunk of steps from a carry composed through the chunks' affine maps, so
# they agree to rounding (the backward 4.1e-7 of scale on an H100, 700 W);
# limit 1e-6 of scale.
LINEAR_TOL = 1e-6
STEPS, WARMUP = 5, 2  # phase 4: timed steps, after untimed warm-up steps
SLEEP_CYCLES = 10_000_000  # time_ms's head start, about 5 ms at 1.98 GHz
PROFILE_STEPS = 5     # phase 4's traced steps, after the timed ones


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0), \
        float((a - b).abs().max())


def time_ms(fn, reps, warmup=3):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events.  The
    calls are queued behind a device-side sleep of about 5 ms, so that the
    host time of a wrapper (its checks, allocations and the ctypes call)
    overlaps the device work instead of adding gaps between short kernels;
    a call that needs more host time than its device work (the plain
    versions) still shows its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def record(ms, plain_ms, nbytes, ops, dt, library_ms=None):
    """A kernel's measured times beside its bound: the larger of the bytes
    it must move (each input read once, each output written once) over
    HBM_BPS and its operations over the peak of ``dt``."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / PEAK_FLOPS[dt] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


@contextlib.contextmanager
def plain_versions_forbidden():
    """While a main path runs, every kernel's plain version raises: CUDA
    tensors must never reach one."""
    from gantts_tpu_torch.kernels import linear_scan, lstm_scan, sru_scan

    saved = [(m, n, getattr(m, n)) for m in (sru_scan, lstm_scan,
                                              linear_scan)
             for n in dir(m) if n.endswith("_plain")]

    def refuse(name):
        def plain(*args, **kwargs):
            fail(f"the main path reached {name}")
        return plain
    for m, n, _ in saved:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def sru_param_count(in_dim, hidden, layers, out_dim, bidirectional):
    """Parameters of an SRURNN, from its shapes: per layer and direction
    w (d, kH), k = 3 when d == H else 4, and bf, br; then the linear
    head."""
    dirs = 2 if bidirectional else 1
    total = 0
    for i in range(layers):
        d = in_dim if i == 0 else hidden * dirs
        total += dirs * (d * (3 if d == hidden else 4) * hidden + 2 * hidden)
    return total + dirs * hidden * out_dim + out_dim


def _smooth(rs, n, d):
    """Random smooth trajectories: white noise low-passed by a 21-tap
    Hann window."""
    x = rs.randn(n + 40, d)
    k = np.hanning(21)
    k /= k.sum()
    for j in range(d):
        x[:, j] = np.convolve(x[:, j], k, mode="same")
    return x[20:20 + n] * 3.0


def write_acoustic_corpus(dst, num=30, lin_dim=LIN_DIM, mgc_dim=60,
                          frames=(200, 513), seed=0):
    """A synthetic acoustic corpus in the repository's on-disk layout
    (tests/make_synthetic_data.py --kind acoustic): ``dst/X_acoustic`` and
    ``dst/Y_acoustic`` with one float32 .npy per utterance, T frames drawn
    from ``frames``; X is (T, lin_dim) in [-4, 4], Y (T, 3 mgc_dim + 7) is
    [mgc, lf0, vuv, bap] with deltas on all but vuv, by the port's own
    window code.  Every frame is voiced: the F0 error is taken over frames
    voiced in both the target and the prediction, and with a constant vuv
    stream (standard deviation 0) every prediction denormalizes to voiced,
    so the error is defined at any weights."""
    from gantts_tpu_torch.core.windows import DEFAULT_WINDOWS, delta_features

    rs = np.random.RandomState(seed)
    for sub in ("X_acoustic", "Y_acoustic"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    for i in range(num):
        n = int(rs.randint(*frames))
        lin = np.clip(_smooth(rs, n, lin_dim), -4, 4)
        lf0 = 5.0 + 0.2 * _smooth(rs, n, 1)
        vuv = np.ones((n, 1))
        y = np.hstack([delta_features(_smooth(rs, n, mgc_dim),
                                      DEFAULT_WINDOWS),
                       delta_features(lf0, DEFAULT_WINDOWS), vuv,
                       delta_features(0.1 * _smooth(rs, n, 1),
                                      DEFAULT_WINDOWS)])
        name = f"utt_{i:04d}.npy"
        np.save(os.path.join(dst, "X_acoustic", name), lin.astype(np.float32))
        np.save(os.path.join(dst, "Y_acoustic", name), y.astype(np.float32))


# Phase 2's SASS checks, by function: (what the SASS must hold, what it
# must not), each a regular expression matched against an instruction line.
SASS_RULES = {
    # wgmma and TMA loads: without them no tensor-core rate
    "proj_gemm_bf16": ({"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b"},
                       {}),
    # f32 FMAs fed by vector shared-memory loads, no spills, and no tensor
    # cores (TF32 would lose the exact f32 products)
    "proj_gemm_f32": ({"FFMA": r"\bFFMA\b",
                       "LDS.64/128": r"\bLDS(\.U)?\.(64|128)\b"},
                      {"LDL/STL": r"\b(LDL|STL)\b",
                       "HMMA/HGMMA": r"\bH(G)?MMA\b"}),
}
# The f32 LSTM kernels (both designs' f32 instances): exact f32 FMAs, no
# tensor cores, no spills
_F32_FMA_ONLY = ({"FFMA": r"\bFFMA\b"},
                 {"LDL/STL": r"\b(LDL|STL)\b", "HMMA/HGMMA": r"\bH(G)?MMA\b"})
LSTM_SASS_RULES = {name: _F32_FMA_ONLY for name in (
    "lstm_fwd_flag_kernel", "lstm_bwd_flag_kernel", "lstm_fwd_kernelIf",
    "lstm_bwd_kernelIf")}


def sass_counts(text, table=SASS_RULES):
    """Counts of ``table``'s patterns (SASS_RULES: each GEMM instance) in
    each function of cuobjdump's output ``text`` that ``table`` names, by
    its mangled name (the f32 GEMM's split sum is not a GEMM and is left
    out)."""
    import re

    out, rules = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            rules = next((r for k, r in table.items()
                          if k in name and "split_sum" not in name), None)
            if rules is not None:
                out[name] = dict.fromkeys(list(rules[0]) + list(rules[1]), 0)
        elif rules is not None:
            for op, pattern in list(rules[0].items()) + list(rules[1].items()):
                out[name][op] += bool(re.search(pattern, line))
    return out


def check_sass(lib_path, table=SASS_RULES):
    """Phase 2: each kernel's SASS, from cuobjdump, must hold what its
    design rests on and nothing it must avoid: by SASS_RULES the bf16 GEMM
    wgmma (HGMMA) and TMA loads (UTMALDG), each instance of the f32 GEMM
    FFMA and vector shared-memory loads; by LSTM_SASS_RULES the f32 LSTM
    kernels FFMA; and none of the f32 kernels local-memory traffic (a
    spill) or a tensor-core instruction."""
    from gantts_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        fail("cuobjdump is missing: the GEMMs' SASS cannot be checked")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump failed: {proc.stderr.strip()[-500:]}")
    counts = sass_counts(proc.stdout, table)
    for name, c in counts.items():
        print(f"[2] SASS of {name}: " + ", ".join(
            f"{n} {op}" for op, n in c.items()))
    problems = sass_problems(counts, table)
    if problems:
        fail("; ".join(problems))


def sass_problems(counts, table=SASS_RULES):
    """What sass_counts' ``counts`` break of ``table``: a kernel with no
    function at all, or a function lacking what it needs or holding what it
    must avoid."""
    problems = []
    for key, (need, avoid) in table.items():
        found = {n: c for n, c in counts.items() if key in n}
        if not found:
            problems.append(f"cuobjdump shows no function named like {key}")
        for name, c in found.items():
            lacks = [op for op in need if not c[op]]
            holds = [op for op in avoid if c[op]]
            if lacks or holds:
                problems.append(f"{name}'s SASS lacks {lacks}, holds {holds}")
    return problems


def check(kernel, what, dt, D, got, ref, lim, errs):
    rel, ab = rel_err(got, ref)
    ok = rel <= lim and math.isfinite(rel)
    shape = f"D={D:4d}" if D else "      "
    print(f"[3] {kernel:13s} {what:5s} {str(dt)[6:]:8s} {shape}"
          f" rel_err={rel:.3e} abs_err={ab:.3e} limit={lim:.0e}"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{kernel} {what} disagrees with its plain version")
    if kernel in errs:
        errs[kernel] = max(errs[kernel], ab)


def check_sru_kernels(dev, gen, lengths, Tn, dims, errs, where=""):
    """The SRU kernels against their plain versions at Tn steps, the batch
    of ``lengths`` and H, for each input width D in ``dims``, in float32 and
    bfloat16: sru_proj_gemm's u, both scans in both directions (relu), the
    dx and dW their du gives, and the autograd layer (fused_sru_proj_layer)
    against the plain chain fed with the kernel GEMM's own u.  ``where``
    tags the printed checks with the path whose shapes they are."""
    from gantts_tpu_torch.kernels import sru_scan as K

    Bn = int(lengths.shape[0])
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        for D in dims:
            x = torch.randn((Tn, Bn, D), generator=gen, device=dev).to(dt)
            w = uniform(D, 4 * H)
            zeros = torch.zeros(H, device=dev)
            bias4 = torch.cat([zeros, uniform(H), uniform(H), zeros])
            gh = torch.randn((Tn, Bn, H), generator=gen, device=dev).to(dt)
            w_c = w.to(dt)
            x2 = x.reshape(Tn * Bn, D)
            u_p = K.sru_proj_gemm_plain(x2, w_c).reshape(Tn, Bn, 4 * H)
            checks = [("sru_proj_gemm", "u" + where,
                       K.sru_proj_gemm(x2, w_c).reshape(Tn, Bn, 4 * H), u_p,
                       tol)]
            for reverse in (False, True):
                h_k, c_k = K.sru_fwd_scan(u_p, bias4, lengths, reverse, 1)
                h_p, c_p = K.sru_fwd_scan_plain(u_p, bias4, lengths,
                                                reverse, 1)
                du_k, db_k = K.sru_bwd_scan(u_p, bias4, lengths, c_p, gh,
                                            reverse, 1)
                du_p, db_p = K.sru_bwd_scan_plain(u_p, bias4, lengths, c_p,
                                                  gh, reverse, 1)
                dx_k = K.mm_f32(du_k.reshape(Tn * Bn, -1), w_c.t())
                dx_p = K.mm_f32(du_p.reshape(Tn * Bn, -1), w_c.t())
                dw_k = K.mm_f32(x2.t(), du_k.reshape(Tn * Bn, -1))
                dw_p = K.mm_f32(x2.t(), du_p.reshape(Tn * Bn, -1))
                checks += [
                    ("sru_fwd_scan", "h" + where, h_k, h_p, tol),
                    ("sru_fwd_scan", "c" + where, c_k, c_p, TOL_F32_STATE),
                    ("sru_bwd_scan", "du" + where, du_k, du_p, tol),
                    ("sru_bwd_scan", "db" + where, db_k, db_p, TOL_F32_STATE),
                    ("sru_bwd_scan", "dx" + where, dx_k, dx_p, tol),
                    ("sru_bwd_scan", "dW" + where, dw_k, dw_p, tol),
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
                du_q = du_q.reshape(Tn * Bn, -1)
                checks += [
                    ("layer", "h" + where, h_a, h_q, tol),
                    ("layer", "dx" + where, xr.grad,
                     K.mm_f32(du_q, w_c.t()).to(dt).reshape(Tn, Bn, D), tol),
                    ("layer", "dW" + where, wr.grad, K.mm_f32(x2.t(), du_q),
                     tol),
                    ("layer", "db" + where, br.grad, db_q, TOL_F32_STATE),
                ]
            for kernel, what, got, ref, lim in checks:
                check(kernel, what, dt, D, got, ref, lim, errs)


def phase_kernels(dev, card, errs):
    """Phase 3: each SRU kernel against its plain version at the acoustic
    steps' shapes and at (4d)'s, and both timed at the acoustic ones."""
    from gantts_tpu_torch.kernels import sru_scan as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lengths = torch.as_tensor(bench_lengths(np.random.RandomState(0)),
                              device=dev)
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    check_sru_kernels(dev, gen, lengths, T, (LIN_DIM, 2 * H), errs)
    # at (4d)'s shapes: B = 32 phone sequences padded to 96 steps, K = 416
    # (8-aligned, so the GEMM reads x as it lies) and 2H
    lh, Tp = duration_lengths(np.random.RandomState(0))
    check_sru_kernels(dev, gen, torch.as_tensor(lh, device=dev), Tp,
                      (PHONE_DIM, 2 * H), errs, ":4d")
    # the GEMM at the LSTM path's width: both directions' W_ih, N = 8H
    bf = torch.bfloat16
    for D in (LIN_DIM, 2 * H):
        x2 = torch.randn((T * B, D), generator=gen, device=dev).to(bf)
        w_c = uniform(D, 8 * H).to(bf)
        check("sru_proj_gemm", f"u:N={8 * H}", bf, D,
              K.sru_proj_gemm(x2, w_c), K.sru_proj_gemm_plain(x2, w_c),
              TOL[bf], errs)

    # times at the main paths' shapes: the bf16 GEMM at every (K, N) the
    # paths give it (K = 425, which the wrapper copies into rows of 432, or
    # 2H; N = 4H, or 8H on the LSTM path) beside torch.mm, and at K = 432
    # (an x already 8-aligned, no copy); the f32 GEMM's are phase_f32_gemm's
    padded = LIN_DIM + -LIN_DIM % 8
    times, gemm_library = {}, {}
    for D, N in [(D, N) for D in (2 * H, LIN_DIM, padded)
                 for N in (4 * H, 8 * H)]:
        x2 = torch.randn((T * B, D), generator=gen, device=dev).to(bf)
        w_c = uniform(D, N).to(bf)
        times[("sru_proj_gemm", bf, D, N)] = (
            time_ms(lambda: K.sru_proj_gemm(x2, w_c), 20),
            time_ms(lambda: K.sru_proj_gemm_plain(x2, w_c), 20))
        gemm_library[(D, N)] = time_ms(lambda: torch.mm(x2, w_c), 20)
    for dt in (torch.bfloat16, torch.float32):
        u = torch.randn((T, B, 4 * H), generator=gen, device=dev).to(dt)
        bias4 = uniform(4 * H)
        gh = torch.randn((T, B, H), generator=gen, device=dev).to(dt)
        _, c = K.sru_fwd_scan(u, bias4, lengths, False, 1)
        times[("sru_fwd_scan", dt, None, None)] = (
            time_ms(lambda: K.sru_fwd_scan(u, bias4, lengths, False, 1), 20),
            time_ms(lambda: K.sru_fwd_scan_plain(u, bias4, lengths, False,
                                                 1), 2))
        times[("sru_bwd_scan", dt, None, None)] = (
            time_ms(lambda: K.sru_bwd_scan(u, bias4, lengths, c, gh, False,
                                           1), 20),
            time_ms(lambda: K.sru_bwd_scan_plain(u, bias4, lengths, c, gh,
                                                 False, 1), 2))
    M, nv = T * B, float(lengths.sum())
    for (kernel, dt, D, N), (ms, plain_ms) in times.items():
        shape, lib = "", ""
        if D:
            lib_ms = gemm_library[(D, N)]
            shape = f"K={D} N={N} ({2 * M * D * N / ms / 1e9:.1f} TFLOP/s) "
            lib = f"  torch.mm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
        print(f"[3] time {kernel:13s} {str(dt)[6:]:8s} {shape}"
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  [{card}]")
    # Bounds at the timed shapes.  The scans need u, c and gh only on valid
    # frames (``nv`` of T*B): padding is masked out.  ``s``: the I/O
    # dtype's bytes (c, the bias and the bias gradient are f32).
    D, N = 2 * H, 4 * H

    def scans(dt):
        s = torch.tensor([], dtype=dt).element_size()
        return {
            # per valid lane and step: two sigmoids and the cell, ~16 ops
            "sru_fwd_scan": record(
                *times[("sru_fwd_scan", dt, None, None)],
                nv * N * s + N * 4 + B * 4 + M * H * (s + 4), 16 * nv * H,
                torch.float32),
            # ~30 f32 ops per valid lane and step
            "sru_bwd_scan": record(
                *times[("sru_bwd_scan", dt, None, None)],
                nv * (N * s + H * 4 + H * s) + N * 4 + B * 4 + M * N * s
                + B * 2 * H * 4, 30 * nv * H, torch.float32)}

    for kernel, rec in scans(torch.float32).items():
        print(f"[3] bound {kernel:13s} float32 {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}); kernel {rec['ms']:.4f} ms  [{card}]")
    return {
        "sru_proj_gemm": record(
            *times[("sru_proj_gemm", bf, D, N)], 2 * (M * D + D * N + M * N),
            2 * M * D * N, bf, gemm_library[(D, N)]),
        **scans(bf)}


def phase_lstm_kernels(dev, card, errs):
    """Phase 3, LSTM: both kernels against their plain versions, with two
    directions and with one (forward and reversed), and the autograd layer
    (GEMM and both scans chained by lstm_proj_layer) against the plain chain
    fed with the kernel GEMM's own xp; then both kernels and both plain
    versions timed at the main path's shape (bf16, two directions)."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lengths = torch.as_tensor(bench_lengths(np.random.RandomState(0)),
                              device=dev)
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for way, occupancy in (("fwd", L.fwd_cluster_occupancy),
                           ("bwd", L.bwd_cluster_occupancy)):
        for h in (256, H):
            print(f"[3] lstm_{way}_scan cluster kernel at H={h}: "
                  f"{occupancy(h)} clusters of 16 blocks can be resident "
                  f"at once (one per direction)  [{card}]")
    for dt in (torch.float32, torch.bfloat16):
        tol, tol_state = LSTM_TOL[dt], LSTM_TOL_STATE[dt]
        for reverse in ((False, True), (False,), (True,)):
            nd = len(reverse)
            xp = (randn(T, B, nd * 4 * H, dt=torch.float32) * 0.5).to(dt)
            whh, bias = uniform(nd, H, 4 * H).to(dt), uniform(nd, 4 * H)
            gy = randn(T, B, nd * H, dt=dt)
            y_k, c_k, g4_k = L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
            y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias, lengths,
                                                   reverse)
            dxp_k, db_k = L.lstm_bwd_scan(whh, lengths, c_p, g4_p, gy,
                                          reverse)
            dxp_p, db_p = L.lstm_bwd_scan_plain(whh, lengths, c_p, g4_p, gy,
                                                reverse)
            tag = "".join("r" if r else "f" for r in reverse)
            require_designs(L, DESIGN[dt], dt, f"{str(dt)[6:]} {tag}",
                            ndir=nd)
            for kernel, what, got, ref, lim in (
                    ("lstm_fwd_scan", "y", y_k, y_p, tol),
                    ("lstm_fwd_scan", "c", c_k, c_p, tol_state),
                    ("lstm_fwd_scan", "g4", g4_k, g4_p, tol),
                    ("lstm_bwd_scan", "dxp", dxp_k, dxp_p, tol),
                    ("lstm_bwd_scan", "db", db_k, db_p, tol_state)):
                check(kernel, f"{what}:{tag}", dt, None, got, ref, lim, errs)
            require_same_bits(
                f"{str(dt)[6:]} {tag}", (y_k, c_k, g4_k, dxp_k, db_k),
                L.lstm_fwd_scan(xp, whh, bias, lengths, reverse)
                + L.lstm_bwd_scan(whh, lengths, c_p, g4_p, gy, reverse))
        for D in (LIN_DIM, 2 * H):
            x = randn(T, B, D, dt=torch.float32).requires_grad_(True)
            params = [dict(w_ih=uniform(D, 4 * H).requires_grad_(True),
                           w_hh=uniform(H, 4 * H).requires_grad_(True),
                           bias=uniform(4 * H).requires_grad_(True))
                      for _ in range(2)]
            gy = randn(T, B, 2 * H, dt=dt)
            cd = "bfloat16" if dt == torch.bfloat16 else "float32"
            y_a = L.lstm_proj_layer(x, params, lengths, (False, True), cd)
            y_a.backward(gy)
            # the plain chain, from the kernel GEMM's xp
            x_c = x.detach().to(dt)
            w_cat = torch.cat([p["w_ih"].detach() for p in params], -1).to(dt)
            xp = L.sru_proj_gemm(x_c.reshape(T * B, D), w_cat)
            whh = torch.stack([p["w_hh"].detach() for p in params]).to(dt)
            bias = torch.stack([p["bias"].detach() for p in params])
            y_q, c_q, g4_q = L.lstm_fwd_scan_plain(
                xp.reshape(T, B, -1), whh, bias, lengths, (False, True))
            dxp_q, db_q = L.lstm_bwd_scan_plain(whh, lengths, c_q, g4_q, gy,
                                                (False, True))
            dxp2 = dxp_q.reshape(T * B, -1)
            dx_q = L.mm_f32(dxp2, w_cat.t()).to(dt).reshape(T, B, D)
            dwih_q = L.mm_f32(x_c.reshape(T * B, D).t(), dxp2)
            for d in range(2):
                check("lstm_layer", f"dWih{d}", dt, D, params[d]["w_ih"].grad,
                      dwih_q[:, 4 * H * d:4 * H * (d + 1)], tol, errs)
                check("lstm_layer", f"dWhh{d}", dt, D, params[d]["w_hh"].grad,
                      L._shifted_dwhh(y_q, dxp_q, d, H, d == 1), tol, errs)
                check("lstm_layer", f"db{d}", dt, D, params[d]["bias"].grad,
                      db_q[d], tol_state, errs)
            check("lstm_layer", "y", dt, D, y_a, y_q, tol, errs)
            check("lstm_layer", "dx", dt, D, x.grad, dx_q, tol, errs)

    # times at the main path's shape: bf16 I/O, both directions
    rev = (False, True)
    xp = (randn(T, B, 8 * H, dt=torch.float32) * 0.5).to(torch.bfloat16)
    whh, bias = uniform(2, H, 4 * H).to(torch.bfloat16), uniform(2, 4 * H)
    gy = randn(T, B, 2 * H, dt=torch.bfloat16)
    _, c, g4 = L.lstm_fwd_scan(xp, whh, bias, lengths, rev)
    times = {
        "lstm_fwd_scan": (
            time_ms(lambda: L.lstm_fwd_scan(xp, whh, bias, lengths, rev), 10),
            time_ms(lambda: L.lstm_fwd_scan_plain(xp, whh, bias, lengths,
                                                  rev), 1, warmup=1)),
        "lstm_bwd_scan": (
            time_ms(lambda: L.lstm_bwd_scan(whh, lengths, c, g4, gy, rev),
                    10),
            time_ms(lambda: L.lstm_bwd_scan_plain(whh, lengths, c, g4, gy,
                                                  rev), 1, warmup=1))}
    require_designs(L, "cluster", torch.bfloat16, "timed, two directions",
                    ndir=2)
    for kernel, (ms, plain_ms) in times.items():
        print(f"[3] time {kernel:13s} bfloat16 two directions "
              f"kernel {ms:.4f} ms ({ms * 1e3 / T:.2f} us per recurrence "
              f"step)  plain {plain_ms:.4f} ms  [{card}]")
    cudnn = time_cudnn_lstm(dev, card, gen, lengths, (False, True))
    # Bounds, per direction: xp, c, g4 and gy are needed on valid frames
    # only; the recurrent product is 2 * H * 4H operations per valid frame,
    # on the tensor cores in bf16.
    nv, M = float(lengths.sum()), T * B
    ops = 2 * nv * H * 4 * H
    wts = H * 4 * H * 2 + 4 * H * 4
    fwd_bytes = nv * 4 * H * 2 + wts + M * H * (2 + 4) + M * 4 * H * 2
    bwd_bytes = wts + nv * (H * 4 + 4 * H * 2 + H * 2) + M * 4 * H * 2
    # one direction, as a unidirectional LSTM stack launches them (the
    # kernels of TPU rows 5-7): kernel, plain version and cuDNN
    one = (False,)
    xp1, gy1 = xp[..., :4 * H].contiguous(), gy[..., :H].contiguous()
    whh1, bias1 = whh[:1].contiguous(), bias[:1].contiguous()
    _, c1, g41 = L.lstm_fwd_scan(xp1, whh1, bias1, lengths, one)
    one_fwd = record(
        time_ms(lambda: L.lstm_fwd_scan(xp1, whh1, bias1, lengths, one),
                10),
        time_ms(lambda: L.lstm_fwd_scan_plain(xp1, whh1, bias1, lengths,
                                              one), 1, warmup=1),
        fwd_bytes, ops, torch.bfloat16)
    one_bwd = record(
        time_ms(lambda: L.lstm_bwd_scan(whh1, lengths, c1, g41, gy1, one),
                10),
        time_ms(lambda: L.lstm_bwd_scan_plain(whh1, lengths, c1, g41, gy1,
                                              one), 1, warmup=1),
        bwd_bytes, ops, torch.bfloat16)
    require_designs(L, "cluster", torch.bfloat16, "timed, one direction")
    print(f"[3] time lstm scans bfloat16 one direction: forward kernel "
          f"{one_fwd['ms']:.4f} ms ({one_fwd['ms'] * 1e3 / T:.2f} us per "
          f"step), plain {one_fwd['plain_ms']:.4f} ms "
          f"(bound {one_fwd['bound_ms']:.4f}); backward kernel "
          f"{one_bwd['ms']:.4f} ms ({one_bwd['ms'] * 1e3 / T:.2f} us per "
          f"step), plain {one_bwd['plain_ms']:.4f} ms "
          f"(bound {one_bwd['bound_ms']:.4f})  [{card}]")
    time_cudnn_lstm(dev, card, gen, lengths, one)
    return {
        "lstm_fwd_scan": record(*times["lstm_fwd_scan"], 2 * fwd_bytes,
                                2 * ops, torch.bfloat16, cudnn["fwd"]),
        "lstm_bwd_scan": record(*times["lstm_bwd_scan"], 2 * bwd_bytes,
                                2 * ops, torch.bfloat16,
                                cudnn["fwd+bwd"] - cudnn["fwd"]),
    }


# The design each I/O dtype's LSTM scans take at the paths' shapes
DESIGN = {torch.bfloat16: "cluster", torch.float32: "flag"}


def require_same_bits(what, first, second):
    """Fail unless a second launch of the LSTM scans on the same inputs
    gave the same bits: the kernels sum in fixed orders, and nothing a
    launch leaves behind reaches the next."""
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[3] lstm scans {what}: a second launch gives identical bits: "
          f"{same}")
    if not same:
        fail(f"the LSTM scans ({what}) differ between two launches")


def require_designs(L, want, dt, what, Bn=B, ndir=1):
    """Print the design the launchers of lstm_fwd_scan and lstm_bwd_scan
    take at the shape (Bn, H, ndir) in ``dt``; fail unless both are
    ``want``: the paths' bf16 shapes must take the cluster kernels, their
    f32 shapes the flag design."""
    for kernel, design in (("lstm_fwd_scan", L.fwd_design),
                           ("lstm_bwd_scan", L.bwd_design)):
        took = design(Bn, H, dt, ndir)
        print(f"[3] {kernel} {what}: {took} kernel")
        if took != want:
            fail(f"{kernel} ({what}) takes the {took} kernel, expected the "
                 f"{want} one")


def time_cudnn_lstm(dev, card, gen, lengths, reverse, D=None,
                    dt=torch.bfloat16, breakdown=False):
    """The library yardstick of the LSTM scans: one torch.nn.LSTM layer
    (cuDNN) with the directions of ``reverse`` (both, or one) at the step's
    shapes, in ``dt``, D inputs (by default H * directions, what the layers
    after the first of such a stack see), forward and forward+backward,
    beside the port's layer (``lstm_proj_layer``: sru_proj_gemm, the scans,
    and the dx/dW matmuls) on the same shapes.  cuDNN runs every row to T
    (no packing); the port's kernels walk all of T too, masking the
    padding."""
    from gantts_tpu_torch.kernels import lstm_scan as L

    nd = len(reverse)
    D = D or nd * H
    cd = "bfloat16" if dt == torch.bfloat16 else "float32"
    lstm = torch.nn.LSTM(D, H, bidirectional=nd == 2).to(dev, dt)
    x = torch.randn((T, B, D), generator=gen, device=dev).to(dt)
    gy = torch.randn((T, B, nd * H), generator=gen, device=dev).to(dt)
    x.requires_grad_(True)
    sfxs = ("", "_reverse")[:nd]
    params = [{k: getattr(lstm, f"{n}_l0{sfx}").detach().float().t()
               .contiguous() for k, n in (("w_ih", "weight_ih"),
                                          ("w_hh", "weight_hh"))}
              for sfx in sfxs]
    for p, sfx in zip(params, sfxs):
        p["bias"] = (getattr(lstm, f"bias_ih_l0{sfx}")
                     + getattr(lstm, f"bias_hh_l0{sfx}")).detach().float()
    for p in params:
        for v in p.values():
            v.requires_grad_(True)

    def cudnn_fwd_bwd():
        y, _ = lstm(x)
        y.backward(gy)

    def port_fwd_bwd():
        L.lstm_proj_layer(x, params, lengths, reverse, cd).backward(gy)

    with torch.no_grad():
        t = {"fwd": time_ms(lambda: lstm(x), 10),
             "port fwd": time_ms(lambda: L.lstm_proj_layer(
                 x, params, lengths, reverse, cd), 10)}
    t["fwd+bwd"] = time_ms(cudnn_fwd_bwd, 10)
    t["port fwd+bwd"] = time_ms(port_fwd_bwd, 10)
    print(f"[3] time cuDNN {'bidirectional' if nd == 2 else 'one-direction'}"
          f" LSTM layer {str(dt)[6:]} D={D}: forward {t['fwd']:.4f} ms, "
          f"forward+backward {t['fwd+bwd']:.4f} ms; the port's layer "
          f"{t['port fwd']:.4f} / {t['port fwd+bwd']:.4f} ms (backward "
          f"{t['port fwd+bwd'] - t['port fwd']:.4f}; cuDNN's "
          f"{t['fwd+bwd'] - t['fwd']:.4f})  [{card}]")
    if breakdown:
        trace_kernels(f"the port's {str(dt)[6:]} layer D={D} forward+"
                      f"backward", port_fwd_bwd, card)
    return t


def trace_kernels(what, fn, card, calls=3):
    """Device time per kernel name of ``fn`` (after one untraced call), per
    call, from torch.profiler: where a layer's time goes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_name = ms_by_name(device_events(prof), calls)
    total = sum(per_name.values())
    print(f"[3] {what}: device events {total:.4f} ms a call  [{card}]")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[3]   {ms:8.4f} ms  {name[:100]}")


def phase_vc_lstm_kernels(dev, card, errs):
    """Phase 3 at the VC path's shapes (In2OutRNNHighwayNet's
    unidirectional 3x512 LSTM): B=20, T=512, H=512, one direction forward
    and reversed, D = 177 (layer 0, which the bf16 GEMM copies into rows
    184 wide) and 512.  sru_proj_gemm's xp, then both scans fed that xp,
    against their plain versions, in float32 (the bundle's own dtype: the
    flag design) and bfloat16 (the cluster kernels), each printing the
    design it took, and launched again for identical bits.

    Phases 8 and 9 give the f32 kernels two more shapes, checked the same
    way (forward direction, the flag design required): phase 9's one
    utterance, B=1 at T=480 (a 467-frame utterance padded to the bucket
    multiple of 32), and phase 8's trailing and test batches, B=20 with 3
    real rows and 17 zero-length rows that pad the batch.

    Then the f32 kernels timed at every one of those shapes (F32_LSTM_TIMED,
    also with two directions at the step's shape) beside their bounds and,
    at the step's shape, their plain versions; the one-direction layer
    beside cuDNN's at D = 177 in both dtypes, and the port's f32 layer's
    forward and backward broken down by kernel (torch.profiler).  Returns
    the f32 records at the step's shape, one direction."""
    from gantts_tpu_torch.kernels import lstm_scan as L
    from gantts_tpu_torch.kernels import sru_scan as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f32, "vc", ((False,), (True,))), (bf16, "vc", ((False,),
                                                            (True,))),
             (f32, "vc9", ((False,),)), (f32, "vc8", ((False,),))]
    for dt, label, reverses in cases:
        Tn, lens = vc_lstm_shape(label, dev)
        Bn = len(lens)
        tol, tol_state = LSTM_TOL[dt], LSTM_TOL_STATE[dt]
        whh, bias = uniform(1, H, 4 * H).to(dt), uniform(1, 4 * H)
        gy = randn(Tn, Bn, H, dt=dt)
        for D in (VC_DIM, H):
            x2 = randn(Tn * Bn, D, dt=dt)
            w_ih = uniform(D, 4 * H).to(dt)
            xp = L.sru_proj_gemm(x2, w_ih)
            check("sru_proj_gemm", f"u:{label}", dt, D, xp,
                  K.sru_proj_gemm_plain(x2, w_ih), TOL[dt], errs)
            xp = xp.reshape(Tn, Bn, 4 * H)
            for reverse in reverses:
                y_k, c_k, g4_k = L.lstm_fwd_scan(xp, whh, bias, lens,
                                                 reverse)
                y_p, c_p, g4_p = L.lstm_fwd_scan_plain(xp, whh, bias,
                                                       lens, reverse)
                dxp_k, db_k = L.lstm_bwd_scan(whh, lens, c_p, g4_p, gy,
                                              reverse)
                dxp_p, db_p = L.lstm_bwd_scan_plain(whh, lens, c_p, g4_p,
                                                    gy, reverse)
                tag = ("r:" if reverse[0] else "f:") + label
                for kernel, what, got, ref, lim in (
                        ("lstm_fwd_scan", "y", y_k, y_p, tol),
                        ("lstm_fwd_scan", "c", c_k, c_p, tol_state),
                        ("lstm_fwd_scan", "g4", g4_k, g4_p, tol),
                        ("lstm_bwd_scan", "dxp", dxp_k, dxp_p, tol),
                        ("lstm_bwd_scan", "db", db_k, db_p, tol_state)):
                    check(kernel, f"{what}:{tag}", dt, D, got, ref, lim, errs)
                require_same_bits(
                    f"{str(dt)[6:]} {tag} D={D}",
                    (y_k, c_k, g4_k, dxp_k, db_k),
                    L.lstm_fwd_scan(xp, whh, bias, lens, reverse)
                    + L.lstm_bwd_scan(whh, lens, c_p, g4_p, gy, reverse))
        require_designs(L, DESIGN[dt], dt, f"{str(dt)[6:]} one direction, "
                        f"{label}, B={Bn} T={Tn}", Bn=Bn)

    out = None
    for label, reverse in F32_LSTM_TIMED:
        Tn, lens = vc_lstm_shape(label, dev)
        Bn, nd = len(lens), len(reverse)
        require_designs(L, "flag", f32, f"timed, {label}, {nd} "
                        f"direction(s)", Bn=Bn, ndir=nd)
        xp = randn(Tn, Bn, nd * 4 * H, dt=f32) * 0.5
        whh, bias = uniform(nd, H, 4 * H), uniform(nd, 4 * H)
        gy = randn(Tn, Bn, nd * H, dt=f32)
        _, c, g4 = L.lstm_fwd_scan(xp, whh, bias, lens, reverse)
        plain = (label, nd) == ("vc", 1)  # the plain loops take ~0.5 s
        fwd_bytes, bwd_bytes, ops = lstm_f32_bounds(lens, Tn, nd)
        fwd = record(
            time_ms(lambda: L.lstm_fwd_scan(xp, whh, bias, lens, reverse),
                    10),
            time_ms(lambda: L.lstm_fwd_scan_plain(xp, whh, bias, lens,
                                                  reverse), 1, warmup=1)
            if plain else None, fwd_bytes, ops, f32)
        bwd = record(
            time_ms(lambda: L.lstm_bwd_scan(whh, lens, c, g4, gy, reverse),
                    10),
            time_ms(lambda: L.lstm_bwd_scan_plain(whh, lens, c, g4, gy,
                                                  reverse), 1, warmup=1)
            if plain else None, bwd_bytes, ops, f32)
        print(f"[3] time lstm scans float32 {label} B={Bn} T={Tn} {nd} "
              f"direction(s) (flag): forward {fwd['ms']:.4f} ms "
              f"({fwd['ms'] * 1e3 / Tn:.2f} us per step), backward "
              f"{bwd['ms']:.4f} ms ({bwd['ms'] * 1e3 / Tn:.2f} us per step);"
              f" bounds {fwd['bound_ms']:.4f} / {bwd['bound_ms']:.4f} ms "
              f"({fwd['bound_by']})" + (
                  f"; plain {fwd['plain_ms']:.4f} / {bwd['plain_ms']:.4f} ms"
                  if plain else "") + f"  [{card}]")
        if plain:
            out = {k: dict(T=Tn, B=Bn, H=H, directions=nd, **rec)
                   for k, rec in (("lstm_fwd_scan", fwd),
                                  ("lstm_bwd_scan", bwd))}
    lengths = vc_lstm_shape("vc", dev)[1]
    for dt in (f32, bf16):
        t = time_cudnn_lstm(dev, card, gen, lengths, (False,), D=VC_DIM,
                            dt=dt, breakdown=dt == f32)
        if dt == f32:
            out["lstm_fwd_scan"]["library_ms"] = t["fwd"]
            out["lstm_bwd_scan"]["library_ms"] = t["fwd+bwd"] - t["fwd"]
    return out


# Phase 3's f32 LSTM timings: (shape label of vc_lstm_shape, directions)
F32_LSTM_TIMED = (("vc", (False,)), ("vc", (False, True)), ("vc9", (False,)),
                  ("vc8", (False,)))


def vc_lstm_shape(label, dev):
    """T and the lengths (int32 on ``dev``) of phase 3's VC LSTM shapes:
    "vc" the step's B=20 at T=512 (bench_lengths), "vc9" phase 9's one
    utterance (467 frames padded to 480), "vc8" phase 8's trailing batches
    (3 real rows, 17 of length 0)."""
    values = {"vc": (T, bench_lengths(np.random.RandomState(0))),
              "vc9": (480, [467]),
              "vc8": (T, [497, 301, 402] + [0] * 17)}[label]
    return values[0], torch.as_tensor(np.asarray(values[1], np.int32),
                                      device=dev)


def lstm_f32_bounds(lengths, Tn, nd):
    """Bytes of the f32 forward and backward scans and their operations, at
    Tn steps of ``lengths`` with nd directions: xp, c, g4 and gy are read
    on valid frames only, y, c, g4 and dxp written on all of them; W_hh and
    the bias read once; the recurrent product is 2 * H * 4H operations per
    valid frame and direction, on the f32 FMA pipes (no tensor cores in
    f32)."""
    nv, M = float(lengths.sum()), Tn * len(lengths)
    wts = (H * 4 * H + 4 * H) * 4
    fwd = nd * (nv * 4 * H * 4 + wts + M * (H + H + 4 * H) * 4)
    bwd = nd * (wts + nv * (H + 4 * H + H) * 4 + M * 4 * H * 4 + 4 * H * 4)
    return fwd, bwd, nd * 2 * nv * H * 4 * H


# Phase 3's synthesis shapes: one utterance (B=1) in the bundles' float32,
# padded to the bucket multiple of 32 as synthesis.model_forward pads it:
# (model, padded T, true length, input widths of its layers)
SYNTH_SHAPES = (("dur", 64, 57, (PHONE_DIM, 2 * H)),
                ("ac", 608, 597, (LIN_DIM, 2 * H)))


def phase_synthesis_kernels(dev, card, errs):
    """Phase 3 at TTS synthesis's shapes: sru_proj_gemm and sru_fwd_scan
    (both directions, relu) in float32 at B=1, for the duration model
    (phone-level, T=64) and the acoustic model (frame-level, T=608), each
    layer width; each held to its plain version at phase 3's float32 limits,
    and the scan timed beside its plain version and its bound (the GEMM's
    times at these shapes are phase_f32_gemm's)."""
    from gantts_tpu_torch.kernels import sru_scan as K

    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bound = 1.0 / H ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    zeros = torch.zeros(H, device=dev)
    for model, Tn, n_valid, dims in SYNTH_SHAPES:
        lengths = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        for D in dims:
            x2 = torch.randn((Tn, D), generator=gen, device=dev)
            w = uniform(D, 4 * H)
            bias4 = torch.cat([zeros, uniform(H), uniform(H), zeros])
            u_p = K.sru_proj_gemm_plain(x2, w)
            check("sru_proj_gemm", f"u:{model}", f32, D,
                  K.sru_proj_gemm(x2, w), u_p, TOL[f32], errs)
            u = u_p.reshape(Tn, 1, 4 * H)
            for reverse in (False, True):
                h_k, c_k = K.sru_fwd_scan(u, bias4, lengths, reverse, 1)
                h_p, c_p = K.sru_fwd_scan_plain(u, bias4, lengths, reverse,
                                                1)
                way = "bwd" if reverse else "fwd"
                check("sru_fwd_scan", f"h:{model}:{way}", f32, D, h_k, h_p,
                      TOL[f32], errs)
                check("sru_fwd_scan", f"c:{model}:{way}", f32, D, c_k, c_p,
                      TOL_F32_STATE, errs)
            N = 4 * H
            # u read on valid frames, h and c written on all of them; ~16
            # f32 operations per valid lane and step
            scan = record(
                time_ms(lambda: K.sru_fwd_scan(u, bias4, lengths, False, 1),
                        50),
                time_ms(lambda: K.sru_fwd_scan_plain(u, bias4, lengths,
                                                     False, 1), 2, 1),
                n_valid * N * 4 + N * 4 + 4 + Tn * H * 4 * 2,
                16 * n_valid * H, f32)
            print(f"[3] time sru_fwd_scan  float32 B=1 {model} T={Tn} "
                  f"(length {n_valid}) after K={D}: kernel {scan['ms']:.4f} "
                  f"ms  plain {scan['plain_ms']:.4f} ms  bound "
                  f"{scan['bound_ms']:.4f} ms ({scan['bound_by']})  [{card}]")


# Every shape the port's f32 paths give sru_proj_gemm: (path, M, K, N)
F32_GEMM_SHAPES = (
    ("tts_acoustic (4g, 10)", T * B, LIN_DIM, 4 * H),
    ("tts_acoustic (4g, 10)", T * B, 2 * H, 4 * H),
    ("tts_duration (10)", 3072, PHONE_DIM, 4 * H),
    ("tts_duration (10)", 3072, 2 * H, 4 * H),
    ("vc In2OutRNN (8)", T * B, VC_DIM, 4 * H),
    ("vc In2OutRNN (8)", T * B, H, 4 * H),
    ("LSTMRNN W_ih", T * B, LIN_DIM, 8 * H),
    ("LSTMRNN W_ih", T * B, 2 * H, 8 * H),
    ("TTS synthesis dur (10)", 64, PHONE_DIM, 4 * H),
    ("TTS synthesis dur (10)", 64, 2 * H, 4 * H),
    ("TTS synthesis ac (10)", 608, LIN_DIM, 4 * H),
    ("TTS synthesis ac (10)", 608, 2 * H, 4 * H),
    ("VC synthesis (9)", 480, VC_DIM, 4 * H),
    ("VC synthesis (9)", 480, H, 4 * H))
F32_GEMM_RECORDED = (T * B, 2 * H, 4 * H)  # the kernels line's f32 record


def phase_f32_gemm(dev, card, errs):
    """Phase 3, the f32 GEMM at every shape of F32_GEMM_SHAPES: held to its
    plain version at TOL, launched twice for identical bits (the split-K
    sum runs in a fixed order), and timed beside its plain version,
    torch.mm (f32, TF32 off) and its bound.  The kernel's time is the
    wrapper's whole call: the split-K workspace and the split sum.  Returns
    the record at F32_GEMM_RECORDED."""
    from gantts_tpu_torch.kernels import sru_scan as K

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: torch.mm is no f32 yardstick")
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = None
    for path, M, D, N in F32_GEMM_SHAPES:
        x2 = torch.randn((M, D), generator=gen, device=dev)
        w = (torch.rand((D, N), generator=gen, device=dev) * 2 - 1) / H ** 0.5
        u = K.sru_proj_gemm(x2, w)
        check("sru_proj_gemm", f"u:M={M}:N={N}", f32, D, u,
              K.sru_proj_gemm_plain(x2, w), TOL[f32], errs)
        same = torch.equal(u, K.sru_proj_gemm(x2, w))
        plan = K._f32_gemm_plan(M, N, D, sms)
        print(f"[3] sru_proj_gemm float32 M={M} K={D} N={N}: "
              f"{plan.tile_m}x{plan.tile_n} tiles {plan.tiles_m}x"
              f"{plan.tiles_n}, {plan.splits} split(s) of "
              f"{plan.k_steps * K.F32_TILE_K} K; two launches bit-identical:"
              f" {same}")
        if not same:
            fail(f"the f32 GEMM at M={M} K={D} N={N} differs between two "
                 f"launches")
        rec = record(time_ms(lambda: K.sru_proj_gemm(x2, w), 20),
                     time_ms(lambda: K.sru_proj_gemm_plain(x2, w), 20),
                     4 * (M * D + D * N + M * N), 2 * M * D * N, f32,
                     time_ms(lambda: torch.mm(x2, w), 20))
        print(f"[3] time sru_proj_gemm float32 {path:22s} M={M:5d} K={D:4d} "
              f"N={N}: kernel {rec['ms']:.4f} ms "
              f"({2 * M * D * N / rec['ms'] / 1e9:.1f} TFLOP/s)  plain "
              f"{rec['plain_ms']:.4f} ms  torch.mm {rec['library_ms']:.4f} "
              f"ms ({rec['ms'] / rec['library_ms']:.2f}x)  bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
              f"{rec['bound_ms'] / rec['ms']:.2f} of it)  [{card}]")
        if (M, D, N) == F32_GEMM_RECORDED:
            out = dict(M=M, K=D, N=N, **rec)
    return out


def acoustic_hp(compute_dtype, **gen_overrides):
    from gantts_tpu_torch import hparams

    hp = hparams.tts_acoustic.copy()
    hp.compute_dtype = compute_dtype
    hp.generator_params.update(in_dim=LIN_DIM, out_dim=OUT_DIM,
                               **gen_overrides)
    hp.discriminator_params.update(in_dim=DISC_IN)
    return hp


def lstm_hp(compute_dtype, **gen_overrides):
    """bench.py's LSTM-family configuration (bench.py:58-63): the
    tts_acoustic bundle with a 6x512 bidirectional LSTMRNN generator,
    dropout 0.2."""
    hp = acoustic_hp(compute_dtype)
    hp.generator = "LSTMRNN"
    hp.generator_params = dict(in_dim=LIN_DIM, out_dim=OUT_DIM, num_hidden=6,
                               hidden_dim=H, bidirectional=True, dropout=0.2)
    hp.generator_params.update(gen_overrides)
    return hp


def lstm_param_count(in_dim, hidden, layers, out_dim):
    """Parameters of a bidirectional LSTMRNN, from its shapes: per layer and
    direction w_ih, w_hh and two bias vectors; then the linear head."""
    per_dir = [d * 4 * hidden + hidden * 4 * hidden + 2 * 4 * hidden
               for d in [in_dim] + [2 * hidden] * (layers - 1)]
    return 2 * sum(per_dir) + 2 * hidden * out_dim + out_dim


def duration_hp(compute_dtype, **gen_overrides):
    """The tts_duration bundle at full width (a 6x512 bidirectional relu
    SRU, 416 phone-level inputs, 5 durations, the 3x256 MLP discriminator
    conditioned on the 416 inputs, Adam with betas (0.5, 0.9))."""
    from gantts_tpu_torch import hparams

    hp = hparams.tts_duration.copy()
    hp.compute_dtype = compute_dtype
    hp.generator_params.update(in_dim=PHONE_DIM, out_dim=DUR_DIM,
                               **gen_overrides)
    hp.discriminator_params.update(in_dim=PHONE_DIM + DUR_DIM)
    return hp


def acoustic_batch(hp, dev):
    """Phase 4's batch: B=20 x T=512 frames of random features, the lengths
    of bench.py:103, and the dense MLPG matrix."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix

    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(B, T, LIN_DIM).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.rand(B, T, OUT_DIM).astype(np.float32), device=dev)
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T), device=dev)
    return x, y, bench_lengths(rs), R


def duration_lengths(rs):
    """DUR_B phone counts drawn uniformly from 20-80 (an assumption, see
    PERF.md section 4), and the padded length: the longest rounded up to a
    multiple of 32, as the data pipeline pads (data.py:178)."""
    lh = rs.randint(20, 81, DUR_B).astype(np.int32)
    return lh, -(-int(lh.max()) // 32) * 32


def duration_batch(hp, dev):
    """Phase 4d's batch: DUR_B phone sequences of duration_lengths; no MLPG
    matrix (durations have no dynamic features)."""
    rs = np.random.RandomState(0)
    lh, Tp = duration_lengths(rs)
    x = torch.as_tensor(rs.rand(DUR_B, Tp, PHONE_DIM).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rs.randn(DUR_B, Tp, DUR_DIM).astype(np.float32),
                        device=dev)
    return x, y, lh, None


def vc_hp(compute_dtype, generator, **gen_overrides):
    """The vc bundle at full width: 177 -> 177 (59 mel-cepstra with
    deltas), 3x512 with dropout 0.5 (``In2OutHighwayNet``, the bundle's, or
    ``In2OutRNNHighwayNet``, a unidirectional LSTM), the 59 -> 2x256 -> 1
    discriminator on the static mel-cepstra alone, dense MLPG, Adagrad lr
    0.01."""
    from gantts_tpu_torch import hparams

    hp = hparams.vc.copy()
    hp.compute_dtype = compute_dtype
    hp.generator = generator
    hp.generator_params.update(in_dim=VC_DIM, out_dim=VC_DIM,
                               **gen_overrides)
    return hp


def in2out_param_count(generator):
    """Parameters of a full-width In2Out generator (3x512, 177 -> 177,
    static 59), from its shapes: the gate T (static x static), then an MLP
    trunk H_i and last_linear, or a unidirectional LSTM (w_ih, w_hh, two
    biases a layer) and hidden2out."""
    ins = [VC_DIM, H, H]
    if generator == "In2OutHighwayNet":
        trunk = sum(d * H + H for d in ins)
    else:
        trunk = sum(d * 4 * H + H * 4 * H + 2 * 4 * H for d in ins)
    return mlp_param_count([VC_STATIC, VC_STATIC]) + trunk + \
        mlp_param_count([H, VC_DIM])


def mlp_param_count(dims):
    return sum(a * b + b for a, b in zip(dims, dims[1:]))


def vc_batch(hp, dev):
    """Phase 4e/4f's batch: B=20 x T=512 frames of normalized features
    (177 in, 177 out, standard normal), the lengths of bench.py:103 (an
    assumption for a VC corpus, see PERF.md section 4), and the dense MLPG
    matrix."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix

    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(B, T, VC_DIM).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.randn(B, T, VC_DIM).astype(np.float32), device=dev)
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T), device=dev)
    return x, y, bench_lengths(rs), R


def make_trainer(hp, dev):
    """A GAN trainer with unit statistics, but for the acoustic bundles'
    V/UV static, which denormalizes around 2: targets and predictions near
    0 are voiced, so the F0 error, taken over frames voiced in both, is a
    number (as tests/test_torch_step.py's batch makes it).  The statistics
    enter only the metrics."""
    from gantts_tpu_torch.train import GanTrainer, StepConfig

    cfg = StepConfig.from_hparams(hp, w_d=1.0, mse_w=0.0, mge_w=1.0,
                                  update_d=True, update_g=True)
    out_dim = hp.generator_params["out_dim"]
    y_mean = np.zeros(out_dim, np.float32)
    if cfg.name == "acoustic":
        y_mean[sum(hp.stream_sizes[:2])] = 2.0
    return GanTrainer(cfg, y_mean, np.ones(out_dim, np.float32), dev)


def small_step_batch(hp, Ts, Bs):
    """Phase 5's batch: Bs x Ts frames of uniform [0, 1) features, ragged
    lengths (the last row full), from seed 1, and the dense MLPG matrix
    where the bundle has dynamic features."""
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix

    rs = np.random.RandomState(1)
    gp = hp.generator_params
    batch = [rs.rand(Bs, Ts, gp["in_dim"]).astype(np.float32),
             rs.rand(Bs, Ts, gp["out_dim"]).astype(np.float32),
             np.r_[rs.randint(Ts // 2, Ts, Bs - 1), Ts].astype(np.int32)]
    R = (unit_variance_mlpg_matrix(hp.windows, Ts)
         if any(hp.has_dynamic_features) else None)
    return batch, R


def loss_gap(a, b):
    """|a - b| / max(|b|, 1e-6); 0 where both are NaN, infinite where one
    alone is (a NaN never agrees with a number)."""
    if math.isnan(a) and math.isnan(b):
        return 0.0
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-6)


def phase_main_path(dev, card, tag, hp, per_step, n_expected, make_batch,
                    unit):
    """Phase 4 (``tag`` "4" to "4g"): full-width training steps through
    the kernels, in ``hp.compute_dtype``.  ``per_step``: the launches of each kernel
    that one step must make; ``n_expected``: the parameter counts of the
    generator and the discriminator (None: not checked); ``make_batch(hp,
    dev)``: (x, y, host lengths, R); ``unit``: what one time step of the
    batch is (frames or phones)."""
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gantts_tpu_torch.train.setup import init_models_and_states

    model_g, model_d, _, _, gstate, dstate = init_models_and_states(
        hp, seed=0, device=dev)
    n_params = [sum(p.numel() for p in m.parameters())
                for m in (model_g, model_d)]
    print(f"[{tag}] {hp.generator} generator {n_params[0]} parameters, "
          f"discriminator {n_params[1]}")
    for name, n, want in zip((hp.generator, hp.discriminator), n_params,
                             n_expected):
        if want is not None and n != want:
            fail(f"{name} has {n} parameters, its shapes give {want}")
    trainer = make_trainer(hp, dev)
    x, y, lh, R = make_batch(hp, dev)
    lengths = torch.as_tensor(lh, device=dev)
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
        print(f"[{tag}] step {i}: " + " ".join(
            f"{k}={v:.6g}" for k, v in vals.items()))
        for k, v in vals.items():  # the F0 error may have no voiced frame
            if k != "f0_rmse" and not math.isfinite(v):
                fail(f"step {i}: {k} is not finite ({v})")
    for p in list(model_g.parameters()) + list(model_d.parameters()):
        if not torch.isfinite(p).all():
            fail("a parameter is not finite after the steps")
    for name, n in counts.items():
        print(f"[{tag}] launches {name}: {n} in {STEPS} steps")
        if n != per_step[name] * STEPS:
            fail(f"{name} launched {n} times in {STEPS} steps, "
                 f"expected {per_step[name] * STEPS}")
    ms = dt / STEPS * 1e3
    fps = float(lh.sum()) * STEPS / dt
    print(f"[{tag}] {hp.name} {hp.generator} step B={x.shape[0]} "
          f"T={x.shape[1]} {hp.compute_dtype}: {ms:.3f} ms/step, "
          f"{fps:.1f} valid {unit}/s, "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB)  [{card}]")

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


def device_events(prof):
    """The device events of a torch.profiler trace: kernels, copies and
    fills.  Device-side copies of host ranges (record_function and the
    optimizer's annotations) are user annotations, not device work: they
    are left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host_names
            and e.time_range.end > e.time_range.start]


def ms_by_name(events, calls):
    """Device ms per call of each name among ``events``."""
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3 / calls
    return per_name


def phase_profile(tag, run_steps, ms_unprofiled, card):
    """Trace PROFILE_STEPS more main-path steps with torch.profiler.

    Device busy time is the union of the trace's device intervals (kernels,
    copies, fills; not annotations); the idle share is 1 - busy / the
    traced wall span of the steps, both from this one trace.  The profiler
    adds host time per launch, so that idle share is an upper bound for an
    unprofiled step.  Returns the device events' names, or None when the
    trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_steps"):
            run_steps(PROFILE_STEPS)
            torch.cuda.synchronize()
    span = [e for e in prof.events() if e.name == "chip_smoke_steps"]
    dev = device_events(prof)
    if not span or not dev:
        print(f"[{tag}P] the trace holds no device activity: device time not "
              f"measured  [{card}]")
        return None
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    wall = (t1 - t0) / 1e3 / PROFILE_STEPS
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in dev]) / 1e3 / PROFILE_STEPS
    per_name = ms_by_name(dev, PROFILE_STEPS)
    summed = sum(per_name.values())
    print(f"[{tag}P] {PROFILE_STEPS} traced steps: wall {wall:.3f} ms/step "
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
        print(f"[{tag}P]   {g:40s} {t:8.3f} ms/step {100 * t / summed:5.1f}%")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{tag}P]   top {t:8.3f} ms/step  {name[:90]}")
    return set(per_name)


# Phases 5-5c: the small float32 acoustic steps, by tag
SMALL_ACOUSTIC_STEPS = {
    "5": lambda: acoustic_hp("float32", num_hidden=2, hidden_dim=64,
                             dropout=0.0, rnn_dropout=0.0),
    "5b": lambda: lstm_hp("float32", num_hidden=2, hidden_dim=64,
                          dropout=0.0),
    "5c": lambda: acoustic_hp("float32", num_hidden=3, hidden_dim=64,
                              dropout=0.0, rnn_dropout=0.0,
                              bidirectional=False)}


def phase_small_step(dev, tag, hp, Ts=64, Bs=4, probe=None):
    """Phase 5 (``tag`` "5" to "5e"): a small float32 step
    (dropout off) on the card against the same step on the CPU, from the
    same weights.

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
    5.9e-3.  The same limits hold the LSTMRNN step (5b), the
    unidirectional SRU step (5c), the tts_duration step (5d: 416 -> 5,
    no MLPG matrix, the discriminator conditioned on the input, Adam,
    whose first update is likewise about +-lr * sign(g)) and the vc step
    (5e: 177 -> 177 through an In2OutRNNHighwayNet, which applies MLPG
    itself, the discriminator on the 59 static mel-cepstra).

    The batch is Bs x Ts frames (small_step_batch).  The acoustic steps'
    V/UV denormalizes around 2 (make_trainer), so that f0_rmse is a
    number on both sides and is held to PRE_RTOL like any loss (a NaN on
    one side alone fails).  ``probe``, where given, computes
    tensors from the generator on the same batch before the step; each is
    held to PROBE_RTOL of its scale, and the control must exceed that
    limit in the probe.  5e needs one: the In2Out highway passes the input
    statics through exactly, so a TF32 slip moves its losses far less
    than a generic generator's (at 4 x 64 the control's largest loss gap
    read 3.41e-6, barely over PRE_RTOL, on an NVIDIA H100 80GB HBM3,
    700 W), while in2out_probe reads the generator's own term and the
    gradients the slip reaches directly."""
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp.discriminator_params.update(dropout=0.0)
    batch, R = small_step_batch(hp, Ts, Bs)
    states, probes = [], []

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
        x, y, lengths = (torch.as_tensor(a, device=device) for a in batch)
        R_d = None if R is None else torch.as_tensor(R, device=device)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            if probe is not None:
                probes.append({k: v.detach().float().cpu() for k, v in
                               probe(gstate.model, x, y, lengths,
                                     R_d).items()})
            _, _, out = make_trainer(hp, device).step(gstate, dstate, x, y,
                                                      lengths, R_d, 1.0)
            out = {k: float(v) for k, v in out.items()}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return out

    cpu = run(torch.device("cpu"), False)
    if not math.isfinite(cpu.get("f0_rmse", 0.0)):
        fail(f"small step {tag}: f0_rmse is {cpu['f0_rmse']} on the CPU, "
             f"so its comparison holds nothing")
    card, control = run(dev, False), run(dev, True)

    worst, worst_control = 0.0, 0.0
    for k in cpu:
        lim = POST_RTOL if k in POST_UPDATE else PRE_RTOL
        g, gc = loss_gap(card[k], cpu[k]), loss_gap(control[k], cpu[k])
        ok = g <= lim
        print(f"[{tag}] {k:20s} card={card[k]:.8g} cpu={cpu[k]:.8g} "
              f"gap={g:.2e} limit={lim:.0e} {'ok' if ok else 'FAIL'}  "
              f"control(tf32) gap={gc:.2e}")
        if not ok:
            fail(f"small step: {k} on the card differs from the CPU")
        if k not in POST_UPDATE:
            worst, worst_control = max(worst, g), max(worst_control, gc)
    print(f"[{tag}] {hp.generator} pre-update: largest gap {worst:.2e}, "
          f"limit {PRE_RTOL:.0e}, control's largest gap {worst_control:.2e}")
    if probe is not None:
        worst_control = check_probe(tag, *probes)
        if not worst_control > PROBE_RTOL:
            fail("small step: the TF32 control stays within the probe's "
                 "limit, so the comparison cannot see a TF32 matmul")
    elif not worst_control > PRE_RTOL:
        fail("small step: the TF32 control stays within the limit, so the "
             "comparison cannot see a TF32 matmul")


def check_probe(tag, cpu, card, control):
    """Hold each probe tensor of the card to the CPU's, as max|card - cpu|
    / max|cpu|, at PROBE_RTOL; returns the control's largest gap."""
    worst, worst_control = 0.0, 0.0
    for k, ref in cpu.items():
        scale = max(float(ref.abs().max()), 1e-30)
        g = float((card[k] - ref).abs().max()) / scale
        gc = float((control[k] - ref).abs().max()) / scale
        ok = g <= PROBE_RTOL
        print(f"[{tag}] probe {k:32s} gap={g:.2e} limit={PROBE_RTOL:.0e} "
              f"{'ok' if ok else 'FAIL'}  control(tf32) gap={gc:.2e}")
        if not ok:
            fail(f"small step: the probe's {k} on the card differs from the "
                 f"CPU")
        worst, worst_control = max(worst, g), max(worst_control, gc)
    print(f"[{tag}] probe: largest gap {worst:.2e}, limit "
          f"{PROBE_RTOL:.0e}, control's largest gap {worst_control:.2e}")
    return worst_control


def in2out_probe(model, x, y, lengths, R):
    """5e's probe: an In2Out generator's own term y_static - x_static on
    the valid frames, and every parameter's gradient of the squared error
    of y_static against y's statics there."""
    model.zero_grad(set_to_none=True)
    _, y_static = model(x, R, lengths)
    valid = (torch.arange(x.shape[1], device=x.device)[None]
             < lengths[:, None])[..., None]
    out = {"y_static - x_static": ((y_static - x[..., :VC_STATIC])
                                   * valid).detach()}
    (((y_static - y[..., :VC_STATIC]) * valid) ** 2).sum().backward()
    out.update({f"grad {n}": p.grad.clone()
                for n, p in model.named_parameters() if p.grad is not None})
    model.zero_grad(set_to_none=True)
    return out


def phase_linear_kernels(dev, card, errs):
    """Phase 3c: the k=3 layer's linear recurrence, float32, T=512, B=20,
    H=512, with the k=3 layer's masking (f = 1, b = 0 on padded frames):
    both kernels and the autograd Function against the plain versions, then
    kernels and plain versions timed."""
    from gantts_tpu_torch.kernels import linear_scan as L

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    lengths = torch.as_tensor(bench_lengths(np.random.RandomState(0)),
                              device=dev)
    m = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    m = m[..., None]

    def randn():
        return torch.randn((T, B, H), generator=gen, device=dev)

    f = torch.sigmoid(randn()) * m + (1.0 - m)
    b = randn() * 0.5 * m
    g = randn()
    c_p = L.linear_recurrence_fwd_plain(f, b)
    df_p, db_p = L.linear_recurrence_bwd_plain(g, f, c_p)
    df_k, db_k = L.linear_recurrence_bwd(g, f, c_p)
    fr, br = f.clone().requires_grad_(True), b.clone().requires_grad_(True)
    c_a = L.linear_recurrence(fr, br)
    c_a.backward(g)
    f32 = torch.float32
    for kernel, what, got, ref in (
            ("linear_recurrence_fwd", "c", L.linear_recurrence_fwd(f, b),
             c_p),
            ("linear_recurrence_bwd", "df", df_k, df_p),
            ("linear_recurrence_bwd", "db", db_k, db_p),
            ("linear_layer", "c", c_a, c_p),
            ("linear_layer", "df", fr.grad, df_p),
            ("linear_layer", "db", br.grad, db_p)):
        check(kernel, f"{what}:3c", f32, None, got, ref, LINEAR_TOL, errs)

    times = {
        "linear_recurrence_fwd": (
            time_ms(lambda: L.linear_recurrence_fwd(f, b), 20),
            time_ms(lambda: L.linear_recurrence_fwd_plain(f, b), 2, 1)),
        "linear_recurrence_bwd": (
            time_ms(lambda: L.linear_recurrence_bwd(g, f, c_p), 20),
            time_ms(lambda: L.linear_recurrence_bwd_plain(g, f, c_p), 2,
                    1))}
    for kernel, (ms, plain_ms) in times.items():
        print(f"[3c] time {kernel:21s} float32 kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  [{card}]")
    # f and b in, c out (2 operations per element); g, f and c in, df and
    # db out (3 operations per element).  No PyTorch call computes it.
    n = T * B * H
    return {"linear_recurrence_fwd": record(
                *times["linear_recurrence_fwd"], 3 * n * 4, 2 * n, f32),
            "linear_recurrence_bwd": record(
                *times["linear_recurrence_bwd"], 5 * n * 4, 3 * n, f32)}


def phase_cli(card):
    """Phase 6: ``python -m gantts_tpu_torch.train``'s main() on a synthetic
    corpus of 30 utterances (200-512 frames, 425 -> 187 dims) in a
    temporary directory: two epochs of (4c)'s configuration (the 6x512
    unidirectional relu SRU, bf16 matmuls, w_d = 1), then a second stage
    from both checkpoints for one more epoch.  Checks the checkpoints, that
    every logged value is finite and that each stage launched the k=3
    kernels as often as its steps require; prints each phase's valid
    frames/s.  The command line's own output goes to a log, whose tail is
    printed if it fails.  Returns the launch counts of both stages."""
    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.data import NPYDataSource
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gantts_tpu_torch.train.__main__ import main as train_main

    gp = dict(hparams.tts_acoustic.generator_params, bidirectional=False)
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_acoustic_corpus(tmp)
        xdir, ydir = (os.path.join(tmp, d) for d in ("X_acoustic",
                                                     "Y_acoustic"))
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        n_steps = {phase: -(-len(NPYDataSource(xdir, train=phase == "train")
                                 .collect_files()) // 20)
                   for phase in ("train", "test")}
        stages = [(2, []), (3, [
            f"--checkpoint-g={ck}/checkpoint_epoch2_Generator.pth",
            f"--checkpoint-d={ck}/checkpoint_epoch2_Discriminator.pth"])]
        for nepoch, extra in stages:
            argv = [xdir, ydir, "--hparams_name=tts_acoustic",
                    f"--hparams=nepoch={nepoch},compute_dtype=bfloat16,"
                    f"generator_params={gp!r}", "--w_d=1",
                    f"--checkpoint-dir={ck}", f"--log-event-path={log}",
                    "--disable-slack", *extra]
            out_path = os.path.join(tmp, f"stage{nepoch}.out")
            reset_launch_counts()
            t0 = time.perf_counter()
            with open(out_path, "w") as out:
                try:
                    with contextlib.redirect_stdout(out), \
                            plain_versions_forbidden():
                        rc = train_main(argv)
                except BaseException:
                    out.flush()
                    with open(out_path) as f:
                        print("".join(f.readlines()[-40:]))
                    raise
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(launch_counts)
            epochs = 2 if nepoch == 2 else 1
            want = {"linear_recurrence_fwd":
                    5 * epochs * (n_steps["train"] + n_steps["test"]),
                    "linear_recurrence_bwd": 5 * epochs * n_steps["train"]}
            print(f"[6] stage to epoch {nepoch}: exit {rc}, {dt:.2f} s, "
                  f"launches {counts}")
            if rc != 0:
                fail(f"the training command line exited {rc}")
            for k, n in want.items():
                if counts[k] != n:
                    fail(f"stage to epoch {nepoch}: {k} launched "
                         f"{counts[k]} times, its steps need {n}")
            for k, n in counts.items():
                totals[k] = totals.get(k, 0) + n
            for name in ("Generator", "Discriminator"):
                path = os.path.join(ck, f"checkpoint_epoch{nepoch}_"
                                    f"{name}.pth")
                if not os.path.exists(path):
                    fail(f"no checkpoint {os.path.basename(path)}")
        with open(os.path.join(log, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    bad = [r for r in rows if not math.isfinite(r["value"])]
    if bad or {r["step"] for r in rows} != {1, 2, 3}:
        fail(f"logged series: {len(bad)} values not finite ({bad[:3]}), "
             f"epochs {sorted({r['step'] for r in rows})}")
    for r in rows:
        if r["tag"].endswith("frames_per_sec"):
            print(f"[6] epoch {r['step']} {r['tag']}: {r['value']:.1f} valid "
                  f"frames/s  [{card}]")
    print(f"[6] {len(rows)} logged values, all finite; "
          f"{len({r['tag'] for r in rows})} series")
    return totals


def write_duration_corpus(dst, num=96, phones=(20, 81), seed=0):
    """A synthetic phone-level corpus in the repository's on-disk layout
    (tests/make_synthetic_data.py --kind duration, which this script cannot
    call: it imports the JAX package): ``dst/X_duration`` with
    (N, PHONE_DIM) linguistic features in [-4, 4] and ``dst/Y_duration``
    with (N, DUR_DIM) state durations of 1-20 frames, N phones drawn from
    ``phones`` (the 4d assumption, see duration_lengths), one float32 .npy
    per utterance."""
    rs = np.random.RandomState(seed)
    for sub in ("X_duration", "Y_duration"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    for i in range(num):
        n = int(rs.randint(*phones))
        lin = np.clip(_smooth(rs, n, PHONE_DIM), -4, 4)
        dur = np.clip(np.abs(_smooth(rs, n, DUR_DIM)) * 2 + 1, 1, 20)
        name = f"utt_{i:04d}.npy"
        np.save(os.path.join(dst, "X_duration", name), lin.astype(np.float32))
        np.save(os.path.join(dst, "Y_duration", name), dur.astype(np.float32))


def run_curriculum(tag, argv, env, plan, per_step, per_train_step, n_steps):
    """``python -m gantts_tpu_torch.curriculum``'s main() on ``argv`` with
    the switches of ``env``, every plain version refused; each stage's
    launches are read around its call of the training main().  ``plan``:
    (stage, epochs, trains the generator) of each stage that runs;
    ``per_step``: the launches of each kernel in every step (train and
    test), ``per_train_step``: those in each train step that trains the
    generator; ``n_steps``: the steps of an epoch's train and test phases.
    The command lines' own output goes to a log, whose tail is printed if a
    stage fails.  Returns the launch counts of all stages."""
    from unittest import mock

    from gantts_tpu_torch import curriculum
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gantts_tpu_torch.train import __main__ as train_cli

    real_main, stages, totals = train_cli.main, [], {}

    def counted_main(stage_argv):
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = real_main(stage_argv)
        torch.cuda.synchronize()
        stages.append((rc, time.perf_counter() - t0, dict(launch_counts)))
        return rc

    with tempfile.NamedTemporaryFile("w+", suffix=".log") as out:
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), plain_versions_forbidden(), \
                    mock.patch.object(train_cli, "main", counted_main):
                rc = curriculum.main(argv, env=env)
        except BaseException:
            out.flush()
            out.seek(0)
            print("".join(out.readlines()[-40:]))
            raise
        dt = time.perf_counter() - t0
    print(f"[{tag}] curriculum exit {rc}, {len(stages)} stages, {dt:.2f} s "
          f"({n_steps['train']} train and {n_steps['test']} test steps an "
          f"epoch)")
    if rc != 0 or len(stages) != len(plan):
        fail(f"the curriculum exited {rc} after {len(stages)} stages")
    for (name, epochs, trains_g), (stage_rc, secs, counts) in zip(plan,
                                                                  stages):
        steps = epochs * (n_steps["train"] + n_steps["test"])
        want = {k: n * steps for k, n in per_step.items()}
        want.update({k: n * epochs * n_steps["train"] * trains_g
                     for k, n in per_train_step.items()})
        print(f"[{tag}] stage {name}: exit {stage_rc}, {secs:.2f} s, "
              f"launches { {k: n for k, n in counts.items() if n} }")
        for k, n in counts.items():
            if n != want.get(k, 0):
                fail(f"stage {name}: {k} launched {n} times, its steps need "
                     f"{want.get(k, 0)}")
            totals[k] = totals.get(k, 0) + n
    return totals


def read_logs(tag, ck, stages):
    """Each stage directory's logged series; fails unless every value is
    finite."""
    rows = {}
    for stage in stages:
        with open(os.path.join(ck, stage, "log", "scalars.jsonl")) as f:
            rows[stage] = [json.loads(line) for line in f]
        bad = [r for r in rows[stage] if not math.isfinite(r["value"])]
        if bad or not rows[stage]:
            fail(f"[{tag}] {stage} log: {len(bad)} of {len(rows[stage])} "
                 f"values not finite ({bad[:3]})")
    return rows


def require_checkpoints(ck, paths):
    for path in paths:
        if not os.path.exists(os.path.join(ck, path)):
            fail(f"no checkpoint {path}")


def epoch_steps(xdir, batch_size):
    from gantts_tpu_torch.data import NPYDataSource

    return {phase: -(-len(NPYDataSource(xdir, train=phase == "train")
                          .collect_files()) // batch_size)
            for phase in ("train", "test")}


def curriculum_env(**switches):
    """The process environment without the curriculum's switches, then
    ``switches``."""
    from gantts_tpu_torch import curriculum

    names = {"W_D", "ADV_HPARAMS"} | {
        switch for switch, _ in curriculum.STAGES.values()}
    env = {k: v for k, v in os.environ.items() if k not in names}
    env.update(switches)
    return env


def phase_curriculum(card):
    """Phase 7: the curriculum command with the full-width tts_duration
    bundle (bf16 matmuls) on a synthetic corpus of 96 phone sequences
    (416 -> 5 dims) in a temporary directory, with train_gan.sh's default
    switches: stages 1-3 and 5 (baseline to epoch 2, generator warm-up 1
    epoch, discriminator warm-up 1 epoch, adversarial epoch 2 from both
    warm-ups).  Each stage must launch 12 sru_proj_gemm and 12 sru_fwd_scan
    per step, 12 sru_bwd_scan per step that trains the generator.  Checks
    every checkpoint and that the logged values are finite.  Returns the
    launch counts of all stages."""
    with tempfile.TemporaryDirectory() as tmp:
        write_duration_corpus(tmp)
        xdir, ydir = (os.path.join(tmp, d) for d in ("X_duration",
                                                     "Y_duration"))
        ck = os.path.join(tmp, "ck")
        plan = [("baseline", 2, True), ("generator_warmup", 1, True),
                ("discriminator_warmup", 1, False), ("adversarial", 1, True)]
        totals = run_curriculum(
            "7", ["tts_duration", "compute_dtype=bfloat16", xdir, ydir, ck,
                  "1", "1", "1", "2"], curriculum_env(), plan,
            dict(sru_proj_gemm=12, sru_fwd_scan=12), dict(sru_bwd_scan=12),
            epoch_steps(xdir, DUR_B))
        require_checkpoints(ck, (
            "baseline/checkpoint_epoch2_Generator.pth",
            "gan/checkpoint_epoch1_Generator.pth",
            "gan/checkpoint_epoch1_Discriminator.pth",
            "gan/checkpoint_epoch2_Generator.pth",
            "gan/checkpoint_epoch2_Discriminator.pth"))
        rows = read_logs("7", ck, ("baseline", "gan"))
    for stage, logged in rows.items():
        for r in logged:
            if r["tag"] == "train frames_per_sec":
                print(f"[7] {stage} epoch {r['step']}: {r['value']:.1f} "
                      f"valid phones/s in the train phase  [{card}]")
            elif r["tag"] == "train dur_rmse metric":
                print(f"[7] {stage} epoch {r['step']}: train dur_rmse "
                      f"{r['value']:.4f} frames")
    print(f"[7] {sum(len(r) for r in rows.values())} logged values, all "
          f"finite; checkpoints of stages 1-3 and 5 written")
    return totals


def synth_utterance(rs, n_frames, f0_base):
    """A speech-like int16 waveform of ``n_frames`` 5 ms frames at VC_FS:
    segments of 60-155 ms, three in four voiced (a pulse train at a falling
    F0 with a 5 Hz vibrato) and the rest noise, through a cascade of three
    formant resonators whose targets change from segment to segment."""
    from scipy.signal import lfilter

    n = n_frames * (VC_FS // 200)
    out = np.empty(n)
    zi = [np.zeros(2) for _ in range(3)]
    t, phase = 0, 0.0
    while t < n:
        seg = min(n - t, int(rs.randint(12, 32)) * (VC_FS // 200))
        if rs.rand() < 0.75:
            i = np.arange(t, t + seg)
            f0 = f0_base * (1 - 0.2 * i / n) * (
                1 + 0.03 * np.sin(2 * np.pi * 5 * i / VC_FS))
            track = phase + np.cumsum(f0 / VC_FS)
            src = np.diff(np.floor(np.r_[phase, track]))  # a pulse a period
            phase = track[-1]
        else:
            src = 0.3 * rs.randn(seg)
        for k, (lo, hi, bw) in enumerate(((300, 800, 90), (900, 2200, 110),
                                          (2300, 3200, 170))):
            r = np.exp(-np.pi * bw / VC_FS)
            th = 2 * np.pi * rs.uniform(lo, hi) / VC_FS
            src, zi[k] = lfilter([1 - r], [1, -2 * r * np.cos(th), r * r],
                                 src, zi=zi[k])
        out[t:t + seg] = src
        t += seg
    out += 1e-3 * np.abs(out).max() * rs.randn(n)
    return (out / np.abs(out).max() * 2 ** 14).astype(np.int16)


def write_vc_corpus(dst, num=30, frames=(256, 501), seed=0):
    """A parallel VC corpus in the layout of the training and evaluation
    command lines: ``dst/wav/utt_NNNN.wav`` (int16, VC_FS) from
    synth_utterance, ``dst/X/utt_NNNN.npy`` (T, 177) the port's own analysis
    of that wav as evaluation_vc reads it (WORLD F0 and envelope, 59
    mel-cepstra without the power term, modulation-spectrum smoothing,
    deltas), and ``dst/Y`` the fixed warp 0.9 X + 0.05, a stand-in for a
    second speaker's aligned features.  Frames drawn from ``frames`` (the
    4e assumption: bench.py's 256-512).  Returns the analysis's wall
    seconds."""
    from scipy.io import wavfile

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.core.windows import delta_features
    from gantts_tpu_torch.frontend import sptk, world
    from gantts_tpu_torch.utils.analysis import run_utterance_jobs

    rs = np.random.RandomState(seed)
    for d in ("wav", "X", "Y"):
        os.makedirs(os.path.join(dst, d), exist_ok=True)
    jobs = [(f"utt_{i:04d}", synth_utterance(
        rs, int(rs.randint(*frames)), 90.0 + 60.0 * rs.rand()))
        for i in range(num)]

    def analyze(name, x):
        wavfile.write(os.path.join(dst, "wav", name + ".wav"), VC_FS, x)
        x = x.astype(np.float64)
        f0, tp = world.dio(x, VC_FS, frame_period=5)
        f0 = world.stonemask(x, f0, tp, VC_FS)
        sp = world.cheaptrick(x, f0, tp, VC_FS)
        mc = sptk.sp2mc(sp, order=VC_STATIC,
                        alpha=sptk.mcepalpha(VC_FS))[:, 1:]
        mc = P.modspec_smoothing(mc, 200.0, cutoff=50)
        src = delta_features(mc, hparams.vc.windows).astype(np.float32)
        np.save(os.path.join(dst, "X", name + ".npy"), src)
        np.save(os.path.join(dst, "Y", name + ".npy"), 0.9 * src + 0.05)

    t0 = time.perf_counter()
    run_utterance_jobs(analyze, jobs, 4)
    return time.perf_counter() - t0


def phase_vc_curriculum(card, tmp):
    """Phase 8: the curriculum command with the vc bundle in its own
    float32 and ``generator=In2OutRNNHighwayNet`` at full width (3x512
    unidirectional LSTM, 177 -> 177), on write_vc_corpus's 30 utterances in
    ``tmp``, through all five stages (``RUN_SPOOFING_MODEL=1``): baseline to
    epoch 2, generator warm-up 1 epoch, discriminator warm-up 1 epoch, the
    spoofing model 2 epochs against the baseline generator, adversarial
    epoch 2 with the spoofing model as its reference discriminator.  Each
    stage must launch 3 sru_proj_gemm and 3 lstm_fwd_scan per step (the
    f32 flag design), 3 lstm_bwd_scan per step that trains the
    generator.  Checks every checkpoint, that the logged values are finite
    and that stage 5 logged the spoofing rate.  Returns the launch counts
    of all stages and the final generator's checkpoint."""
    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.frontend import native

    secs = write_vc_corpus(tmp)
    print(f"[8] corpus: 30 utterances analysed in {secs:.2f} s by the "
          f"{native.engine()} front end")
    xdir, ydir = (os.path.join(tmp, d) for d in ("X", "Y"))
    ck = os.path.join(tmp, "ck")
    plan = [("baseline", 2, True), ("generator_warmup", 1, True),
            ("discriminator_warmup", 1, False), ("spoofing_model", 2, False),
            ("adversarial", 1, True)]
    totals = run_curriculum(
        "8", ["vc", "generator=In2OutRNNHighwayNet", xdir, ydir, ck, "1",
              "1", "2", "2"], curriculum_env(RUN_SPOOFING_MODEL="1"), plan,
        dict(sru_proj_gemm=3, lstm_fwd_scan=3), dict(lstm_bwd_scan=3),
        epoch_steps(xdir, hparams.vc.batch_size))
    final = "gan/checkpoint_epoch2_Generator.pth"
    require_checkpoints(ck, (
        "baseline/checkpoint_epoch2_Generator.pth",
        "gan/checkpoint_epoch1_Generator.pth",
        "gan/checkpoint_epoch1_Discriminator.pth",
        "spoofing_model/checkpoint_epoch2_Discriminator.pth", final,
        "gan/checkpoint_epoch2_Discriminator.pth"))
    rows = read_logs("8", ck, ("baseline", "gan", "spoofing_model"))
    spoof = {r["tag"]: r["value"] for r in rows["gan"]
             if r["tag"].endswith("spoofing rate")}
    print(f"[8] stage 5's spoofing rate (frames the reference discriminator "
          f"takes for natural): {spoof}")
    if set(spoof) != {"train spoofing rate", "test spoofing rate"} or not \
            all(0 <= v <= 1 for v in spoof.values()):
        fail("stage 5 did not log the spoofing rate of both phases")
    for stage, logged in rows.items():
        for r in logged:
            if r["tag"] == "train frames_per_sec":
                print(f"[8] {stage} epoch {r['step']}: {r['value']:.1f} "
                      f"valid frames/s in the train phase  [{card}]")
            elif r["tag"] == "train mcd metric":
                print(f"[8] {stage} epoch {r['step']}: train mcd "
                      f"{r['value']:.4f} dB")
    print(f"[8] {sum(len(r) for r in rows.values())} logged values, all "
          f"finite; checkpoints of all five stages written")
    return totals, os.path.join(ck, final)


def phase_vc_eval(card, tmp, checkpoint):
    """Phase 9: ``python -m gantts_tpu_torch.evaluation_vc``'s main() with
    phase 8's final generator on the card, over the wavs of the corpus's
    eval and test files, ``--workers=1``: with ``--diffvc`` (the MLSA
    filter on the source) and without (WORLD synthesis).  Each utterance
    must launch 3 sru_proj_gemm and 3 lstm_fwd_scan and no lstm_bwd_scan;
    each waveform must be finite and not silent, and analysis.json
    written.  Prints the front end's engine and the seconds an utterance
    takes, then holds the first utterance's prediction to the CPU's
    (check_vc_prediction).  Returns the launch counts of both runs."""
    from scipy.io import wavfile

    from gantts_tpu_torch import evaluation_vc, synthesis
    from gantts_tpu_torch.frontend import native
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts

    real, waves, totals = synthesis.vc_from_waveform, [], {}
    real_apply, first = synthesis.apply_vc_model, []

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        waves.append(out[0])
        return out

    def recorded_apply(model, mc_scaled, hp):
        out = real_apply(model, mc_scaled, hp)
        if not first:
            first.append((model, mc_scaled.copy(), hp, out.copy()))
        return out

    names = [os.path.basename(p) for sub in (False, True)
             for p in evaluation_vc.get_wav_files(tmp, "", test=sub)]
    for diffvc in (True, False):
        out_dir = os.path.join(tmp, f"out_diffvc{int(diffvc)}")
        argv = [checkpoint, tmp, os.path.join(tmp, "wav"), out_dir,
                "--hparams=generator=In2OutRNNHighwayNet", "--workers=1",
                "--device=cuda"] + ["--diffvc"] * diffvc
        waves.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
                plain_versions_forbidden():
            synthesis.vc_from_waveform = recorded
            synthesis.apply_vc_model = recorded_apply
            try:
                rc = evaluation_vc.main(argv)
            finally:
                synthesis.vc_from_waveform = real
                synthesis.apply_vc_model = real_apply
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / len(names)
        counts = {k: n for k, n in launch_counts.items()}
        print(f"[9] evaluation_vc {'--diffvc' if diffvc else '(WORLD)'}: "
              f"exit {rc}, {len(waves)} utterances, {secs:.3f} s an "
              f"utterance with the {native.engine()} front end; launches "
              f"{ {k: n for k, n in counts.items() if n} }  [{card}]")
        want = dict(sru_proj_gemm=3 * len(names),
                    lstm_fwd_scan=3 * len(names))
        if rc != 0 or len(waves) != len(names):
            fail(f"evaluation_vc exited {rc} after {len(waves)} of "
                 f"{len(names)} utterances")
        for k, n in counts.items():
            if n != want.get(k, 0):
                fail(f"evaluation_vc: {k} launched {n} times, its "
                     f"utterances need {want.get(k, 0)}")
            totals[k] = totals.get(k, 0) + n
        for w in waves:
            if not np.isfinite(w).all() or np.abs(w).max() < 100:
                fail("a converted waveform is not finite or is silent")
        for sub, n in (("eval", len(names) - 5), ("test", 5)):
            got = sorted(os.listdir(os.path.join(out_dir, sub)))
            if len(got) != n:
                fail(f"{out_dir}/{sub} holds {len(got)} wavs, expected {n}")
            fs, y = wavfile.read(os.path.join(out_dir, sub, got[0]))
            if fs != VC_FS or y.dtype != np.int16:
                fail(f"{got[0]}: {fs} Hz {y.dtype}, expected int16 at "
                     f"{VC_FS} Hz")
        with open(os.path.join(out_dir, "analysis.json")) as f:
            report = json.load(f)
        if not math.isfinite(report["gv_ratio"]):
            fail(f"analysis.json: gv_ratio {report['gv_ratio']}")
        print(f"[9] peaks {min(np.abs(w).max() for w in waves):.1f} to "
              f"{max(np.abs(w).max() for w in waves):.1f}; analysis.json "
              f"gv_ratio {report['gv_ratio']:.4f}")
    check_vc_prediction(*first[0])
    return totals


def check_vc_prediction(model, mc_scaled, hp, y_card):
    """Phase 9's first utterance: the static mel-cepstra the card predicted
    inside evaluation_vc against synthesis.apply_vc_model on a CPU copy of
    the generator, same input, and against the card with TF32 matmuls as a
    control.  An In2Out generator passes its input statics through exactly
    (y = x_static + gate * MLPG(G(x))), so both sides compare y - x_static,
    the part the generator computes, as max|card - cpu| / max|cpu|: limit
    VC_Y_RTOL, which the control must exceed."""
    import copy

    from gantts_tpu_torch import synthesis

    x_static = mc_scaled[:, :VC_STATIC]
    y_cpu = synthesis.apply_vc_model(copy.deepcopy(model).cpu(), mc_scaled,
                                     hp)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_control = synthesis.apply_vc_model(model, mc_scaled, hp)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = y_cpu - x_static
    scale = float(np.abs(ref).max())

    def gap(y):
        return float(np.abs((y - x_static) - ref).max()) / scale

    g, gc = gap(y_card), gap(y_control)
    print(f"[9] first utterance ({mc_scaled.shape[0]} frames): card against "
          f"CPU, y_static - x_static gap {g:.2e} of scale {scale:.4f}, limit "
          f"{VC_Y_RTOL:.0e} {'ok' if g <= VC_Y_RTOL else 'FAIL'}; "
          f"control(tf32) gap {gc:.2e}")
    if not g <= VC_Y_RTOL:
        fail("evaluation_vc: the card's prediction differs from the CPU's")
    if not gc > VC_Y_RTOL:
        fail("evaluation_vc: the TF32 control stays within the limit, so "
             "the comparison cannot see a TF32 matmul")


TTS_VOWELS = ("aa", "ae", "ah", "ao", "eh", "ey", "ih", "iy", "ow", "uw")
TTS_CONSONANTS = ("b", "d", "f", "hh", "k", "l", "m", "n", "r", "s", "t",
                  "w", "z")
TTS_UTTERANCES = 24  # 19 for training and validation, 5 held out
TTS_FRAMES = (400, 801)  # 2-4 s at 5 ms: the ARCTIC assumption, PERF.md
# The first utterance's predictions on the card against a CPU copy of each
# generator, max|card - cpu| / max|cpu| (phase 9's limit, PROBE_RTOL).
TTS_Y_RTOL = 2e-5


def tts_context(rs, ll, l, c, r, rr):
    """One phone's HTS full-context label in the layout the shipped
    416-question set (data/questions-radio_dnn_416.hed) reads: the quinphone,
    then syllable, word, phrase and utterance fields (/A: to /J:) with
    numbers drawn at random, and 'x' numbers for pauses."""
    if c == "pau":
        return (f"{ll}^{l}-{c}+{r}={rr}@x_x/A:0_0_0/B:x-x-x@x-x&x-x#x-x$x-x"
                "!x-x;x-x|x/C:0+0+0/D:0_0/E:x+x@x+x&x+x#x+x/F:0_0/G:0_0"
                "/H:x=x@1=1|0/I:0_0/J:18+7-1")

    def n(lo, hi):
        return int(rs.randint(lo, hi + 1))
    vowel = c if c in TTS_VOWELS else "novowel"
    return (f"{ll}^{l}-{c}+{r}={rr}@{n(1, 3)}_{n(1, 3)}"
            f"/A:{n(0, 1)}_{n(0, 1)}_{n(1, 4)}"
            f"/B:{n(0, 1)}-{n(0, 1)}-{n(1, 4)}@{n(1, 3)}-{n(1, 3)}"
            f"&{n(1, 8)}-{n(1, 8)}#{n(0, 3)}-{n(0, 3)}${n(0, 3)}-{n(0, 3)}"
            f"!{n(0, 4)}-{n(0, 4)};{n(0, 4)}-{n(0, 4)}|{vowel}"
            f"/C:{n(0, 1)}+{n(0, 1)}+{n(1, 4)}/D:content_{n(1, 3)}"
            f"/E:content+{n(1, 3)}@{n(1, 6)}+{n(1, 6)}&{n(0, 4)}+{n(0, 4)}"
            f"#{n(0, 3)}+{n(0, 3)}/F:content_{n(1, 3)}/G:{n(0, 10)}_{n(0, 6)}"
            f"/H:{n(3, 12)}={n(2, 8)}@1={n(1, 2)}|L-L%/I:{n(0, 10)}_{n(0, 6)}"
            f"/J:{n(10, 30)}+{n(5, 15)}-{n(1, 3)}")


def write_tts_corpus(dst, num=TTS_UTTERANCES, frames=TTS_FRAMES, seed=0):
    """A TTS corpus in the Merlin slt_arctic layout that
    prepare_features_tts reads: ``dst/wav/utt_NNNN.wav`` (int16, VC_FS,
    synth_utterance) and ``dst/label_state_align/utt_NNNN.lab``, five
    states a phone with durations in 5 ms frames (2-8, a pause's 4-12)
    that sum to the waveform's frames exactly.  Each utterance opens and
    closes with a pause and alternates consonants and vowels between; its
    frames are drawn from ``frames`` (the ARCTIC assumption)."""
    from scipy.io import wavfile

    rs = np.random.RandomState(seed)
    for d in ("wav", "label_state_align"):
        os.makedirs(os.path.join(dst, d), exist_ok=True)
    shift = 50000  # 5 ms in HTS's 100 ns units
    for i in range(num):
        target = int(rs.randint(*frames))
        phones, durs = [], []
        while not durs or sum(map(sum, durs)) < target - 60:
            phone = ("pau" if not phones else
                     TTS_VOWELS[rs.randint(len(TTS_VOWELS))] if len(phones) % 2
                     else TTS_CONSONANTS[rs.randint(len(TTS_CONSONANTS))])
            phones.append(phone)
            durs.append(list(rs.randint(4, 13, 5) if phone == "pau"
                             else rs.randint(2, 9, 5)))
        phones.append("pau")
        durs.append(list(rs.randint(4, 13, 5)))
        padded = ["x", "x"] + phones + ["x", "x"]
        lines, t = [], 0
        for p, phone in enumerate(phones):
            ctx = tts_context(rs, *padded[p:p + 5])
            for k, d in enumerate(durs[p]):
                lines.append(f"{t} {t + int(d) * shift} {ctx}[{k + 2}]")
                t += int(d) * shift
        name = f"utt_{i:04d}"
        with open(os.path.join(dst, "label_state_align", name + ".lab"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        wavfile.write(os.path.join(dst, "wav", name + ".wav"), VC_FS,
                      synth_utterance(rs, t // shift,
                                      100.0 + 80.0 * rs.rand()))


def prepare_tts_features(card, root, feats):
    """Phase 10's feature extraction: ``python -m
    gantts_tpu_torch.prepare_features_tts`` in a subprocess (host work
    alone, 8 worker processes), then the outputs' dims (416 / 5 / 425 /
    187), non-constant phone-level columns and finite values."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gantts_tpu_torch.prepare_features_tts", root,
         f"--dst_dir={feats}", "--workers=8"], cwd=here, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        fail(f"prepare_features_tts exited {proc.returncode}")
    dims, arrays = {}, {}
    for sub in ("X_duration", "Y_duration", "X_acoustic", "Y_acoustic"):
        d = os.path.join(feats, sub)
        arrays[sub] = [np.load(os.path.join(d, f))
                       for f in sorted(os.listdir(d))]
        dims[sub] = {a.shape[1] for a in arrays[sub]}
        if len(arrays[sub]) != TTS_UTTERANCES or not all(
                np.isfinite(a).all() for a in arrays[sub]):
            fail(f"{sub}: {len(arrays[sub])} files, or values that are not "
                 f"finite")
    varying = int((np.concatenate(arrays["X_duration"]).std(axis=0)
                   > 0).sum())
    frames = sum(len(a) for a in arrays["Y_acoustic"])
    print(f"[10] prepare_features_tts: {TTS_UTTERANCES} utterances, "
          f"{frames} frames after silences, in {secs:.2f} s (subprocess, 8 "
          f"workers); dims {dims}; {varying} of {PHONE_DIM} phone-level "
          f"columns vary  [{card}]")
    if dims != {"X_duration": {PHONE_DIM}, "Y_duration": {DUR_DIM},
                "X_acoustic": {LIN_DIM}, "Y_acoustic": {OUT_DIM}}:
        fail(f"prepare_features_tts wrote dims {dims}")
    if varying < 50:
        fail(f"only {varying} phone-level columns vary: the questions do "
             f"not read the labels")


def tts_eval_run(card, tmp, feats, labels, tag, ckpts, workers, extra):
    """One ``python -m gantts_tpu_torch.evaluation_tts`` main() on the card,
    ``--post-filter --workers=<workers>`` and ``extra``, every plain version
    refused, its forwards and waveforms recorded.  Checks the exit code,
    the launches (per utterance 24 sru_proj_gemm and 24 sru_fwd_scan, 12
    and 12 without the duration model, no sru_bwd_scan), the wavs (int16,
    finite before the cast, not silent, each as long as its predicted
    frames), and analysis.json.  Returns the launch counts and the recorded
    forwards: (model, input, hp, output) each."""
    from scipy.io import wavfile

    from gantts_tpu_torch import evaluation_tts, synthesis
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts

    real_forward, real_wave = synthesis.model_forward, synthesis.gen_waveform
    forwards, waves = [], []

    def recorded_forward(model, x, hp):
        out = real_forward(model, x, hp)
        forwards.append((model, x.copy(), hp, out.copy()))
        return out

    def recorded_wave(*args, **kwargs):
        out = real_wave(*args, **kwargs)
        waves.append(out[0])
        return out

    out_dir = os.path.join(tmp, f"synth_{tag}")
    argv = [ckpts["acoustic"], ckpts["duration"], feats, labels, out_dir,
            "--post-filter", f"--workers={workers}", "--device=cuda"] + extra
    n_utt = len(evaluation_tts.get_lab_files(feats, labels)) + \
        len(evaluation_tts.get_lab_files(feats, labels, test=True))
    reset_launch_counts()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            plain_versions_forbidden():
        synthesis.model_forward = recorded_forward
        synthesis.gen_waveform = recorded_wave
        try:
            rc = evaluation_tts.main(argv)
        finally:
            synthesis.model_forward = real_forward
            synthesis.gen_waveform = real_wave
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / n_utt
    counts = {k: n for k, n in launch_counts.items() if n}
    with_dur = "--disable-duraton-gen" not in extra
    per_utt = 24 if with_dur else 12
    print(f"[10] evaluation_tts {tag} ({' '.join(extra) or 'durations'}): "
          f"exit {rc}, {len(waves)} utterances, {secs:.3f} s an utterance "
          f"({workers} thread(s)); launches {counts}  [{card}]")
    if rc != 0 or len(waves) != n_utt:
        fail(f"evaluation_tts exited {rc} after {len(waves)} of {n_utt} "
             f"utterances")
    want = dict(sru_proj_gemm=per_utt * n_utt, sru_fwd_scan=per_utt * n_utt)
    for k, n in launch_counts.items():
        if n != want.get(k, 0):
            fail(f"evaluation_tts {tag}: {k} launched {n} times, its "
                 f"utterances need {want.get(k, 0)}")
    acoustic = [f for f in forwards if f[3].shape[1] == OUT_DIM]
    if len(acoustic) != n_utt or len(forwards) != n_utt * (1 + with_dur):
        fail(f"evaluation_tts {tag}: {len(forwards)} forwards for {n_utt} "
             f"utterances")
    for w in waves:
        if not np.isfinite(w).all() or np.abs(w).max() < 100:
            fail("a synthesized waveform is not finite or is silent")
    lengths = []
    for sub in ("eval", "test"):
        for name in sorted(os.listdir(os.path.join(out_dir, sub))):
            fs, y = wavfile.read(os.path.join(out_dir, sub, name))
            if fs != VC_FS or y.dtype != np.int16:
                fail(f"{name}: {fs} Hz {y.dtype}, expected int16 at {VC_FS}")
            lengths.append(len(y))
    hop = VC_FS // 200
    if sorted(lengths) != sorted(len(f[1]) * hop for f in acoustic):
        fail(f"evaluation_tts {tag}: wav lengths {sorted(lengths)} are not "
             f"the predicted frames x {hop}")
    with open(os.path.join(out_dir, "analysis.json")) as f:
        report = json.load(f)
    if not math.isfinite(report["gv_ratio"]):
        fail(f"analysis.json: gv_ratio {report['gv_ratio']}")
    print(f"[10] {n_utt} wavs of {min(lengths) / VC_FS:.2f}-"
          f"{max(lengths) / VC_FS:.2f} s, each its predicted frames x {hop}"
          f"; analysis.json gv_ratio {report['gv_ratio']:.4f}")
    return launch_counts.copy(), forwards


def check_tts_predictions(card, forwards):
    """Phase 10's first utterance: the duration model's prediction (before
    rounding) and the acoustic model's, as evaluation_tts made them on the
    card, against synthesis.model_forward on a CPU copy of each generator,
    same input, and against the card with TF32 matmuls as a control: max
    |card - cpu| / max |cpu| within TTS_Y_RTOL, which the control must
    exceed.  Then the device time of each forward by CUDA events (the span
    from before its input's copy to after its output's)."""
    import copy

    from gantts_tpu_torch import synthesis

    first = {}
    for model, x, hp, y in forwards:
        first.setdefault(y.shape[1], (model, x, hp, y))
    for dim, what in ((DUR_DIM, "duration"), (OUT_DIM, "acoustic")):
        model, x, hp, y_card = first[dim]
        y_cpu = synthesis.model_forward(copy.deepcopy(model).cpu(), x, hp)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            y_control = synthesis.model_forward(model, x, hp)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        scale = float(np.abs(y_cpu).max())
        g = float(np.abs(y_card - y_cpu).max()) / scale
        gc = float(np.abs(y_control - y_cpu).max()) / scale
        spans = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            synthesis.model_forward(model, x, hp)
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        print(f"[10] first utterance, {what} model ({x.shape[0]} steps): "
              f"card against CPU {g:.2e} of scale {scale:.4f}, limit "
              f"{TTS_Y_RTOL:.0e} {'ok' if g <= TTS_Y_RTOL else 'FAIL'}; "
              f"control(tf32) {gc:.2e}; forward on the card "
              f"{min(spans):.3f} ms (CUDA events, best of 5)  [{card}]")
        if not g <= TTS_Y_RTOL:
            fail(f"evaluation_tts: the card's {what} prediction differs from "
                 f"the CPU's")
        if not gc > TTS_Y_RTOL:
            fail(f"evaluation_tts: the TF32 control of the {what} model stays "
                 f"within the limit, so the comparison cannot see a TF32 "
                 f"matmul")


def phase_tts_demo(card, tmp):
    """Phase 10: tts_demo.sh on the card, from wavs and labels to wavs.
    write_tts_corpus's 24 utterances; their features by the port's
    prepare_features_tts (prepare_tts_features); the curriculum command
    for tts_duration and for tts_acoustic at full width in the bundles' own
    float32, stages 1-3 and 5 (baseline to epoch 2, generator warm-up 1
    epoch, discriminator warm-up 1 epoch, adversarial epoch 2), 12
    sru_proj_gemm and 12 sru_fwd_scan a step and 12 sru_bwd_scan a step
    that trains the generator; then evaluation_tts on the baseline and on
    the adversarial generators with 4 threads, and without the duration
    model on one (tts_eval_run), and the first utterance's predictions
    against the CPU (check_tts_predictions).  Returns the launch counts of
    all of it."""
    from gantts_tpu_torch import hparams

    root, feats = os.path.join(tmp, "corpus"), os.path.join(tmp, "feats")
    t0 = time.perf_counter()
    write_tts_corpus(root)
    print(f"[10] corpus: {TTS_UTTERANCES} utterances (wav and "
          f"label_state_align) written in {time.perf_counter() - t0:.2f} s")
    prepare_tts_features(card, root, feats)
    plan = [("baseline", 2, True), ("generator_warmup", 1, True),
            ("discriminator_warmup", 1, False), ("adversarial", 1, True)]
    totals, ckpts = {}, {}
    for typ in ("duration", "acoustic"):
        xdir, ydir = (os.path.join(feats, f"{d}_{typ}") for d in "XY")
        ck = os.path.join(tmp, f"ck_{typ}")
        counts = run_curriculum(
            "10", [f"tts_{typ}", "compute_dtype=float32", xdir, ydir, ck,
                   "1", "1", "1", "2"], curriculum_env(), plan,
            dict(sru_proj_gemm=12, sru_fwd_scan=12), dict(sru_bwd_scan=12),
            epoch_steps(xdir, getattr(hparams, f"tts_{typ}").batch_size))
        require_checkpoints(ck, (
            "baseline/checkpoint_epoch2_Generator.pth",
            "gan/checkpoint_epoch1_Generator.pth",
            "gan/checkpoint_epoch1_Discriminator.pth",
            "gan/checkpoint_epoch2_Generator.pth",
            "gan/checkpoint_epoch2_Discriminator.pth"))
        rows = read_logs("10", ck, ("baseline", "gan"))
        for stage, logged in rows.items():
            for r in logged:
                if r["tag"] == "train frames_per_sec":
                    print(f"[10] tts_{typ} {stage} epoch {r['step']}: "
                          f"{r['value']:.1f} valid "
                          f"{'phones' if typ == 'duration' else 'frames'}/s "
                          f"in the train phase  [{card}]")
        print(f"[10] tts_{typ}: {sum(len(r) for r in rows.values())} logged "
              f"values, all finite; checkpoints of stages 1-3 and 5 written")
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        ckpts[typ] = ck
    labels = os.path.join(root, "label_state_align")
    first = None
    # the last run on one thread: the host chain's Python (freqt's loop,
    # the questions' regexes) holds the GIL, so threads may not pay
    for tag, stage, workers, extra in (
            ("baseline", "baseline/checkpoint_epoch2", 4, []),
            ("gan", "gan/checkpoint_epoch2", 4, []),
            ("gan_label_timings", "gan/checkpoint_epoch2", 1,
             ["--disable-duraton-gen"])):
        paths = {typ: os.path.join(ck, f"{stage}_Generator.pth")
                 for typ, ck in ckpts.items()}
        counts, forwards = tts_eval_run(card, tmp, feats, labels, tag, paths,
                                        workers, extra)
        first = first or forwards
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    check_tts_predictions(card, first)
    return totals


def main_paths():
    """Phase 4's paths: (tag, hparams, launches a step of each kernel,
    expected parameter counts of the generator and the discriminator,
    batch maker, unit of a time step)."""
    none = {k: 0 for k in KERNELS}
    vc_disc = mlp_param_count([VC_STATIC, 256, 256, 1])
    return [("4", acoustic_hp("bfloat16"),
             dict(none, sru_proj_gemm=12, sru_fwd_scan=12, sru_bwd_scan=12),
             (sru_param_count(LIN_DIM, H, 6, OUT_DIM, True), None),
             acoustic_batch, "frames"),
            ("4b", lstm_hp("bfloat16"),
             dict(none, sru_proj_gemm=6, lstm_fwd_scan=6, lstm_bwd_scan=6),
             (lstm_param_count(LIN_DIM, H, 6, OUT_DIM), None),
             acoustic_batch, "frames"),
            ("4c", acoustic_hp("bfloat16", bidirectional=False),
             dict(none, sru_proj_gemm=1, sru_fwd_scan=1, sru_bwd_scan=1,
                  linear_recurrence_fwd=5, linear_recurrence_bwd=5),
             (sru_param_count(LIN_DIM, H, 6, OUT_DIM, False), None),
             acoustic_batch, "frames"),
            ("4d", duration_hp("bfloat16"),
             dict(none, sru_proj_gemm=12, sru_fwd_scan=12, sru_bwd_scan=12),
             (sru_param_count(PHONE_DIM, H, 6, DUR_DIM, True), None),
             duration_batch, "phones"),
            ("4e", vc_hp("bfloat16", "In2OutRNNHighwayNet"),
             dict(none, sru_proj_gemm=3, lstm_fwd_scan=3, lstm_bwd_scan=3),
             (in2out_param_count("In2OutRNNHighwayNet"), vc_disc),
             vc_batch, "frames"),
            ("4f", vc_hp("bfloat16", "In2OutHighwayNet"), none,
             (in2out_param_count("In2OutHighwayNet"), vc_disc), vc_batch,
             "frames"),
            ("4g", acoustic_hp("float32"),
             dict(none, sru_proj_gemm=12, sru_fwd_scan=12, sru_bwd_scan=12),
             (sru_param_count(LIN_DIM, H, 6, OUT_DIM, True), None),
             acoustic_batch, "frames"),
            ("4h", vc_hp("float32", "In2OutRNNHighwayNet"),
             dict(none, sru_proj_gemm=3, lstm_fwd_scan=3, lstm_bwd_scan=3),
             (in2out_param_count("In2OutRNNHighwayNet"), vc_disc),
             vc_batch, "frames")]


def run_path(dev, card, tag, hp, per_step, n_expected, make_batch, unit,
             require_design=True):
    """One phase 4 path with every plain version refused: its timed steps
    (phase_main_path), its trace (phase_profile) and, where it launches the
    LSTM scans and ``require_design``, the trace's proof that they ran the
    design of the path's dtype (DESIGN).  Returns the launch counts of the
    timed steps."""
    from gantts_tpu_torch.kernels.sru_scan import io_dtype

    with plain_versions_forbidden():
        counts, ms, run_steps = phase_main_path(dev, card, tag, hp, per_step,
                                                n_expected, make_batch, unit)
        names = phase_profile(tag, run_steps, ms, card)
    design = DESIGN[io_dtype(hp.compute_dtype)]
    for way in ("fwd", "bwd"):
        if not (require_design and counts[f"lstm_{way}_scan"]) or \
                names is None:
            continue
        took = any(f"lstm_{way}_{design}_kernel" in n for n in names)
        print(f"[{tag}] the trace holds lstm_{way}_scan's {design} kernel: "
              f"{took}")
        if not took:
            fail(f"step {tag}: lstm_{way}_scan did not run its {design} "
                 f"kernel")
    return counts


def main():
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    from gantts_tpu_torch.core import paramgen  # noqa: F401  (TF32 off)
    from gantts_tpu_torch.frontend import native
    from gantts_tpu_torch.kernels import _build, linear_scan, lstm_scan, \
        sru_scan

    print(f"[1] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    # one nvcc per source and the host front end's g++, all together
    with ThreadPoolExecutor() as pool:
        for f in [pool.submit(m._lib)
                  for m in (sru_scan, lstm_scan, linear_scan)] + [
                      pool.submit(native.available)]:
            f.result()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    print(f"[2] host front end (WORLD/SPTK): {native.engine()}")
    for name, (secs, log) in _build.build_log.items():
        print(f"[2] nvcc {name}: {secs:.2f} s")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "warning", "wgmma", "setmaxnreg")):
                print(f"[2]   {line.strip()}")
    check_sass(sru_scan._lib()._name)
    check_sass(lstm_scan._lib()._name, LSTM_SASS_RULES)

    errs = {k: 0.0 for k in KERNELS}
    recs = phase_kernels(dev, card, errs)
    recs.update(phase_lstm_kernels(dev, card, errs))
    recs.update(phase_linear_kernels(dev, card, errs))
    for k, rec in phase_vc_lstm_kernels(dev, card, errs).items():
        recs[k]["f32"] = rec
    phase_synthesis_kernels(dev, card, errs)
    recs["sru_proj_gemm"]["f32"] = phase_f32_gemm(dev, card, errs)
    launches = {k: 0 for k in KERNELS}
    for path in main_paths():
        for k, n in run_path(dev, card, *path).items():
            launches[k] += n
    for tag, hp in SMALL_ACOUSTIC_STEPS.items():
        phase_small_step(dev, tag, hp())
    phase_small_step(dev, "5d", duration_hp(
        "float32", num_hidden=2, hidden_dim=64, dropout=0.0, rnn_dropout=0.0))
    phase_small_step(dev, "5e", vc_hp(
        "float32", "In2OutRNNHighwayNet", num_hidden=2, hidden_dim=64,
        dropout=0.0), probe=in2out_probe)
    for k, n in phase_cli(card).items():
        launches[k] += n
    for k, n in phase_curriculum(card).items():
        launches[k] += n
    with tempfile.TemporaryDirectory() as tmp:
        counts, checkpoint = phase_vc_curriculum(card, tmp)
        for k, n in list(counts.items()) + list(
                phase_vc_eval(card, tmp, checkpoint).items()):
            launches[k] += n
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in phase_tts_demo(card, tmp).items():
            launches[k] += n

    # launches: the main paths' runs, 4-4f, 6, 7, 8, 9 and 10 (sru_proj_gemm
    # and the scans serve several)
    print(f"[end] all phases passed in {time.perf_counter() - started:.1f} s")
    kernels = [dict({"name": k, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": errs[k]}, **recs[k])
               for k, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
