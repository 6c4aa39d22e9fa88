#!/usr/bin/env python3
"""Where a step of the port's float32 LSTM scans goes, on one NVIDIA GPU.

Builds ``gantts_tpu_torch/kernels/csrc/lstm_scan.cu`` as it is and copies
with parts of a design's step taken out (patched by exact text: a patch
that no longer matches raises; each is applied wherever it matches), then
times ``lstm_fwd_scan`` and
``lstm_bwd_scan`` of each copy through the package's wrappers at the vc
step's shape (T=512, B=20, H=512, float32, all rows full length), with one
direction and with two, by CUDA events.  The parts of the cooperative
design (the persistent kernels ``lstm_fwd_kernel`` / ``lstm_bwd_kernel``,
forced at every shape in its copies):

  full             the kernels as they are;
  no staging       the product's operand is not read from L2 (shared
                   memory is filled with zeros instead): h_{t-1} in the
                   forward, dgates_t (160 KB a block) in the backward;
  no product       no FMA loop (the partial sums are zeros);
  no barrier       the grid barrier's fence, atomic and spin taken out
                   (one block barrier left);
  no cell loads    the cell reads no xp, bias or length (forward) and no
                   g4, c, c_{t-1}, gy or length (backward) from memory;
  staging 40 KB    (backward) only the first 512 of dgates_t's 2048 k are
                   staged, the forward's 40 KB.

With ``--design flag`` the same for the float32 design with per-block step
flags (``lstm_fwd_flag_kernel`` / ``lstm_bwd_flag_kernel``):

  full             the kernels as they are (the launcher's plan);
  no exchange      no block waits for a flag or stages h or the partial
                   dh (the product and the sums read what shared memory
                   holds);
  no product       no FMA loop;
  relaxed flag     the flag stored without release semantics (what
                   the release's wait for the step's stores costs);
  no cell loads    the cell's inputs are not read from memory;
  last warp's flag the flag released by the last warp's thread, not thread
                   0 (whose warp has the cells' stores in flight);
  one row slice    every row in one slice (the plan before row slices: the
                   forward at 4 units a block, the backward at 8, with one
                   direction 128 and 64 blocks);
  U=8 / U=4        both kernels at 8 or 4 units a block, one row slice
                   (the plan takes 8 units in two row slices with one
                   direction, 8 in one with two).

Each difference from ``full`` bounds what that part adds to the serial
chain.  The copies compute wrong values; only their times mean anything.
Run from the root of the repository:

    python3 tools/torch_lstm_f32_parts.py [--design cooperative|flag]
        [--out FILE]

``--shapes`` instead times the flag design against the cooperative
kernels (the parent's f32 design, forced in a copy) at every f32 shape that
chip_smoke.py phase 3 times, in turns; ``--step-tree DIR`` runs
chip_smoke.py's phase 4h (the f32 In2OutRNNHighwayNet vc step, timed and
traced), after the f32 one-direction layer beside cuDNN's with its
breakdown by kernel, on the gantts_tpu_torch package of another checkout,
such as the parent's unpacked by ``git archive``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from os.path import abspath, dirname, join

import torch

ROOT = dirname(dirname(abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, time_ms  # noqa: E402
from gantts_tpu_torch.kernels import _build  # noqa: E402
from gantts_tpu_torch.kernels import lstm_scan as L  # noqa: E402

T, B, H = 512, 20, 512

# --- the cooperative design -------------------------------------------------
COOP_STAGING = [
    ("        if (r < nr) v[r] = load_cg(src + (size_t)r * ld + k0 + kk);",
     "        if (r < nr) v[r] = from_f32<T>(0.f);")]
COOP_STAGING_40K = [
    ("    for (int kk = tid; kk < kc; kk += kThreads) {\n      T v[kRows];",
     "    for (int kk = tid; kk < (k0 ? 0 : kc); kk += kThreads) {\n"
     "      T v[kRows];")]
COOP_PRODUCT = [
    ("      for (int k = kg; k < kc; k += nkg) {",
     "      for (int k = kg; k < 0; k += nkg) {")]
COOP_BARRIER = [
    ("  __syncthreads();\n  if (threadIdx.x == 0) {\n    __threadfence();\n"
     "    atomicAdd(count, 1u);\n    while (ld_acquire(count) < target) {\n"
     "    }\n    __threadfence();\n  }\n  __syncthreads();",
     "  __syncthreads();")]
COOP_CELL_LOADS = [
    ("          pre[g] = (to_f32(xr[(size_t)g * H]) + bd[g * H + j]) + acc;",
     "          pre[g] = (0.25f + 0.125f * g) + acc;"),
    ("        const float m = t < lengths[b] ? 1.f : 0.f;\n"
     "        const float ig = sigmoidf(pre[0]), fg = sigmoidf(pre[1]);",
     "        const float m = 1.f;\n"
     "        const float ig = sigmoidf(pre[0]), fg = sigmoidf(pre[1]);"),
    ("      const float m = t < lengths[b] ? 1.f : 0.f;\n"
     "      const T* gr = g4 + row * G + (size_t)d * 4 * H + j;\n"
     "      const float ig = to_f32(gr[0]), fg = to_f32(gr[H]);\n"
     "      const float gg = to_f32(gr[2 * H]), og = to_f32(gr[3 * H]);\n"
     "      const float ct = c[row * Y + (size_t)d * H + j];\n"
     "      const float cp = (tp >= 0 && tp < nt)\n"
     "                           ? c[((size_t)tp * B + b) * Y + (size_t)d * H"
     " + j]\n"
     "                           : 0.f;\n"
     "      const float tc = tanhf(ct);\n"
     "      const float da = m * (dh[i] + to_f32(gy[row * Y + (size_t)d * H"
     " + j]));",
     "      const float m = 1.f;\n"
     "      const float ig = 0.5f, fg = 0.5f, gg = 0.25f, og = 0.5f;\n"
     "      const float ct = 0.125f * (tp & 1), cp = 0.0625f;\n"
     "      const float tc = tanhf(ct);\n"
     "      const float da = m * (dh[i] + 0.375f);")]
# Every f32 shape to the cooperative kernels, in the copies timed as that
# design.
COOP_FORCE = [
    ("  return f32_flag_plan(B, H, ndir, bf16, sms, way);\n}",
     "  return {0, 1};\n}")]

# --- the flag design ---------------------------------------------------------
FLAG_EXCHANGE = [
    ("wait_flags(flags, ds, nb, s);", ""),
    ("stage_f32(xs, hx_src, nb, U * Bp / 4, U * Bp);", ""),
    ("stage_f32(xs, px_src, nb * Bp, U / 4, H);", ""),
]
FLAG_PRODUCT = [
    ("// forward product\n        if (i >= nl) break;",
     "// forward product\n        if (i >= 0) break;"),
    ("for (int cl = 0; cl < C; ++cl) {  // backward product",
     "for (int cl = 0; cl < 0; ++cl) {  // backward product"),
]
FLAG_RELAXED = [
    ("st.release.gpu.global.u32", "st.relaxed.gpu.global.u32"),
]
FLAG_CELL_LOADS = [
    ("    if (!cell) return;\n    const int t = rev ? nt - 1 - s : s;\n"
     "    const float* xr",
     "    return;\n    const int t = rev ? nt - 1 - s : s;\n"
     "    const float* xr"),
    ("    if (!cell) return;\n    const int t = rev ? s : nt - 1 - s, "
     "tp = rev ? t + 1 : t - 1;\n    const size_t row = (size_t)t * B + r0 + "
     "b;\n    float* sg",
     "    return;\n    const int t = rev ? s : nt - 1 - s, "
     "tp = rev ? t + 1 : t - 1;\n    const size_t row = (size_t)t * B + r0 + "
     "b;\n    float* sg"),
    ("const float4 xv = xslot_at(p, tid);",
     "const float4 xv = make_float4(0.25f, 0.375f, 0.5f, 0.625f);"),
    ("const float4 gv = gslot(p, tid);\n"
     "      const float3 cv = cslot(p, tid);",
     "const float4 gv = make_float4(0.5f, 0.5f, 0.25f, 0.5f);\n"
     "      const float3 cv = make_float3(0.125f, 0.0625f, 0.375f);"),
]
FLAG_LAST_WARP = [
    ("  if (threadIdx.x == 0) st_release(flag, v);",
     "  if (threadIdx.x == kThreads - 1) st_release(flag, v);"),
]
FLAG_PLANS = ("constexpr int kFPlans[2][3][2] = {{{8, 2}, {4, 1}, {8, 1}},\n"
              "                                  {{8, 2}, {8, 1}, {4, 1}}};")
# Copies of the source with another plan, and the plan the package's
# wrapper must then hold the launcher to (kernels/lstm_scan.py FLAG_PLANS).
PLANS = {
    "one row slice": {"fwd": ((4, 1), (8, 1), (8, 1)),
                      "bwd": ((8, 1), (4, 1), (4, 1))},
    "U=8": dict.fromkeys(("fwd", "bwd"), ((8, 1),) * 3),
    "U=4": dict.fromkeys(("fwd", "bwd"), ((4, 1),) * 3)}


def _plans_source(plans):
    rows = ["{" + ", ".join(f"{{{u}, {rs}}}" for u, rs in plans[way]) + "}"
            for way in ("fwd", "bwd")]
    return ("constexpr int kFPlans[2][3][2] = {" + rows[0] + ",\n"
            "                                  " + rows[1] + "};")

DESIGNS = {
    "cooperative": ("lstm_{way}_kernel", COOP_FORCE, {
        "full": [], "no staging": COOP_STAGING, "no product": COOP_PRODUCT,
        "no barrier": COOP_BARRIER, "no cell loads": COOP_CELL_LOADS,
        "staging 40 KB": COOP_STAGING_40K}),
    "flag": ("lstm_{way}_flag_kernel", [], {
        "full": [], "no exchange": FLAG_EXCHANGE, "no product": FLAG_PRODUCT,
        "relaxed flag": FLAG_RELAXED, "no cell loads": FLAG_CELL_LOADS,
        "last warp's flag": FLAG_LAST_WARP,
        **{name: [(FLAG_PLANS, _plans_source(plans))]
           for name, plans in PLANS.items()}}),
}


def build(name, patches, force):
    """lstm_scan.cu with ``force`` and ``patches`` applied, built, loaded
    and bound as the package binds its own build."""
    with open(join(_build.SRC_DIR, "lstm_scan.cu")) as f:
        src = f.read()
    for old, new in list(force) + list(patches):
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer reads "
                               f"{old[:70]!r}")
        src = src.replace(old, new)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = join(_build.BUILD_DIR, f"lstm_scan-parts-{tag}.cu")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           cu[:-3] + ".so", cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return name, L._bind(ctypes.CDLL(cu[:-3] + ".so"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--design", choices=sorted(DESIGNS),
                    default="cooperative")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--step-tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool times the card")
    if args.step_tree:
        return step_with_tree(args.step_tree)
    if args.shapes:
        return compare_shapes(args)
    kernel, force, variants = DESIGNS[args.design]
    card = card_line()
    with ThreadPoolExecutor() as pool:
        libs = dict(pool.map(lambda kv: build(kv[0], kv[1], force),
                             variants.items()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32 = torch.float32
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    rows = {}
    package_lib, package_plans = L._lib, L.FLAG_PLANS
    try:
        for reverse in ((False,), (False, True)):
            nd = len(reverse)
            xp = torch.randn((T, B, nd * 4 * H), generator=gen,
                             device=dev) * 0.5
            whh = (torch.rand((nd, H, 4 * H), generator=gen, device=dev)
                   * 2 - 1) / H ** 0.5
            bias = (torch.rand((nd, 4 * H), generator=gen, device=dev)
                    * 2 - 1) / H ** 0.5
            gy = torch.randn((T, B, nd * H), generator=gen, device=dev)
            _, c, g4 = L.lstm_fwd_scan_plain(xp, whh, bias, lengths,
                                             reverse)
            for name, lib in libs.items():
                L._lib = lambda lib=lib: lib  # noqa: E731
                # the wrapper holds its plan to the launcher's
                L.FLAG_PLANS = PLANS.get(name, package_plans)
                took = (L.fwd_design(B, H, f32, nd),
                        L.bwd_design(B, H, f32, nd))
                fwd = time_ms(lambda: L.lstm_fwd_scan(xp, whh, bias, lengths,
                                                      reverse), args.reps)
                bwd = time_ms(lambda: L.lstm_bwd_scan(whh, lengths, c, g4,
                                                      gy, reverse),
                              args.reps)
                rows[f"{nd} {name}"] = dict(directions=nd, part=name,
                                            design=took, fwd_ms=fwd,
                                            bwd_ms=bwd)
                print(f"{kernel.format(way='{fwd,bwd}')} {nd} direction(s) "
                      f"{name:14s} ({took[0]}/{took[1]}): forward {fwd:.4f} "
                      f"ms ({fwd * 1e3 / T:.3f} us a step), backward "
                      f"{bwd:.4f} ms ({bwd * 1e3 / T:.3f} us a step)  "
                      f"[{card}]", flush=True)
    finally:
        L._lib, L.FLAG_PLANS = package_lib, package_plans
    for nd in (1, 2):
        full = rows[f"{nd} full"]
        print(f"{nd} direction(s), us a step off the full step:  " + "  ".join(
            f"{r['part']}: fwd {(full['fwd_ms'] - r['fwd_ms']) * 1e3 / T:+.3f}"
            f" bwd {(full['bwd_ms'] - r['bwd_ms']) * 1e3 / T:+.3f}"
            for k, r in rows.items() if r["directions"] == nd
            and r["part"] != "full") + f"  [{card}]")
    print(card)
    if args.out:
        os.makedirs(dirname(abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, design=args.design,
                           rows=list(rows.values())), f, indent=1)


def compare_shapes(args):
    """The flag design against the cooperative kernels (this tree's copy
    with COOP_FORCE, the parent's design) at every f32 shape phase 3 times,
    chip_smoke.F32_LSTM_TIMED, in turns: cooperative, flag, flag,
    cooperative."""
    from chip_smoke import F32_LSTM_TIMED, vc_lstm_shape

    card = card_line()
    with ThreadPoolExecutor() as pool:
        libs = dict(pool.map(lambda kv: build(*kv), (
            ("flag", [], []), ("cooperative", [], COOP_FORCE))))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    package_lib = L._lib
    try:
        for label, reverse in F32_LSTM_TIMED:
            Tn, lens = vc_lstm_shape(label, dev)
            Bn, nd = len(lens), len(reverse)
            xp = torch.randn((Tn, Bn, nd * 4 * H), generator=gen,
                             device=dev) * 0.5
            whh = (torch.rand((nd, H, 4 * H), generator=gen, device=dev)
                   * 2 - 1) / H ** 0.5
            bias = (torch.rand((nd, 4 * H), generator=gen, device=dev)
                    * 2 - 1) / H ** 0.5
            gy = torch.randn((Tn, Bn, nd * H), generator=gen, device=dev)
            _, c, g4 = L.lstm_fwd_scan_plain(xp, whh, bias, lens, reverse)
            t = {}
            for name in ("cooperative", "flag", "flag", "cooperative"):
                L._lib = lambda lib=libs[name]: lib  # noqa: E731
                took = L.fwd_design(Bn, H, torch.float32, nd)
                if took != name:
                    raise SystemExit(f"{label}: the {name} build takes "
                                     f"{took}")
                t.setdefault(name, []).append((
                    time_ms(lambda: L.lstm_fwd_scan(xp, whh, bias, lens,
                                                    reverse), args.reps),
                    time_ms(lambda: L.lstm_bwd_scan(whh, lens, c, g4, gy,
                                                    reverse), args.reps)))
            row = dict(shape=label, B=Bn, T=Tn, directions=nd, **{
                f"{name}_{way}_ms": sum(v[i] for v in t[name]) / 2
                for name in t for i, way in enumerate(("fwd", "bwd"))})
            rows.append(row)
            print(f"{label} B={Bn} T={Tn} {nd} direction(s): forward flag "
                  f"{row['flag_fwd_ms']:.4f} ms, cooperative "
                  f"{row['cooperative_fwd_ms']:.4f} ms; backward flag "
                  f"{row['flag_bwd_ms']:.4f} ms, cooperative "
                  f"{row['cooperative_bwd_ms']:.4f} ms  [{card}]", flush=True)
    finally:
        L._lib = package_lib
    print(card)
    if args.out:
        os.makedirs(dirname(abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)


STEP = """
import sys
sys.path.insert(0, {tree!r})
import torch, gantts_tpu_torch
sys.path.insert(0, {root!r})
import chip_smoke as cs  # this tree's script; the package stays the other's
print("[4h] gantts_tpu_torch from", gantts_tpu_torch.__file__, flush=True)
dev, card = torch.device("cuda", 0), cs.card_line()
gen = torch.Generator(device=dev)
gen.manual_seed(3)
cs.time_cudnn_lstm(dev, card, gen, cs.vc_lstm_shape("vc", dev)[1], (False,),
                   D=cs.VC_DIM, dt=torch.float32, breakdown=True)
path = next(p for p in cs.main_paths() if p[0] == "4h")
cs.run_path(dev, card, *path, require_design=False)
"""


def step_with_tree(tree):
    """chip_smoke.py's f32 one-direction LSTM layer beside cuDNN's at
    D=177 with its breakdown by kernel, and its phase 4h (the steps, their
    launches and the trace), both from this tree's script, run on another
    checkout's gantts_tpu_torch in a process of its own."""
    subprocess.run([sys.executable, "-c", STEP.format(
        tree=abspath(tree), root=ROOT)], check=True)


if __name__ == "__main__":
    main()
