#!/usr/bin/env python3
"""The port's f32 ``sru_proj_gemm`` against another tree's, on one NVIDIA GPU.

Builds ``gantts_tpu_torch/kernels/csrc/sru_scan.cu`` as it is and, with
``--parent DIR``, the same file from another checkout of the repository
(the same compiler flags), checks both against the plain version at every
shape of ``chip_smoke.F32_GEMM_SHAPES`` (and this tree's kernel for
identical bits over two launches), and times them in turns (parent,
change, change, parent) beside ``torch.mm`` (f32, TF32 off) and the bound
at 67 TFLOP/s.  The parent is called through its own C entry point, which
since the port's first kernels takes (x, w, u, M, N, K, ldx, bf16, stream);
this tree's through its wrapper, so its time includes the split-K
workspace and the split sum.  ``--sweep``
also times this tree's kernel at other tiles (and, at M <= 3072, split
counts): the plan's alternatives.  ``--variants`` builds copies of this
tree's source with other pipeline constants (VARIANTS, patched by exact
text: a patch that no longer matches raises) and times each at
every tile at the shapes with M > 3072.  Prints the card's name and
power limit, the compiler's register report and each GEMM's SASS counts
(and what breaks phase 2's rules, without stopping);
``--out FILE`` writes the numbers as JSON.  Run from the root of the
repository:

    python3 tools/torch_gemm_f32_ab.py [--parent DIR] [--sweep] [--variants]
        [--out FILE]
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
from os.path import abspath, dirname, exists, join

import torch

ROOT = dirname(dirname(abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    F32_GEMM_SHAPES,
    TOL,
    card_line,
    record,
    rel_err,
    sass_counts,
    sass_problems,
    time_ms,
)
from gantts_tpu_torch.kernels import _build  # noqa: E402
from gantts_tpu_torch.kernels import sru_scan as K  # noqa: E402

# the kernel's tiles, (tile_m, tile_n)
TILES = sorted(K.F32_TILES)
# (tile, splits): small M every tile at every split count; large M every
# tile unsplit
SWEEP_SMALL = [(t, z) for t in TILES for z in (1, 2, 3, 4, 6, 8, 12, 16)]
SWEEP_LARGE = [(t, 1) for t in TILES]
# name -> patches of sru_scan.cu: other k depths and stage counts
PIPELINE = "constexpr int kFBK = 32, kFStages = 3;"
VARIANTS = {f"{k} k a stage, {n} stages": [
    (PIPELINE, f"constexpr int kFBK = {k}, kFStages = {n};")]
    for k, n in ((16, 4), (32, 2), (32, 4), (64, 2))}


def build_parent(parent):
    """The other tree's sru_scan.cu, built with this tree's flags."""
    src = join(parent, "gantts_tpu_torch", "kernels", "csrc", "sru_scan.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
    so = join(_build.BUILD_DIR, f"libsru_scan-parent-{digest}.so")
    if not exists(so):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                               so, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sru_proj_gemm.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.sru_proj_gemm.restype = I
    return lib


def build_variant(name, patches):
    """This tree's sru_scan.cu with ``patches`` applied, built and loaded."""
    with open(join(_build.SRC_DIR, "sru_scan.cu")) as f:
        src = f.read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: the source no longer "
                               f"holds {old[:60]!r}")
        src = src.replace(old, new)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = join(_build.BUILD_DIR, f"sru_scan-variant-{tag}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n"
                           f"{proc.stderr}")
    spills = [ln.strip() for ln in proc.stdout.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    lib = ctypes.CDLL(so)
    lib.sru_proj_gemm_f32.argtypes = K._lib().sru_proj_gemm_f32.argtypes
    lib.sru_proj_gemm_f32.restype = ctypes.c_int
    return lib, spills


def parent_gemm(lib, x2, w):
    M, Kd = x2.shape
    u = torch.empty((M, w.shape[1]), dtype=torch.float32, device=x2.device)
    code = lib.sru_proj_gemm(x2.data_ptr(), w.data_ptr(), u.data_ptr(), M,
                             w.shape[1], Kd, Kd, 0,
                             torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the parent's sru_proj_gemm failed ({code})")
    return u


def planned_gemm(x2, w, tile, splits, lib=None):
    """This tree's kernel (or a variant's) at a given tile and split count
    (the plan's k steps evened out as _f32_gemm_plan does)."""
    M, Kd = x2.shape
    N = w.shape[1]
    nk = -(-Kd // K.F32_TILE_K)
    k_steps = -(-nk // splits)
    splits = -(-nk // k_steps)
    if splits == 1:
        k_steps = Kd  # covers K at any k depth a stage (the variants')
    u = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    ws = torch.empty(splits * M * N if splits > 1 else 1,
                     dtype=torch.float32, device=x2.device)
    code = (lib or K._lib()).sru_proj_gemm_f32(
        x2.data_ptr(), w.data_ptr(), u.data_ptr(), ws.data_ptr(), M, N, Kd,
        x2.stride(0), *tile, splits, k_steps,
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"sru_proj_gemm_f32 failed ({code})")
    return u, splits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool times the card")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: torch.mm is no f32 yardstick")
    card = card_line()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor() as pool:
        lib_f = pool.submit(K._lib)
        parent_f = pool.submit(build_parent, args.parent) if args.parent \
            else None
        variant_f = {n: pool.submit(build_variant, n, p)
                     for n, p in VARIANTS.items()} if args.variants else {}
        lib = lib_f.result()
        parent = parent_f.result() if parent_f else None
        variants = {n: f.result() for n, f in variant_f.items()}
    for name, (_, spills) in variants.items():
        print(f"  variant {name}: spills {spills or 'none'}")
    for line in _build.build_log.get("sru_scan", (0, ""))[1].splitlines():
        if "proj_gemm_f32" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    tool = os.path.join(dirname(_build.find_nvcc()), "cuobjdump")
    counts = sass_counts(subprocess.run([tool, "-sass", lib._name],
                                        capture_output=True, text=True,
                                        check=True).stdout)
    for name, c in counts.items():
        print(f"  SASS of {name}: {c}")
    for problem in sass_problems(counts):
        print(f"  SASS PROBLEM: {problem}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for path, M, D, N in F32_GEMM_SHAPES:
        x2 = torch.randn((M, D), generator=gen, device=dev)
        w = (torch.rand((D, N), generator=gen, device=dev) * 2 - 1) / 512**.5
        ref = K.sru_proj_gemm_plain(x2, w)
        u = K.sru_proj_gemm(x2, w)
        err = rel_err(u, ref)[0]
        same = torch.equal(u, K.sru_proj_gemm(x2, w))
        if not (err <= TOL[torch.float32] and same):
            raise SystemExit(f"M={M} K={D} N={N}: error {err:.3e}, "
                             f"bit-identical {same}")
        new = lambda: K.sru_proj_gemm(x2, w)  # noqa: E731
        row = dict(path=path, M=M, K=D, N=N, rel_err=err)
        if parent is not None:
            old = lambda: parent_gemm(parent, x2, w)  # noqa: E731
            row["parent_rel_err"] = rel_err(old(), ref)[0]
            t = [time_ms(f, args.reps) for f in (old, new, new, old)]
            row["parent_ms"], row["ms"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            row["turns_ms"] = t
        else:
            row["ms"] = time_ms(new, args.reps)
        rec = record(row["ms"], None, 4 * (M * D + D * N + M * N),
                     2 * M * D * N, torch.float32,
                     time_ms(lambda: torch.mm(x2, w), args.reps))
        row.update(library_ms=rec["library_ms"], bound_ms=rec["bound_ms"],
                   bound_by=rec["bound_by"],
                   tflops=2 * M * D * N / row["ms"] / 1e9)
        line = (f"{path:22s} M={M:5d} K={D:4d} N={N}: new {row['ms']:.4f} "
                f"ms ({row['tflops']:.1f} TFLOP/s, {err:.2e})")
        if parent is not None:
            line += (f"  parent {row['parent_ms']:.4f} ms "
                     f"({row['parent_ms'] / row['ms']:.2f}x the new)")
        line += (f"  torch.mm {row['library_ms']:.4f} ms (new "
                 f"{row['ms'] / row['library_ms']:.2f}x)  bound "
                 f"{row['bound_ms']:.4f} ms")
        print(line, flush=True)
        if args.sweep:
            row["sweep"] = {}
            for tile, splits in (SWEEP_SMALL if M <= 3072
                                 else SWEEP_LARGE):
                key = "{}x{}".format(*tile)
                u, used = planned_gemm(x2, w, tile, splits)
                if rel_err(u, ref)[0] > TOL[torch.float32]:
                    raise SystemExit(f"sweep {key}/{splits} disagrees")
                ms = time_ms(lambda: planned_gemm(x2, w, tile, splits),
                             args.reps)
                row["sweep"][f"{key}/{used}"] = ms
            print("    sweep (tile_m x tile_n / splits: ms) " +
                  "  ".join(
                f"{k} {v:.4f}" for k, v in row["sweep"].items()), flush=True)
        if variants and M > 3072:
            row["variants"] = {}
            for name, (vlib, _) in variants.items():
                for tile in TILES:
                    key = "{}x{}".format(*tile)
                    u, _ = planned_gemm(x2, w, tile, 1, vlib)
                    if rel_err(u, ref)[0] > TOL[torch.float32]:
                        raise SystemExit(f"variant {name} {key} disagrees")
                    row["variants"][f"{name} {key}"] = time_ms(
                        lambda: planned_gemm(x2, w, tile, 1, vlib),
                        args.reps)
            print("    variants (ms): " + "  ".join(
                f"{k} {v:.4f}" for k, v in row["variants"].items()),
                flush=True)
        rows.append(row)
    print(card)
    if args.out:
        os.makedirs(dirname(abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
