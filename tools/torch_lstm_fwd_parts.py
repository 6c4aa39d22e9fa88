#!/usr/bin/env python3
"""Where a step of the port's LSTM forward cluster kernel goes, on one
NVIDIA GPU.

Builds ``gantts_tpu_torch/kernels/csrc/lstm_scan.cu`` as it is and copies
with parts of ``lstm_fwd_cluster_kernel``'s step taken out, then
times each at the training step's shape (T=512, B=20, H=512, bf16, both
directions) with CUDA events:

  full           the kernel as it is;
  no exchange    no block waits for or sends h slices (the product reads
                 whatever its receive slots hold);
  no product     no wgmma (the partial sums are zeros);
  neither        both taken out: the cell, the block barriers, the loads
                 and stores;
  no cell math   the gates and carries without sigmoid or tanh;
  no stores      y, c and g4 not stored;
  no barriers    neither of the step's two block barriers.

Each difference from ``full`` bounds what that part adds to the serial
chain, e.g. T x (full - no exchange) is the time the exchange adds.  The
copies compute wrong values; only their times mean anything.  Run from the
root of the repository:

    python3 tools/torch_lstm_fwd_parts.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from os.path import abspath, dirname, join

import torch

ROOT = dirname(dirname(abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, time_ms  # noqa: E402
from gantts_tpu_torch.kernels._build import (  # noqa: E402
    BUILD_DIR,
    NVCC_FLAGS,
    SRC_DIR,
    find_nvcc,
)

T, B, H = 512, 20, 512
# (text of the forward cluster kernel, what replaces it) per part
EXCHANGE = [
    ("      mbar_wait(bar, ((s - 1) >> 1) & 1);\n"
     "      // Re-armed for h_{s+1}.", "      // Re-armed for h_{s+1}."),
    ("      if (tid == 0) mbar_expect_tx(bar, kCBlocks * slice_bytes);\n"
     "      const uint32_t hs", "      const uint32_t hs"),
    ("    if (lane == 0) {  // warp w sends it to block w",
     "    if (false) {  // warp w sends it to block w"),
]
PRODUCT = [
    ("      for (int ks = 0; ks < S::KSteps; ++ks) {\n"
     "        const int k = kbase + ks * 16;",
     "      for (int ks = 0; ks < 0; ++ks) {\n"
     "        const int k = kbase + ks * 16;"),
]
CELL = [
    ("        const float ig = fast_sigmoid(pre[0][e]);\n"
     "        const float fg = fast_sigmoid(pre[1][e]);\n"
     "        const float gg = fast_tanh(pre[2][e]), og = fast_sigmoid(pre[3][e]);\n"
     "        const float c_new = fg * cc[e] + ig * gg;\n"
     "        const float h_new = og * fast_tanh(c_new);",
     "        const float ig = pre[0][e], fg = pre[1][e];\n"
     "        const float gg = pre[2][e], og = pre[3][e];\n"
     "        const float c_new = fg * cc[e] + ig * gg;\n"
     "        const float h_new = og * c_new;"),
]
STORES = [
    ("      const size_t row = (size_t)t * B + b;\n"
     "      const size_t o = row * Y + (size_t)d * H + j;",
     "      if (t < 0) {\n"
     "      const size_t row = (size_t)t * B + b;\n"
     "      const size_t o = row * Y + (size_t)d * H + j;"),
    ("            __floats2bfloat162_rn(act[q][0], act[q][1]);\n"
     "      // the carried h",
     "            __floats2bfloat162_rn(act[q][0], act[q][1]);\n"
     "      }\n"
     "      // the carried h"),
]
BARRIERS = [
    ("    __syncthreads();  // the partial sums are in; the send slice is free",
     ""),
    ("    __syncthreads();  // h_s is in the send slice", ""),
]
VARIANTS = {"full": [], "no exchange": EXCHANGE, "no product": PRODUCT,
            "neither": EXCHANGE + PRODUCT, "no cell math": CELL,
            "no stores": STORES, "no barriers": BARRIERS}


def build(name, patches):
    with open(join(SRC_DIR, "lstm_scan.cu")) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel no longer reads {old!r}")
        src = src.replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = join(BUILD_DIR, "parts_" + name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(stem + ".so")
    lib.lstm_fwd_scan.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    return name, lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor() as pool:
        libs = dict(pool.map(lambda kv: build(*kv), VARIANTS.items()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xp = (torch.randn((T, B, 8 * H), generator=gen, device=dev)
          * 0.5).bfloat16()
    whh = ((torch.rand((2, H, 4 * H), generator=gen, device=dev) * 2 - 1)
           / H ** 0.5).bfloat16()
    bias = (torch.rand((2, 4 * H), generator=gen, device=dev) * 2 - 1) \
        / H ** 0.5
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    y = torch.empty((T, B, 2 * H), dtype=torch.bfloat16, device=dev)
    c = torch.empty((T, B, 2 * H), device=dev)
    g4 = torch.empty((T, B, 8 * H), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for name, lib in libs.items():
        def launch():
            code = lib.lstm_fwd_scan(
                xp.data_ptr(), whh.data_ptr(), bias.data_ptr(),
                lengths.data_ptr(), y.data_ptr(), c.data_ptr(),
                g4.data_ptr(), None, None, T, B, H, 2, 2, 1, stream)
            if code != 0:
                raise RuntimeError(f"{name}: launch failed ({code})")
        times[name] = time_ms(launch, 10)
    card = card_line()
    for name, ms in times.items():
        print(f"lstm_fwd_cluster_kernel {name:12s} {ms:.4f} ms, "
              f"{ms * 1e3 / T:.3f} us a step  [{card}]")

    def saved(name):
        return (times["full"] - times[name]) * 1e3 / T
    print(f"on the chain, a step: exchange {saved('no exchange'):.3f} us, "
          f"product {saved('no product'):.3f} us, the rest "
          f"{times['neither'] * 1e3 / T:.3f} us; of the whole step, cell "
          f"math {saved('no cell math'):.3f} us, stores "
          f"{saved('no stores'):.3f} us, block barriers "
          f"{saved('no barriers'):.3f} us  [{card}]")


if __name__ == "__main__":
    main()
