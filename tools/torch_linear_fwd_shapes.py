#!/usr/bin/env python3
"""The port's time-chunked ``linear_recurrence_fwd`` at other chunk lengths,
block sizes, windows and memory hints, on one NVIDIA GPU.

Builds ``gantts_tpu_torch/kernels/csrc/linear_scan.cu`` as it is and copies
of it with other values of its three shape constants (``kFwdChunk`` steps a
thread, ``kFwdThreads`` a block, ``kFwdMaxChunks`` chunks of a lane in one
window) and with plain loads and stores in place of the streaming ones
(``__ldcs``, ``__stcs``), checks each against the plain version, and times
each with CUDA events at the k=3 layer's shape in the training step (T=512,
B=20, H=512, f32, the lengths of bench.py:103 with f = 1 and b = 0 on
padding, as in chip_smoke.py's phase 3c).  Prints each variant's time, its
share of the bound's rate, its registers, and its largest error against the
plain version.  It reproduces the shape study in the kernel's source note
and PERF.md, and patches the source by its exact text: it raises when the
kernel no longer holds a line it patches, and then must change with it.
Run from the root of the repository:

    python3 tools/torch_linear_fwd_shapes.py
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from os.path import abspath, dirname, join

import numpy as np
import torch

ROOT = dirname(dirname(abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    HBM_BPS,
    bench_lengths,
    card_line,
    rel_err,
    time_ms,
)
from gantts_tpu_torch.kernels._build import (  # noqa: E402
    BUILD_DIR,
    NVCC_FLAGS,
    SRC_DIR,
    find_nvcc,
)
from gantts_tpu_torch.kernels.linear_scan import (  # noqa: E402
    linear_recurrence_fwd_plain,
)

T, B, H = 512, 20, 512
LOADS = [("fv[i] = __ldcs(f + o);", "fv[i] = f[o];"),
         ("bv[i] = __ldcs(b + o);", "bv[i] = b[o];")]
STORES = [("__stcs(c + (size_t)(t0 + i) * ts + lane, cv);",
           "c[(size_t)(t0 + i) * ts + lane] = cv;")]
# name -> (kFwdChunk, kFwdThreads, kFwdMaxChunks, further patches)
VARIANTS = {
    "as built": (16, 512, 16, []),
    "plain loads": (16, 512, 16, LOADS),
    "plain stores": (16, 512, 16, STORES),
    "no hints": (16, 512, 16, LOADS + STORES),
    "32-step chunks, 256 threads": (32, 256, 16, []),
    "32-step chunks, 256 threads, no hints": (32, 256, 16, LOADS + STORES),
    "32 chunks a window": (16, 512, 32, []),
    "8 chunks a window": (16, 512, 8, []),
    "256 threads": (16, 256, 16, []),
    "1024 threads": (16, 1024, 16, []),
    "8-step chunks, 64 a window": (8, 512, 64, []),
}


def build(name, chunk, threads, max_chunks, patches):
    with open(join(SRC_DIR, "linear_scan.cu")) as f:
        src = f.read()
    for const, value in (("kFwdChunk", chunk), ("kFwdThreads", threads),
                         ("kFwdMaxChunks", max_chunks)):
        patches = patches + [(re.search(rf"constexpr int {const} = \d+;",
                                        src).group(0),
                              f"constexpr int {const} = {value};")]
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel no longer reads {old!r}")
        src = src.replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = join(BUILD_DIR, "linear_fwd_" + re.sub(r"\W+", "_", name))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs = re.findall(r"Function properties for \S*linear_recurrence_fwd"
                      r"[\s\S]*?Used (\d+) registers",
                      proc.stdout + proc.stderr)
    lib = ctypes.CDLL(stem + ".so")
    lib.linear_recurrence_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return name, (lib, regs[0] if regs else "?")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor() as pool:
        libs = dict(pool.map(lambda kv: build(kv[0], *kv[1]),
                             VARIANTS.items()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    lengths = torch.as_tensor(bench_lengths(np.random.RandomState(0)),
                              device=dev)
    m = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    m = m[..., None]
    f = torch.sigmoid(torch.randn((T, B, H), generator=gen, device=dev)) \
        * m + (1.0 - m)
    b = torch.randn((T, B, H), generator=gen, device=dev) * 0.5 * m
    ref = linear_recurrence_fwd_plain(f, b)
    c = torch.empty_like(f)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bound = 3 * f.numel() * 4 / HBM_BPS * 1e3
    card = card_line()
    for name, (lib, regs) in libs.items():
        def launch():
            code = lib.linear_recurrence_fwd(f.data_ptr(), b.data_ptr(),
                                             c.data_ptr(), T, B * H, stream)
            if code != 0:
                raise RuntimeError(f"{name}: launch failed ({code})")
        launch()
        err = rel_err(c, ref)[0]
        ms = time_ms(launch, 50)
        print(f"linear_recurrence_fwd {name:38s} {ms:.4f} ms "
              f"({bound / ms:.0%} of the bound's rate, bound {bound:.4f} "
              f"ms), {regs} registers, error {err:.2e} of scale  [{card}]")


if __name__ == "__main__":
    main()
