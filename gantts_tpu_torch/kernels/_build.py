"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so``, then
loaded with ``ctypes``.  The hash covers the source and the compiler flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing here runs
at import time: the CPU tests import every kernel module without a toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from os.path import dirname, exists, join

SRC_DIR = join(dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = join(dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (seconds spent building, compiler log); empty until a build runs
build_log: dict[str, tuple[float, str]] = {}


def find_nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and exists(join(cand, "bin", "nvcc")):
            return join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of gantts_tpu_torch are built from source at first use")
    return nvcc


@functools.lru_cache(maxsize=None)
def load_library(name):
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    src = join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        build_log[name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    return ctypes.CDLL(so)
