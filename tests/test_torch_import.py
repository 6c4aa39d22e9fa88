"""The port imports without JAX and without a CUDA toolkit, and takes a
kernel's plain version only for CPU tensors."""

import os
import re
import subprocess
import sys
from os.path import dirname, join

import pytest
import torch

torch.set_num_threads(1)

REPO = dirname(dirname(os.path.abspath(__file__)))
PORT = join(REPO, "gantts_tpu_torch")
MODULES = [
    "gantts_tpu_torch",
    "gantts_tpu_torch._shared",
    "gantts_tpu_torch.convert",
    "gantts_tpu_torch.core",
    "gantts_tpu_torch.kernels",
    "gantts_tpu_torch.kernels._build",
    "gantts_tpu_torch.kernels.sru_scan",
    "gantts_tpu_torch.models",
    "gantts_tpu_torch.train",
    "gantts_tpu_torch.train.metrics",
    "gantts_tpu_torch.train.optim",
    "gantts_tpu_torch.train.setup",
    "gantts_tpu_torch.train.step",
]


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    """A fresh interpreter that imports every module of the port (and uses
    the shared host code) has neither jax nor gantts_tpu loaded."""
    proc = _run(
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from gantts_tpu_torch._shared import hparams, "
        "unit_variance_mlpg_matrix\n"
        "unit_variance_mlpg_matrix(hparams.tts_acoustic.windows, 16)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'gantts_tpu'))\n"
        "print(bad)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_kernel_modules_import_without_cuda():
    """Importing the kernel modules builds nothing and loads no library:
    nvcc is reached only when a CUDA tensor reaches a wrapper."""
    proc = _run(
        "from gantts_tpu_torch.kernels import _build, sru_scan\n"
        "print(_build.build_log, sru_scan._lib.cache_info().currsize)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "{} 0", proc.stdout


def test_port_sources_name_no_jax():
    """No source file of the port imports jax or the JAX package; only
    ``_shared`` names the JAX package's files, by path."""
    pat = re.compile(r"^\s*(import jax|from jax|import gantts_tpu\b"
                     r"|from gantts_tpu[ .])", re.M)
    found = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(join(root, f)) as fh:
                    if pat.search(fh.read()):
                        found.append(join(root, f))
    assert found == []


def test_wrappers_take_plain_versions_only_on_cpu():
    """CPU tensors go to the plain versions and launch nothing; a tensor on
    any other device goes to the kernel path, which refuses what it does not
    take instead of falling back."""
    from gantts_tpu_torch.kernels import sru_scan as K

    K.reset_launch_counts()
    T, B, H = 5, 2, 3
    u = torch.randn(T, B, 4 * H)
    bias4 = torch.zeros(4 * H)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    h, c = K.sru_fwd_scan(u, bias4, lengths, False, 1)
    du, db = K.sru_bwd_scan(u, bias4, lengths, c, torch.ones_like(h), False,
                            1)
    K.sru_proj_gemm(torch.randn(4, 6), torch.randn(6, 8))
    assert du.shape == u.shape and db.shape == (4 * H,)
    assert all(n == 0 for n in K.launch_counts.values())

    meta = torch.empty(T, B, 4 * H, device="meta")
    with pytest.raises(ValueError, match="expected"):
        K.sru_fwd_scan(meta, bias4, lengths, False, 1)
    with pytest.raises(ValueError, match="expected"):
        K.sru_proj_gemm(torch.empty(4, 6, device="meta"),
                        torch.empty(6, 8, device="meta"))
