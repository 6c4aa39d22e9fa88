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
JAX_PACKAGE = join(REPO, "gantts_tpu")
MODULES = sorted(
    "gantts_tpu_torch" + "".join(
        "." + p for p in os.path.relpath(join(root, f), PORT)
        .removesuffix(".py").removesuffix("__init__").strip(os.sep)
        .split(os.sep) if p)
    for root, _, files in os.walk(PORT) for f in files if f.endswith(".py"))


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    """A fresh interpreter that imports every module of the port (and uses
    its host code) has neither jax nor gantts_tpu loaded, and no loaded
    module's file lies under gantts_tpu/."""
    assert "gantts_tpu_torch.train.__main__" in MODULES
    assert "gantts_tpu_torch.kernels.linear_scan" in MODULES
    assert "gantts_tpu_torch.curriculum" in MODULES
    assert {"gantts_tpu_torch.core.fast_mlpg", "gantts_tpu_torch.synthesis",
            "gantts_tpu_torch.evaluation_vc",
            "gantts_tpu_torch.frontend.native",
            "gantts_tpu_torch.frontend.world",
            "gantts_tpu_torch.frontend.sptk",
            "gantts_tpu_torch.utils.analysis", "gantts_tpu_torch.io.hts",
            "gantts_tpu_torch.io.merlin", "gantts_tpu_torch.postfilters",
            "gantts_tpu_torch.preprocessing.alignment",
            "gantts_tpu_torch.evaluation_tts",
            "gantts_tpu_torch.prepare_features_tts",
            "gantts_tpu_torch.prepare_features_vc"} <= set(MODULES)
    proc = _run(
        "import importlib, os, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from gantts_tpu_torch import hparams\n"
        "from gantts_tpu_torch.core.windows import "
        "unit_variance_mlpg_matrix\n"
        "unit_variance_mlpg_matrix(hparams.tts_acoustic.windows, 16)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'gantts_tpu'))\n"
        f"jax_dir = {JAX_PACKAGE!r} + os.sep\n"
        "bad += sorted(m.__name__ for m in list(sys.modules.values())\n"
        "              if os.path.abspath(getattr(m, '__file__', None) or '')"
        ".startswith(jax_dir))\n"
        "print(bad)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_kernel_modules_import_without_cuda():
    """Importing the kernel modules builds nothing and loads no library:
    nvcc is reached only when a CUDA tensor reaches a wrapper."""
    proc = _run(
        "from gantts_tpu_torch.kernels import _build, linear_scan, "
        "lstm_scan, sru_scan\n"
        "print(_build.build_log, sru_scan._lib.cache_info().currsize,\n"
        "      lstm_scan._lib.cache_info().currsize,\n"
        "      linear_scan._lib.cache_info().currsize)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "{} 0 0 0", proc.stdout


def test_native_loader_reads_nothing_under_the_jax_package():
    """The port's loader of the C++ host engine compiles the repository's
    cpp/frontend.cpp into the port's own build directory: neither its source
    nor its library lies under gantts_tpu/, nor under cpp/build/, where the
    JAX package's loader builds.  Importing it builds nothing."""
    proc = _run(
        "from gantts_tpu_torch.frontend import native\n"
        "print(native._SOURCE)\n"
        "print(native._BUILD_DIR)\n"
        "print(native._lib, native._engine)\n")
    assert proc.returncode == 0, proc.stderr
    source, build, state = proc.stdout.strip().splitlines()
    assert source == join(REPO, "cpp", "frontend.cpp")
    assert build == join(PORT, "frontend", "build")
    assert state == "None None"
    for path in (source, build):
        assert not path.startswith(JAX_PACKAGE + os.sep), path
        assert not path.startswith(join(REPO, "cpp", "build")), path


def test_port_sources_name_no_jax():
    """No source file of the port, nor chip_smoke.py, imports jax or the JAX
    package, or names a path under gantts_tpu/ in a string, or loads a
    module by file path.  Docstrings and comments name their counterparts
    as gantts_tpu/<file>, and chip_smoke.py's kernel records name the TPU
    kernel each replaces as "gantts_tpu/<file>:<line>": neither is a path
    that code could open."""
    imports = re.compile(r"^\s*(import jax|from jax|import gantts_tpu\b"
                         r"|from gantts_tpu[ .])|spec_from_file_location",
                         re.M)
    paths = re.compile(r"""["']gantts_tpu(/[\w./-]*)?["']""")
    sources = [join(root, f) for root, _, files in os.walk(PORT)
               for f in files if f.endswith((".py", ".cu"))]
    sources.append(join(REPO, "chip_smoke.py"))
    found = []
    for src in sources:
        with open(src) as fh:
            text = fh.read()
        if imports.search(text) or paths.search(text):
            found.append(src)
    assert found == []
    assert paths.search('join(REPO, "gantts_tpu", "hparams.py")')
    assert paths.search("open('gantts_tpu/core/windows.py')")
    assert not paths.search('"replaces": "gantts_tpu/kernels/x.py:85"')
    assert not paths.search('"gantts_tpu_torch/kernels/csrc/x.cu"')


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

    from gantts_tpu_torch.kernels import lstm_scan as L

    whh, lstm_bias = torch.randn(2, H, 4 * H), torch.zeros(2, 4 * H)
    y, c, g4 = L.lstm_fwd_scan(torch.randn(T, B, 8 * H), whh, lstm_bias,
                               lengths, (False, True))
    dxp, db = L.lstm_bwd_scan(whh, lengths, c, g4, torch.ones_like(y),
                              (False, True))
    assert dxp.shape == g4.shape and db.shape == (2, 4 * H)
    assert all(n == 0 for n in K.launch_counts.values())
    with pytest.raises(ValueError, match="expected"):
        L.lstm_fwd_scan(torch.empty(T, B, 8 * H, device="meta"),
                        whh.to("meta"), lstm_bias.to("meta"),
                        lengths.to("meta"), (False, True))

    meta = torch.empty(T, B, 4 * H, device="meta")
    with pytest.raises(ValueError, match="expected"):
        K.sru_fwd_scan(meta, bias4, lengths, False, 1)
    with pytest.raises(ValueError, match="expected"):
        K.sru_proj_gemm(torch.empty(4, 6, device="meta"),
                        torch.empty(6, 8, device="meta"))
