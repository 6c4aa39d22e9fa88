"""Host code shared with the JAX package, loaded without JAX.

``gantts_tpu/hparams.py`` (numpy only) and ``gantts_tpu/core/windows.py``
(numpy and scipy) are loaded by file path, so the port uses the very same
bundles, ``HParams`` parsing, window math and MLPG matrix without copying
them and without running ``gantts_tpu/__init__.py``, which imports JAX.

``windows._solveh_banded`` reaches the C++ solver through
``gantts_tpu.frontend``, whose package import would load JAX; the loaded
copy here solves with scipy's banded Cholesky, the fallback that function
already has.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from os.path import dirname, join

import scipy.linalg

_JAX_PACKAGE = join(dirname(dirname(os.path.abspath(__file__))), "gantts_tpu")


def _load(relpath, name):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, join(_JAX_PACKAGE, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _solveh_banded(ab, rhs):
    return scipy.linalg.solveh_banded(ab, rhs, lower=False)


hparams = _load("hparams.py", "gantts_tpu_torch._shared_hparams")
windows = _load(join("core", "windows.py"), "gantts_tpu_torch._shared_windows")
windows._solveh_banded = _solveh_banded

unit_variance_mlpg_matrix = windows.unit_variance_mlpg_matrix
delta_features = windows.delta_features
