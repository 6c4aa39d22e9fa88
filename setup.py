"""Packaging for the gantts_tpu framework (reference setup.py parity:
the installable package is the model/loss/feature library plus, here, the
full TPU training/inference stack and the C++ host library sources).

Version contract follows the reference (setup.py:9-36): release versions
come from the static string below; non-release builds append the current
git commit id, and the resolved version is written to
``gantts_tpu/version.py`` at build time so the installed package can
report exactly what it was built from.
"""

import os
import subprocess

from setuptools import find_packages, setup

VERSION = "0.1.0"
HERE = os.path.dirname(os.path.abspath(__file__))


def _git_sha():
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=HERE,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


version = VERSION
if not os.environ.get("GANTTS_TPU_RELEASE"):  # release.sh sets this
    sha = _git_sha()
    if sha:
        version = f"{VERSION}+git.{sha}"

with open(os.path.join(HERE, "gantts_tpu", "version.py"), "w") as f:
    f.write(f'version = "{version}"\n')

setup(
    name="gantts_tpu",
    version=version,
    description=(
        "TPU-native (JAX/XLA/Pallas) GAN-based speech synthesis and "
        "voice conversion framework"),
    packages=find_packages(include=["gantts_tpu", "gantts_tpu.*",
                                    "gantts_tpu_torch", "gantts_tpu_torch.*"]),
    package_data={"gantts_tpu": ["../cpp/*.cpp", "../cpp/CMakeLists.txt"],
                  "gantts_tpu_torch.kernels": ["csrc/*.cu"]},
    install_requires=[
        "numpy",
        "scipy",
        "jax",
        "flax",
        "optax",
        "scikit-learn",
    ],
    extras_require={
        "train": ["tqdm", "tensorboard"],
        "test": ["pytest"],
    },
    python_requires=">=3.10",
)
