"""tools/torch_lstm_f32_parts.py on the CPU: every copy it builds patches
``csrc/lstm_scan.cu`` as it reads now.

The tool times the f32 LSTM kernels with parts of their step taken out, in
copies of the source patched by exact text, and raises on the card when a
patch no longer matches.  Here each patch of each variant is held to the
source without a card, so a change to the kernels that leaves a variant
behind shows before a chip run.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_lstm_f32_parts as P  # noqa: E402

from gantts_tpu_torch.kernels import _build  # noqa: E402

VARIANTS = [(design, name) for design, (_, _, variants) in P.DESIGNS.items()
            for name in variants]


def _source():
    with open(os.path.join(_build.SRC_DIR, "lstm_scan.cu")) as f:
        return f.read()


@pytest.mark.parametrize("design,name", VARIANTS)
def test_every_patch_matches_the_source(design, name):
    _, force, variants = P.DESIGNS[design]
    src = _source()
    for old, new in list(force) + list(variants[name]):
        assert old in src, (design, name, old)
        assert old != new


@pytest.mark.parametrize("name", ["one row slice", "U=8", "U=4"])
def test_the_plan_variants_are_the_wrapper_s(name):
    """A copy timed with another plan patches the launcher's table to the
    plan the tool then hands the package's wrapper, which holds the two to
    each other."""
    ((old, new),) = P.DESIGNS["flag"][2][name]
    assert old == P.FLAG_PLANS
    assert new == P._plans_source(P.PLANS[name]) != old
