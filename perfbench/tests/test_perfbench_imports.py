"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program it judges."""

import ast
import os
import sys
import types
from os.path import dirname, join

BENCH = dirname(dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gantts_tpu"}


def imported(path):
    """Top-level names of every module a file imports (compared whole:
    ``gantts_tpu_torch`` is not ``gantts_tpu``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield join(d, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {p: imported(p) & FORBIDDEN for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_the_reference_imports_nothing_of_the_program():
    found = {p: imported(p) & {"gantts_tpu_torch", "gantts_tpu"}
             for p in sources("reference")}
    assert not {p: n for p, n in found.items() if n}
    # and the yardstick's arithmetic neither
    for sub in ("flops", "metrics"):
        for p in sources(sub):
            assert not imported(p) & {"gantts_tpu_torch"}, p


def test_the_run_names_a_loaded_jax_module_by_its_whole_top_level_name(
        monkeypatch):
    import gantts_tpu_torch  # noqa: F401  (a name that begins with one)
    from perfbench import harness

    assert "gantts_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
