"""The port's vocoder fidelity bench (tools/torch_copy_synthesis_bench.py,
on gantts_tpu_torch/frontend/) against the JAX tool's, on the CPU:

  * both benches at ``--n 2`` write the same JSON (the port's front end is
    a copy of the JAX package's, and both load the same C++ engine's
    source; where nvidia-smi names no card, the workload texts are the
    same too);
  * tests/test_vocoder_fidelity.py's thresholds on the port's
    ``frontend.world``: harvest, dio + stonemask, and the copy-synthesis
    MCD with its aperiodicity levels;
  * the committed vocoder_fidelity_torch.json, written on the card's
    machine, within 1e-3 of vocoder_fidelity.json in every value (both
    are rounded to 4 digits), and its workload naming the card;
  * tools/report.py renders gv.png and modspec.png from an analysis.json
    written by the port's ``utils.analysis.write_analysis_report``;
  * both diagnostics print what tools/fidelity_decomp.py and
    tools/fidelity_diag.py print.
"""

import importlib
import json
import os
import sys
from os.path import dirname, join

import numpy as np
import pytest

from gantts_tpu_torch.frontend import world
from gantts_tpu_torch.utils.analysis import write_analysis_report
from tools import copy_synthesis_bench as jax_bench
from tools import report
from tools import torch_copy_synthesis_bench as bench

REPO = dirname(dirname(os.path.abspath(__file__)))
LIMIT = 1e-3


def test_bench_json_equals_jax_tools(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "card_line", lambda device: None)
    got = bench.main(["--n", "2", "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", [
        "copy_synthesis_bench.py", "--n", "2",
        "--out", str(tmp_path / "jax.json")])
    jax_bench.main()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert port == got
    assert port == ref
    assert set(port["conditions"]) == set(bench.CONDITIONS)


def test_workload_names_the_card(monkeypatch):
    monkeypatch.setattr(bench, "card_line",
                        lambda device: "NVIDIA H100 80GB HBM3, 700.00 W")
    text = bench.workload(6)
    assert text.startswith("6 synthetic utterances, fs=16000, 5ms hop; ")
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert f"numpy {np.__version__}" in text


def test_harvest_f0_accuracy():
    x, f0_true, vuv = bench.make_utterance(0)
    f0, _ = world.harvest(x, bench.FS)
    m = bench.f0_metrics(f0, f0_true, vuv)
    assert m["f0_rmse_hz"] < 2.0, m
    assert m["gross_error_rate"] < 0.005, m
    assert m["vuv_error_core"] < 0.04, m


def test_dio_stonemask_f0_accuracy():
    x, f0_true, vuv = bench.make_utterance(0)
    f0, t = world.dio(x, bench.FS)
    f0 = world.stonemask(x, f0, t, bench.FS)
    m = bench.f0_metrics(f0, f0_true, vuv)
    assert m["f0_rmse_hz"] < 2.0, m
    assert m["gross_error_rate"] < 0.005, m
    assert m["vuv_error_core"] < 0.06, m


def test_copy_synthesis_mcd_and_aperiodicity():
    x, _, vuv = bench.make_utterance(1)
    f0, t = world.harvest(x, bench.FS)
    sp = world.cheaptrick(x, f0, t, bench.FS)
    ap = world.d4c(x, f0, t, bench.FS)
    y = world.synthesize(f0, sp, ap, bench.FS)
    assert bench.mcd(x, y) < 1.7
    n = min(len(f0), len(vuv))
    v = (f0[:n] > 0) & vuv[:n]
    uv = (f0[:n] == 0) & ~vuv[:n]
    nb = ap.shape[1]
    assert ap[:n][v][:, : nb // 4].mean() < 0.15
    assert ap[:n][v].mean() < 0.22
    assert ap[:n][uv].mean() > 0.95


def test_committed_port_fidelity_is_the_jax_packages():
    with open(join(REPO, "vocoder_fidelity_torch.json")) as f:
        port = json.load(f)
    with open(join(REPO, "vocoder_fidelity.json")) as f:
        ref = json.load(f)
    workload = port["workload"]
    assert workload.startswith(ref["workload"] + "; on the machine of ")
    assert "H100" in workload and " W (numpy " in workload, workload
    key, gap = bench.largest_gap(port, ref)
    assert gap <= LIMIT, (key, gap)


def test_report_renders_the_ports_analysis(tmp_path):
    rs = np.random.RandomState(0)
    natural = tmp_path / "natural"
    natural.mkdir()
    for i in range(3):
        np.save(natural / f"utt_{i}.npy",
                np.cumsum(rs.randn(120, 6), axis=0) * 0.1)
    generated = [np.cumsum(rs.randn(100, 6), axis=0) * 0.05
                 for _ in range(2)]
    path = tmp_path / "run" / "analysis.json"
    path.parent.mkdir()
    write_analysis_report(str(path), generated, str(natural), 6, 200.0)
    out = tmp_path / "figures"
    report.main([str(path), "--out", str(out)])
    for name in ("gv.png", "modspec.png"):
        data = (out / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000, name


@pytest.mark.parametrize("tool,rows", [("fidelity_decomp", 4),
                                       ("fidelity_diag", 6)])
def test_diagnostics_print_what_the_jax_tools_print(tool, rows, capsys):
    """Both diagnostics run on the port and print, character for character,
    what the JAX tools print on the JAX package's front end: one row a
    variant (under the decomposition's header), every number finite."""
    importlib.import_module(f"tools.torch_{tool}").main()
    port = capsys.readouterr().out
    importlib.import_module(f"tools.{tool}").main()
    assert port == capsys.readouterr().out
    lines = [line for line in port.splitlines() if line.strip()]
    if tool == "fidelity_decomp":
        assert lines.pop(0).split() == ["variant", "all", "voiced",
                                        "boundary", "unvoiced"]
    assert len(lines) == rows, lines
    for line in lines:
        nums = []
        for word in line.split():
            try:
                nums.append(float(word))
            except ValueError:
                pass
        assert len(nums) >= 3 and all(np.isfinite(nums)), line
