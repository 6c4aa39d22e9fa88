"""The harness is driven by data: a cell that a later change adds with a
traffic file and an entry of BENCHMARK.json, and a per-layer metric added
as a file, are found by their names in a copy of the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from os.path import join

import numpy as np
import pytest

from perfbench import corpus, harness


def copy_of_benchmark(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(join(harness.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(root)


def add_cell(root):
    traffic = {"utterances": 64,
               "frames": {"kind": "lognormal", "median": 300,
                          "sigma_log": 0.2, "min": 100, "max": 600,
                          "order_seed": 3},
               "source": "a test's mix"}
    with open(join(root, "perfbench", "traffic", "short_test.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(join(root, "perfbench", "metrics", "test.steps.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['window']))\n")
    with open(join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tts_acoustic.short_test",
                               "config": "tts_acoustic",
                               "traffic": "short_test", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "test.steps", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "loop", "moves": "train_frames_per_s",
                               "workloads": ["tts_acoustic.short_test"]})
    with open(join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return traffic


def test_a_traffic_file_and_a_metric_file_added_in_a_copy_are_found(
        tmp_path):
    root = copy_of_benchmark(tmp_path)
    traffic = add_cell(root)
    cell, config, found, e2e, per_layer = harness.find_cell(
        "tts_acoustic.short_test", root=root)
    assert found == traffic and config["name"] == "tts_acoustic"
    assert [m["name"] for m in per_layer] == ["test.steps"]
    assert {m["name"] for m in e2e} == {"train_frames_per_s",
                                        "peak_mem_gib", "setup_s"}
    L = corpus.lengths(found)
    assert len(L) == 64 and L.min() >= 100 and L.max() <= 600
    assert np.median(L) == 300
    read = harness.metric_reader("test.steps", root=root)
    assert read({"window": [2, 3]}) == 2.0


def test_the_command_in_a_copy_finds_the_cell_then_wants_a_card(tmp_path):
    root = copy_of_benchmark(tmp_path)
    add_cell(root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = [sys.executable, "perfbench/run.py", "--seed", "2147483701",
            "--seconds", "1", "--trace", "0", "--workload"]
    found = subprocess.run(args + ["tts_acoustic.short_test"], cwd=root,
                           capture_output=True, text=True, env=env,
                           timeout=300)
    assert found.returncode == 2, found.stderr
    assert "needs 1 CUDA device" in found.stderr and not found.stdout
    unknown = subprocess.run(args + ["nope"], cwd=root, capture_output=True,
                             text=True, env=env, timeout=300)
    assert unknown.returncode not in (0, 2)
    assert "no workload 'nope'" in unknown.stderr and not unknown.stdout


def test_a_listed_corpus_keeps_its_lengths_in_order():
    traffic = {"utterances": 4, "frames": {"kind": "listed",
                                           "frames": [310, 95, 512, 77]}}
    assert list(corpus.lengths(traffic)) == [310, 95, 512, 77]
    traffic["utterances"] = 5
    with pytest.raises(ValueError):
        corpus.lengths(traffic)
