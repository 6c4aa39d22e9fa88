"""The plain reference against the program's step on the CPU at a small
size, through a whole run of the harness: the losses of the first three
steps, the first gradients and the parameters' changes agree."""

import json
import time
from os.path import dirname, join

import numpy as np
import pytest
import torch

from perfbench import corpus, harness
from perfbench.reference import gan

DATA = join(dirname(__file__), "data")


def load(name):
    with open(join(DATA, f"{name}.json")) as f:
        return json.load(f)


def bench():
    return harness.load_json(join(harness.ROOT, "BENCHMARK.json"))


def run(config, seed, traced=False, seconds=0.5):
    b = bench()
    lines = []
    result = harness.run_cell(
        load(config), load("tiny"), b["end_to_end"], b["per_layer"], seed,
        seconds, traced, "cpu", time.perf_counter(), say=lines.append)
    return result, lines


@pytest.mark.parametrize("config", ["tiny_tts", "tiny_vc"])
def test_a_sound_run_on_the_cpu_is_correct(config):
    result, _ = run(config, 5)
    assert result["correct"], result["compared"]
    for name, c in result["compared"].items():
        assert c["value"] < 1e-5, (name, c)
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"train_frames_per_s", "peak_mem_gib",
                                      "setup_s"}
    # on the CPU every step runs alone: the change after the third is read
    assert set(result["compared"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_traced_run_on_the_cpu_reads_the_host_metrics():
    result, _ = run("tiny_tts", 6, traced=True, seconds=1.5)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["graphs.fused_share"]["value"] == 0.0  # no graphs here
    assert metrics["loop.data_wait_ms"]["value"] >= 0.0
    # no device events on the CPU: the device's readers give nothing
    for name in ("matmul_roofline", "recurrence_roofline",
                 "device.idle_share"):
        assert name not in metrics
    assert result["device"]["busy_s"] == 0.0


def setup_only(config, seed, tmp):
    """The program and the window's call with its epoch 1 alone."""
    cfg = load(config)
    sd = harness.seeds(seed)
    raw = corpus.make(cfg, load("tiny"), sd["corpus"], torch.device("cpu"))
    with harness.program_output_to_stderr():
        return harness.drive(cfg, raw, sd, torch.device("cpu"), str(tmp))


def test_epoch_1_hands_on_its_first_batches_then_the_extra_ones(tmp_path):
    prog, book, _, record, _ = setup_only("tiny_tts", 8, tmp_path)
    trained = book.batches([1], "train")
    assert len(trained) == 3 and len(record["losses"]) == 3
    loader = prog.loaders["train"]
    extra = trained[:1]
    feed = harness.Feed(loader, "train", harness.Book(), 2,
                        [(np.zeros((4, 32, 1)), None, e[4]) for e in extra])
    assert len(feed) == 3
    epoch = loader.epoch
    assert len(list(feed)) == 3
    assert loader.epoch == epoch + 1  # the rest of that epoch was assembled
    assert len(feed) == len(loader) == len(list(feed))


def test_the_seed_made_state_is_back_in_place_after_epoch_1(tmp_path):
    prog, _, _, record, _ = setup_only("tiny_tts", 9, tmp_path)
    weights = harness.weights_of(load("tiny_tts"), harness.seeds(9),
                                 torch.device("cpu"))
    assert max(record["change"].values()) > 0
    for prefix, state in prog.optimizers():
        for k, p in state.model.named_parameters():
            assert torch.equal(p.detach(), weights[prefix + k]), k
        for st in state.optimizer.state_dict()["state"].values():
            assert not st["sum"].any()


def test_a_record_without_the_change_is_judged_by_the_other_two():
    from perfbench import check

    losses = [{"discriminator": 1.0, "generator": 2.0}] * 3
    ref = {"losses": losses, "grad": {"a": 1.0, "b": 2.0},
           "change": {"a": 0.1, "b": 0.2}}
    prog = dict(ref, change=None)
    limits = {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}
    ok, compared = check.verdict(check.readings(prog, ref), limits)
    assert ok and set(compared) == {"loss_gap", "grad_gap"}
    prog["grad"] = {"a": 1.0, "b": 2.1}
    assert not check.verdict(check.readings(prog, ref), limits)[0]
    assert not check.verdict({"loss_gap": 0.0}, limits)[0]


def test_the_reference_mlpg_matrix_is_the_programs():
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix

    hp = harness.hparams_of(load("tiny_tts"))
    for T in (32, 96):
        ours = gan.mlpg_matrix(hp["windows"], T, "cpu").numpy()
        theirs = unit_variance_mlpg_matrix(hp["windows"], T, np.float32)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6)


def test_the_reference_split_and_batches_are_the_programs():
    from gantts_tpu_torch.data import BatchIterator, split_files

    n = 61
    tr, te = gan.split(n)
    ptr, pte = split_files(list(range(n)))
    assert list(tr) == ptr and list(te) == pte
    lengths = np.arange(n) % 17 + 3

    class Lengths:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return (np.full((lengths[i], 1), i, np.float32),
                    np.zeros((lengths[i], 1), np.float32))

    it = BatchIterator(Lengths(), 8, shuffle=True, bucket_multiple=4)
    for epoch in range(2):
        for idx, (x, _, ls) in zip(gan.batch_indices(n, 8, epoch), it):
            assert list(ls[:len(idx)]) == list(lengths[idx])
            assert list(x[:len(idx), 0, 0]) == list(idx)


def test_every_seed_gets_the_same_lengths():
    t = load("tiny")
    a, b = corpus.lengths(t), corpus.lengths(t)
    assert (a == b).all() and a.min() >= 16 and a.max() <= 80
    cfg = load("tiny_tts")
    L1, X1, _ = corpus.make(cfg, t, 1, torch.device("cpu"))
    L2, X2, _ = corpus.make(cfg, t, 2, torch.device("cpu"))
    assert (L1 == L2).all() and not np.array_equal(X1[0], X2[0])
    L3, X3, _ = corpus.make(cfg, t, 1, torch.device("cpu"))
    assert np.array_equal(X1[3], X3[3])
