"""The port's host-pipeline tracing (gantts_tpu_torch/tracing.py), on the CPU.

* A small ``train_loop`` with its second epoch under torch.profiler (CPU
  activity), the profiler started by the loop's ``--profile-dir`` or by
  its writer as the benchmark's harness starts it, with and without a
  loader worker, one and two steps a dispatch: the record holds that
  epoch's spans alone, named as ``tracing.py`` names them, the loader's
  assembly on the worker's thread, the loop's thread's spans paired one to
  one with the trace's host ranges and placed inside the trace's extent by
  an offset whose spread is under 1 ms; the ``--profile-dir`` file holds
  the worker's spans; losses and parameters equal the unprofiled run's
  bit for bit.
* Without a profiler the record stays empty and no ``record_function``
  range is opened.
* ``StepGraph.replay`` is the span ``graphs.replay`` (a stand-in graph: a
  CUDA graph exists only on the card).
* The benchmark's six readers of the record (``perfbench/metrics/``) on a
  small synthetic trace and record with known answers, a clock offset
  between the two, and ``None`` on an empty record and in a process
  without the tracing module (a program that keeps no record).
"""

import json
import os
import statistics
import sys
import time
from os.path import dirname
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from gantts_tpu_torch import hparams, tracing
from gantts_tpu_torch.train import GanTrainer, StepConfig, graphs, loop, setup

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from perfbench import harness  # noqa: E402

SPANS = {"loader.assemble", "loader.wait", "loop.gather", "loop.stage",
         "step.launch", "loop.phase_end"}  # graphs.replay: the card's


@pytest.fixture(autouse=True)
def fresh_record(monkeypatch):
    monkeypatch.setattr(tracing, "RECORD", tracing.Record())


def _corpus():
    """14 train and 4 test utterances of 96 frames (one padded shape, so
    that two steps a dispatch fuse), 57 dims in and out."""
    rs = np.random.RandomState(0)
    X, Y, L = {}, {}, {}
    for phase, n in (("train", 14), ("test", 4)):
        X[phase] = [rs.randn(96, 57).astype(np.float32) for _ in range(n)]
        Y[phase] = [(0.8 * x + 0.1).astype(np.float32) for x in X[phase]]
        L[phase] = np.full(n, 96)
    return X, Y, L


class Slow:
    """A dataset whose items take 2 ms each: a phase's first fetch finds
    its batch not yet assembled."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, j):
        time.sleep(0.002)
        return self.dataset[j]


class Writer:
    """The loop's writer; with ``profile``, starts torch.profiler at the
    end of epoch 1 and stops it at the end of epoch 2 (as the harness's
    Clock does) and exports the trace to ``path``."""

    def __init__(self, path=None):
        self.rows, self.epoch, self.path, self.prof = [], 0, path, None

    def log_value(self, name, value, epoch):
        self.rows.append((name, float(value), int(epoch)))
        self.epoch = epoch

    def flush(self):
        if self.path is None:
            return
        if self.epoch == 2:
            self.prof.stop()
            self.prof.export_chrome_trace(self.path)
        elif self.epoch == 1:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            self.prof.start()


def _counts(name, phase=None):
    return [c.value for c in tracing.RECORD.counts if c.name == name
            and (phase is None or c.phase == phase)]


def _run(tmp_path, K, workers, how=None):
    """Three epochs of a small vc configuration (dropout on); ``how``:
    None, "profile_dir" or "writer".  Returns (logged rows, parameters,
    the trace's path)."""
    hp = hparams.vc.copy()
    hp.parse(f"nepoch=3,batch_size=4,batch_bucket_multiple=32,"
             f"num_workers={workers},cache_size=0")
    hp.order = 19
    hp.stream_sizes = [57]
    hp.generator_params.update(in_dim=57, out_dim=57, static_dim=19,
                               num_hidden=1, hidden_dim=16)
    hp.discriminator_params.update(in_dim=19, num_hidden=1, hidden_dim=8)
    data = tmp_path / f"data_{how}_{K}_{workers}"
    data.mkdir()
    loaders, mean, std = setup.prepare_vc(*_corpus(), hp, str(data))
    for loader in loaders.values():
        loader.dataset = Slow(loader.dataset)
    _, _, _, _, gstate, dstate = setup.init_models_and_states(
        hp, seed=0, device="cpu")
    trainer = GanTrainer(StepConfig.from_hparams(hp, 1.0, 0.0, 1.0, True,
                                                 True), mean, std, "cpu")
    prof_dir = str(tmp_path / f"prof_{K}_{workers}")
    path = {"profile_dir": os.path.join(prof_dir, "trace_epoch2.json"),
            "writer": str(tmp_path / f"writer_{K}_{workers}.json")}.get(how)
    writer = Writer(path if how == "writer" else None)
    loop.train_loop(trainer, gstate, dstate, loaders, hp, w_d=1.0,
                    writer=writer, seed=5, steps_per_dispatch=K,
                    profile_dir=prof_dir if how == "profile_dir" else None)
    params = [p.detach().clone() for s in (gstate, dstate)
              for p in s.model.parameters()]
    rows = [r for r in writer.rows
            if not r[0].endswith(("frames_per_sec", "epoch_seconds"))]
    return rows, params, path


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The unprofiled run (K = 2, one worker): its rows and parameters,
    the record after it and the record_function ranges it opened."""
    opened = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        opened.append(args)
        return real(*args, **kwargs)

    record = tracing.Record()
    with mock.patch.object(tracing, "RECORD", record), \
            mock.patch.object(torch.profiler, "record_function", counted):
        rows, params, _ = _run(tmp_path_factory.mktemp("plain"), 2, 1)
    return rows, params, record, opened


def test_no_profiler_no_record(plain):
    """Without a profiler the record stays empty and no host range opens."""
    rows, params, record, opened = plain
    assert rows and params
    assert record.spans == [] and record.counts == []
    assert opened == []


@pytest.mark.parametrize("how, K, workers", [
    ("profile_dir", 2, 1), ("writer", 2, 1), ("writer", 1, 0),
    ("profile_dir", 1, 0)])
def test_profiled_epoch_spans(plain, tmp_path, how, K, workers):
    rows, params, path = _run(tmp_path, K, workers, how)
    rec = tracing.RECORD
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]

    # the values of the unprofiled run, bit for bit
    assert rows == plain[0]
    assert all(torch.equal(a, b) for a, b in zip(params, plain[1]))

    # every span, named as tracing.py names them, of epoch 2 alone
    spans = tracing.spans()
    assert len(spans) == len(rec.spans) and spans
    names = {s.name for s in spans}
    dispatches = {f"gan_dispatch:{k}" for k in {1, K}}
    assert names == SPANS | dispatches
    assert {s.phase for s in spans} == {"train", "test"}
    # epoch 2: 4 train batches (the first shape's warm-up was epoch 1's),
    # 1 test batch; a gather a group and one that finds the loader empty
    train_groups = 4 // K
    assert len(tracing.spans("loop.gather", "train")) == train_groups + 1
    assert len(tracing.spans("loop.gather", "test")) == 2
    assert len(tracing.spans("loader.assemble")) == 5
    assert _counts("loader.fetch", "train") != [] and len(
        _counts("loader.fetch")) == 5
    assert all(isinstance(v, bool) for v in _counts("loader.fetch"))
    assert len(tracing.spans("loop.phase_end")) == 2
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.tid == s.tid and p.start <= s.start <= s.end <= p.end
    assembles = {s.tid for s in tracing.spans("loader.assemble")}
    if workers:
        assert rec.loop_tid not in assembles
    else:
        assert assembles == {rec.loop_tid}
        assert all(rec.spans[s.parent].name == "loader.wait"
                   for s in tracing.spans("loader.assemble"))

    # the loop's thread's spans pair one to one with the trace's ranges
    loop_spans = [s for s in spans if s.tid == rec.loop_tid]
    traced = {}
    ours = {}
    for s in loop_spans:
        ours[s.name] = ours.get(s.name, 0) + 1
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in ours and \
                "phase" not in e.get("args", {}):
            traced[e["name"]] = traced.get(e["name"], 0) + 1
    assert ours == traced
    offset, spread, pairs = tracing.clock_offset(events)
    assert pairs == len(loop_spans)
    assert spread < 1000.0  # us
    a, b = min(e["ts"] for e in events), max(e["ts"] + e.get("dur", 0)
                                             for e in events)
    for s in spans:
        t0, t1 = tracing.trace_us(s, offset)
        assert a - 1000.0 <= t0 <= t1 <= b + 1000.0, s

    # the --profile-dir file holds the worker's spans on their thread
    added = [e for e in events if e.get("args", {}).get("phase")]
    if how == "profile_dir" and workers:
        assert {e["name"] for e in added} == {"loader.assemble"}
        assert {e["tid"] for e in added} == assembles
        assert len(added) == 5
    else:
        assert added == []


def test_latest_profiled_epoch_only(tmp_path):
    """A phase that finds a profiler after one that found none starts the
    record anew; phases without one leave it as it is."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    for round_ in range(2):
        prof.start()
        for name in ("train", "test"):
            with tracing.phase(name) as on:
                assert on
                with tracing.span(f"round{round_}"):
                    tracing.count("n", round_)
        prof.stop()
        with tracing.phase("train") as on:
            assert not on
            with tracing.span("off"):
                tracing.count("n", -1)
        assert [s.name for s in tracing.spans()] == [f"round{round_}"] * 2
        assert _counts("n") == [round_] * 2
        assert [s.phase for s in tracing.spans()] == ["train", "test"]


def test_graph_replay_span(tmp_path):
    """``StepGraph.replay`` fills, replays and copies out inside the span
    ``graphs.replay`` (a stand-in for the captured CUDA graph)."""
    opt = SimpleNamespace(version=0)
    g = object.__new__(graphs.StepGraph)
    states = (SimpleNamespace(optimizer=opt), SimpleNamespace(optimizer=opt))
    g.states, g.versions, g.R, g.generator = states, [0, 0], None, None
    g.xs, g.ys = torch.zeros(2, 3), torch.zeros(2, 3)
    g.lengths, g.zs = torch.zeros(2), None
    g.adv_w = torch.zeros(())
    g.launches, g.outs = {}, {"generator": torch.arange(2.0)}
    open_at_replay = []
    g.graph = SimpleNamespace(replay=lambda: open_at_replay.append(
        [s.name for s in tracing.RECORD.spans if s.end is None]))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, tracing.phase("train"):
        out = g.replay(*states, torch.ones(2, 3), torch.ones(2, 3),
                       torch.ones(2), None, 0.5, None, None)
    assert open_at_replay == [["graphs.replay"]]
    assert torch.equal(g.xs, torch.ones(2, 3)) and float(g.adv_w) == 0.5
    assert torch.equal(out["generator"], torch.arange(2.0))
    assert [s.name for s in tracing.spans()] == ["graphs.replay"]
    names = [e.name for e in prof.events()]
    assert "graphs.replay" in names


# ---- the benchmark's readers ----------------------------------------------

OFFSET = 250.0  # us: the trace's clock minus the record's
MS = 1_000_000  # ns


def _span(name, phase, start_ms, end_ms, tid=1):
    return tracing.Span(name, phase, tid, int(start_ms * MS),
                        int(end_ms * MS))


def _synthetic():
    """An epoch of 4 training steps (2 groups of 2) and 1 test step: the
    record's spans (ms on its clock), the loop's thread 1, a worker 2; the
    trace's host ranges of the loop's spans OFFSET us later, and device
    work 2-5, 7-9 and 13-20 ms on the record's clock."""
    rec = tracing.Record()
    rec.loop_tid = 1
    rec.spans = [
        _span("loop.gather", "train", 0, 4),         # 2 ms idle (0-2)
        _span("loader.wait", "train", 0.5, 1.5),
        _span("loader.assemble", "train", 0, 3, tid=2),
        _span("loader.assemble", "train", 3, 4, tid=2),
        _span("loop.stage", "train", 4, 4.5),
        _span("graphs.replay", "train", 4.5, 5),
        _span("loop.gather", "train", 5, 8),         # 5-7 idle: 2 ms
        _span("loader.wait", "train", 6, 6.25),
        _span("loader.assemble", "train", 4, 6, tid=2),
        _span("loader.assemble", "train", 6, 8, tid=2),
        _span("loop.stage", "train", 8, 8.5),
        _span("graphs.replay", "train", 8.5, 9),
        _span("loop.gather", "train", 9, 10),        # 1 ms idle
        _span("loop.phase_end", "train", 10, 11),
        _span("loop.gather", "test", 11, 13),        # 2 ms idle
        _span("loader.assemble", "test", 11, 12, tid=2),
        _span("loop.stage", "test", 13, 13.5),
        _span("step.launch", "test", 13.5, 14),
        _span("loop.gather", "test", 14, 14.5),      # 0 idle
        _span("loop.phase_end", "test", 14.5, 21),
    ]
    rec.counts = [tracing.Count("loader.fetch", "train", v)
                  for v in (False, True, False, True)] + [
        tracing.Count("loader.fetch", "test", False)]
    events = []
    for s in rec.spans:
        if s.tid == rec.loop_tid:
            a, b = tracing.trace_us(s, OFFSET)
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": s.name, "ts": a, "dur": b - a})
    for a, b in ((2, 5), (7, 9), (13, 20)):
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": a * 1e3 + OFFSET, "dur": (b - a) * 1e3})
    book = harness.Book()
    book.fetches = [(3, "train", 0.001, 32, np.ones(4))] * 4 + [
        (3, "train", 0.0, None, None), (3, "test", 0.0, 32, np.ones(4)),
        (2, "train", 0.0, 32, np.ones(4))]
    ctx = dict(book=book, window=[2, 3], ends={}, hp={}, ops=None,
               trace=events, trace_epoch=3)
    return rec, ctx


READINGS = {
    "loader.wait_ms": (1.0 + 0.25) / 4,
    "loader.assemble_ms": (3 + 1 + 2 + 2) / 4,
    "loader.ready_share": 50.0,
    "loop.stage_ms": (0.5 + 0.5) / 4,
    "graphs.launch_ms": (0.5 + 0.5) / 4,   # the test phase's launch apart
    "loop.gather_idle_ms": (2 + 2 + 1 + 2 + 0) / 4,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(monkeypatch, name):
    rec, ctx = _synthetic()
    read = harness.metric_reader(name)
    assert read(ctx) is None  # the empty record
    monkeypatch.setattr(tracing, "RECORD", rec)
    assert read(ctx) == pytest.approx(READINGS[name], abs=1e-9)
    with monkeypatch.context() as m:  # a program that keeps no record
        m.delitem(sys.modules, "gantts_tpu_torch.tracing")
        assert read(ctx) is None
    offset, spread, pairs = tracing.clock_offset(ctx["trace"])
    assert offset == pytest.approx(OFFSET) and spread == pytest.approx(0)
    assert pairs == sum(s.tid == 1 for s in rec.spans)


def test_readers_are_declared():
    """The six readers are per-layer metrics of both cells."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    declared = {m["name"]: m for m in bench["per_layer"]}
    cells = [c["name"] for c in bench["workloads"]]
    for name in READINGS:
        assert declared[name]["workloads"] == cells
        assert declared[name]["moves"] == "train_frames_per_s"


def test_clock_offset_median():
    """The offset is the median over the pairs; a name whose counts differ
    is left out; the spread is the distance between the quartiles."""
    rec = tracing.Record()
    rec.loop_tid = 1
    rec.spans = [_span("loop.stage", "train", k, k + 0.5) for k in range(5)]
    rec.spans.append(_span("loop.gather", "train", 9, 10))
    shifts = [100.0, 101.0, 102.0, 103.0, 500.0]
    events = [{"ph": "X", "cat": "user_annotation", "name": "loop.stage",
               "ts": k * 1e3 + d, "dur": 500.0}
              for k, d in enumerate(shifts)]
    events += [{"ph": "X", "cat": "user_annotation", "name": "loop.gather",
                "ts": 1.0, "dur": 1.0}] * 2
    offset, spread, pairs = tracing.clock_offset(events, rec)
    q = statistics.quantiles(shifts, n=4)
    assert (offset, spread, pairs) == (102.0, pytest.approx(q[2] - q[0]), 5)
    assert tracing.clock_offset([], rec) is None
