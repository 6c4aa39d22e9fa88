"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the metrics.

Set-up builds the program as its command line does (``gantts_tpu_torch.
train``): the bundle with the configuration's settings, the loaders of
``train.setup.prepare_tts`` / ``prepare_vc`` over an in-memory corpus made
from the seed (``corpus.py``), the models of ``init_models_and_states``
with weights made from the seed here and copied in, one ``GanTrainer``.
Then one call of ``train.loop.train_loop`` at the command line's steps a
dispatch, K:

  * epoch 1 is set-up and holds the checked steps: the first K + 1
    training batches of the loader's first epoch (the first runs alone,
    the next K as one graph replay where they share a shape), the rest of
    that epoch assembled and not trained, so that the loader's item cache
    is full as after a user's first epoch, then one batch of each shape
    that only later epochs hold; the test phase likewise from one batch.
    ``Probe`` keeps the losses of the first three steps, the optimizers'
    accumulators after the first and, where the third step ends a
    dispatch, the parameters after it.  At its end the seed-made weights
    and the optimizers' state are copied back in place;
  * epochs 2 .. N + 1 are the measured window; N comes from the seconds
    asked for and the configuration's planning rate.  The loop's writer
    marks each epoch's end, after its test phase's one synchronisation;
    the window runs from the end of epoch 1 to the end of the last.

A traced run profiles one whole epoch of the window (its second, or its
only one) and reads the per-layer metrics from that trace and from the
harness's own spans (``metrics/``).

The reference runs once the window has closed, the peak memory has been
read and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from os.path import abspath, dirname, join

import numpy as np
import torch

from perfbench import check, corpus, trace
from perfbench.reference import gan

BENCH = dirname(abspath(__file__))
ROOT = dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "gantts_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(workload, root=ROOT):
    """(cell, configuration, traffic, per-layer metrics) of a workload of
    ``root``'s BENCHMARK.json, each found by its name."""
    bench = load_json(join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are {sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(join(root, cfg_entry["file"]))
    traffic = load_json(join(root, "perfbench", "traffic",
                             f"{cell['traffic']}.json"))
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return cell, config, traffic, end_to_end, per_layer


def family(config):
    """The generator family's plain reference and operation counts."""
    name = config["family"]
    ref = importlib.import_module(f"perfbench.reference.{name}")
    ops = importlib.import_module(f"perfbench.flops.{name}")
    return ref, ops


def metric_reader(name, root=ROOT):
    """``perfbench/metrics/<name>.py``'s ``read(ctx)``."""
    path = join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds(seed):
    """Independent 32-bit seeds of the corpus, the weights and the loop
    (its dropout stream), from any whole number."""
    c, w, l = np.random.SeedSequence(int(seed)).generate_state(3)
    return {"corpus": int(c), "weights": int(w), "loop": int(l)}


def hparams_of(config):
    """The configuration's settings as the reference reads them: windows
    as (l, u, coefficients)."""
    hp = copy.deepcopy(config["hparams"])
    hp["windows"] = [(int(l), int(u), np.asarray(c, np.float64))
                     for l, u, c in hp["windows"]]
    return hp


def make_weights(specs, seed, device, prefix):
    """U(-bound, bound) for every entry of a weight table, from the seed,
    in one draw on the device."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out = {}
    for (name, shape, bound), part in zip(specs, torch.split(flat, sizes)):
        out[prefix + name] = (part * bound).reshape(shape)
    return out


def weights_of(config, sd, device):
    hp = hparams_of(config)
    ref, _ = family(config)
    return {**make_weights(ref.param_specs(hp), sd["weights"], device, "G."),
            **make_weights(gan.mlp_specs(hp), sd["weights"] + 1, device,
                           "D.")}


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class Program:
    """The port as its command line builds it, over an in-memory corpus."""

    def __init__(self, config, raw, weights, sd, device, tmp):
        from gantts_tpu_torch import hparams as bundles
        from gantts_tpu_torch.data import split_files
        from gantts_tpu_torch.train import GanTrainer, StepConfig
        from gantts_tpu_torch.train.setup import (
            init_models_and_states,
            prepare_tts,
            prepare_vc,
        )

        hp = getattr(bundles, config["bundle"]).copy()
        for k, v in hparams_of(config).items():
            setattr(hp, k, v)
        L, X, Y = raw
        tr, te = split_files(list(range(len(L))))
        Xs = {"train": [X[i] for i in tr], "test": [X[i] for i in te]}
        Ys = {"train": [Y[i] for i in tr], "test": [Y[i] for i in te]}
        lens = {"train": L[tr], "test": L[te]}
        prepare = prepare_vc if hp.name == "vc" else prepare_tts
        self.loaders, y_mean, y_std = prepare(Xs, Ys, lens, hp, tmp)
        _, _, _, _, self.gstate, self.dstate = init_models_and_states(
            hp, seed=sd["loop"], device=device)
        self.load_weights(weights)
        run = config["run"]
        cfg = StepConfig.from_hparams(hp, run["w_d"], run["mse_w"],
                                      run["mge_w"], run["update_d"],
                                      run["update_g"])
        self.trainer = GanTrainer(cfg, y_mean, y_std, device,
                                  windows=hp.windows)
        self.hp, self.run, self.device = hp, run, torch.device(device)
        self.lengths = lens

    def loop(self, feeds, epochs, writer, seed, steps_per_dispatch):
        from gantts_tpu_torch.train.loop import train_loop

        self.hp.nepoch = epochs
        run = self.run
        train_loop(self.trainer, self.gstate, self.dstate, feeds, self.hp,
                   w_d=run["w_d"], mse_w=run["mse_w"], mge_w=run["mge_w"],
                   update_d=run["update_d"], update_g=run["update_g"],
                   checkpoint_dir=None, writer=writer, global_epoch=0,
                   seed=seed, steps_per_dispatch=steps_per_dispatch)

    def optimizers(self):
        return (("G.", self.gstate), ("D.", self.dstate))

    def optimizer_state(self):
        """A copy of every tensor of the optimizers' state, by (prefix,
        parameter index, key)."""
        return {(prefix, i, key): v.detach().clone()
                for prefix, state in self.optimizers()
                for i, st in state.optimizer.state_dict()["state"].items()
                for key, v in st.items() if torch.is_tensor(v)}

    def load_weights(self, weights):
        """The weight table's tensors copied into the models' parameters in
        place (the step graphs hold these very tensors)."""
        with torch.no_grad():
            for prefix, state in self.optimizers():
                params = dict(state.model.named_parameters())
                names = {k[2:] for k in weights if k[:2] == prefix}
                if set(params) != names:
                    raise RuntimeError(
                        f"the program's {prefix[0]} parameters "
                        f"{sorted(set(params) ^ names)} differ from the "
                        "weight table's")
                for k, p in params.items():
                    p.copy_(weights[prefix + k])

    def restore(self, weights, saved):
        """The seed-made weights and the optimizers' state (``saved``) back
        in place.  The step count that the optimizer keeps apart on the
        device runs on: Adagrad without ``lr_decay`` does not read it."""
        self.load_weights(weights)
        with torch.no_grad():
            for prefix, state in self.optimizers():
                live = state.optimizer.state_dict()["state"]
                for (pre, i, key), v in saved.items():
                    if pre == prefix:
                        live[i][key].copy_(v)


class Probe:
    """Keeps the losses of the first three training steps, each
    optimizer's accumulator after the first step and, where the third step
    ends a dispatch, the parameters after it, by wrapping the trainer's
    ``step`` and ``multi_step`` on the instance until ``close``.  A step
    inside a multi-step dispatch (or its capture) is counted when the
    dispatch returns; the parameters after a third step that runs inside
    a graph replay cannot be read, and the change is not compared."""

    def __init__(self, program):
        self.program = program
        trainer = program.trainer
        self.losses, self.sums, self.params, self.count = [], None, None, 0
        step, multi = trainer.step, trainer.multi_step
        depth = [0]

        def one(*args, **kwargs):
            out = step(*args, **kwargs)
            if depth[0] == 0 and kwargs.get("train", True):
                self._after({k: v.reshape(1) for k, v in out[2].items()})
            return out

        def many(*args, **kwargs):
            depth[0] += 1
            try:
                out = multi(*args, **kwargs)
            finally:
                depth[0] -= 1
            if kwargs.get("train", True):
                self._after(out[2])
            return out

        trainer.step, trainer.multi_step = one, many

    def _after(self, outs):
        n = int(outs["generator"].shape[0])
        for j in range(n):
            if len(self.losses) < 3:
                self.losses.append({k: float(outs[k][j])
                                    for k in check.LOSSES})
        before, self.count = self.count, self.count + n
        if before < 1 <= self.count:
            if self.count != 1:
                raise RuntimeError("the first step ran inside a dispatch")
            self.sums = {}
            for prefix, state in self.program.optimizers():
                st = state.optimizer.state_dict()["state"]
                for i, (k, _) in enumerate(state.model.named_parameters()):
                    self.sums[prefix + k] = st[i]["sum"].detach().to(
                        "cpu", copy=True)
        if before < 3 == self.count:
            self.params = {prefix + k: p.detach().to("cpu", copy=True)
                           for prefix, state in self.program.optimizers()
                           for k, p in state.model.named_parameters()}

    def close(self, weights):
        """The trainer's own methods back, and the record of the steps."""
        del self.program.trainer.step, self.program.trainer.multi_step
        if self.count < 3 or self.sums is None:
            raise RuntimeError(f"the checked epoch ran {self.count} "
                               "training steps, not 3 or more")
        grad = {k: math.sqrt(float(v.double().sum()))
                for k, v in self.sums.items()}
        change = None if self.params is None else check.norms(
            {k: self.params[k] - weights[k].cpu() for k in weights})
        return {"losses": self.losses, "grad": grad, "change": change}


class Subset:
    def __init__(self, dataset, idx):
        self.dataset, self.idx = dataset, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, j):
        return self.dataset[self.idx[j]]


class Book:
    """What the window's loaders handed the loop, and the host time the
    loop waited for it: per fetch (epoch, phase, seconds, T, lengths)."""

    def __init__(self):
        self.epoch = 0
        self.fetches = []

    def batches(self, epochs, phase=None):
        return [f for f in self.fetches if f[0] in epochs and f[3] is not None
                and (phase is None or f[1] == phase)]


class Feed:
    """A loader as the loop sees it, with the harness's span around each
    fetch (``perfbench.fetch:<phase>`` for the trace, and the host clock).
    In epoch 1 it hands on the loader epoch's first ``first`` batches,
    assembles the rest without handing them on (they fill the loader's
    item cache), then hands on the ``extra`` batches."""

    def __init__(self, loader, phase, book, first, extra=()):
        self.loader, self.phase, self.book = loader, phase, book
        self.first, self.extra = first, list(extra)

    def _next_epoch(self):
        return self.book.epoch + (self.phase == "train")

    def __len__(self):
        if self._next_epoch() == 1:
            return min(self.first, len(self.loader)) + len(self.extra)
        return len(self.loader)

    def __iter__(self):
        epoch = self.book.epoch = self._next_epoch()
        it = iter(self.loader)
        name = f"perfbench.fetch:{self.phase}"
        handed = 0
        while epoch > 1 or handed < self.first:
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                batch = next(it, None)
            dt = time.perf_counter() - t0
            self.book.fetches.append(
                (epoch, self.phase, dt,
                 None if batch is None else batch[0].shape[1],
                 None if batch is None else np.asarray(batch[2], np.int64)))
            if batch is None:
                break
            handed += 1
            yield batch
        if epoch == 1:
            for _ in it:
                pass
            for batch in self.extra:
                self.book.fetches.append((epoch, self.phase, 0.0,
                                          batch[0].shape[1],
                                          np.asarray(batch[2], np.int64)))
                yield batch


class Clock:
    """The loop's writer: it keeps the logged values and, at each epoch's
    end (``flush``, after the test phase's synchronisation), the time, and
    starts and stops the window's clock, its memory peak and the profiler.
    At the end of epoch 1 it calls ``end_of_setup`` first.
    """

    def __init__(self, device, trace_epoch, tmp, graphs, end_of_setup):
        self.device = torch.device(device)
        self.trace_epoch, self.tmp, self.graphs = trace_epoch, tmp, graphs
        self.end_of_setup = end_of_setup
        self.values, self.ends, self.epoch = [], {}, 0
        self.prof = self.trace_path = None
        self.launches = {}
        self.setup_peak = self.graphs_at_start = 0

    def log_value(self, name, value, epoch):
        self.values.append((epoch, name, value))
        self.epoch = epoch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flush(self):
        from gantts_tpu_torch.kernels import launch_counts

        self._sync()
        e = self.epoch
        if self.prof is not None and e == self.trace_epoch:
            self.prof.stop()
            self.launches["stop"] = dict(launch_counts)
            self.trace_path = join(self.tmp, "trace.json")
            self.prof.export_chrome_trace(self.trace_path)
            self.prof = None
        if e == 1:
            self.end_of_setup()
            self._sync()
            self.graphs_at_start = self.graphs()
            if self.device.type == "cuda":
                self.setup_peak = torch.cuda.max_memory_allocated(
                    self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
        self.ends[e] = time.perf_counter()
        if self.trace_epoch is not None and e == self.trace_epoch - 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.launches["start"] = dict(launch_counts)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.ends[e] = time.perf_counter()


def plan_shapes(lengths, batch_size, multiple, epoch, shuffle=True):
    """The padded T of each batch of a loader epoch."""
    return [-(-int(lengths[idx].max()) // multiple) * multiple
            for idx in gan.batch_indices(len(lengths), batch_size, epoch,
                                         shuffle)]


def extra_batches(program, phase, seen, epochs):
    """One batch of each shape of the ``phase`` loader's epochs ``epochs``
    that is not in ``seen``: the first such batch, assembled by the
    program's own loader class."""
    from gantts_tpu_torch.data import BatchIterator

    loader = program.loaders[phase]
    L = np.asarray(program.lengths[phase])
    B, mult = loader.batch_size, loader.bucket_multiple
    shuffle = phase == "train"
    seen, out = set(seen), []
    for e in epochs:
        for idx, T in zip(gan.batch_indices(len(L), B, e, shuffle),
                          plan_shapes(L, B, mult, e, shuffle)):
            if T not in seen:
                seen.add(T)
                sub = BatchIterator(Subset(loader.dataset, idx), B,
                                    shuffle=False, bucket_multiple=mult)
                out.append(next(iter(sub)))
    return out


def feeds_of(program, book, K, N):
    """The loaders of the window's call: epoch 1 trains on the loader's
    first K + 1 batches (three at the least), tests on its first one, and
    then on one batch of each shape that epochs 2 .. N + 1 hold and those
    do not."""
    feeds = {}
    for phase, first in (("train", max(K + 1, 3)), ("test", 1)):
        loader = program.loaders[phase]
        L = np.asarray(program.lengths[phase])
        shuffle = phase == "train"
        B, mult = loader.batch_size, loader.bucket_multiple
        seen = plan_shapes(L, B, mult, loader.epoch, shuffle)[:first]
        later = range(loader.epoch + 1, loader.epoch + N + 1)
        feeds[phase] = Feed(loader, phase, book, first,
                            extra_batches(program, phase, seen, later))
    return feeds


def window_epochs(program, config, seconds):
    """N, from the seconds asked for and the configuration's planning rate
    in padded frames a second over an epoch's training and test batches."""
    padded = 0
    for phase in ("train", "test"):
        loader = program.loaders[phase]
        L = np.asarray(program.lengths[phase])
        padded += loader.batch_size * sum(plan_shapes(
            L, loader.batch_size, loader.bucket_multiple, 0,
            phase == "train"))
    rate = config["window"]["padded_frames_per_s"]
    return max(1, int(round(seconds * rate / padded)))


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def program_output_to_stderr():
    """The program's own prints go to standard error: the result's line
    stays the last line of standard output."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def run_cell(config, traffic, end_to_end, per_layer, seed, seconds, traced,
             device, t_start, say=print):
    """One run of a cell on ``device``: returns the result's dict
    (``compared`` last); ``say`` gets the lines on set-up and the trace."""
    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(config, traffic, end_to_end, per_layer, seeds(seed),
                    seconds, traced, device, t_start, tmp, say)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def drive(config, raw, sd, device, tmp, seconds=None, traced=False,
          stamps=None):
    """The program over the corpus ``raw`` and the window's call: epoch 1
    (set-up, with the checked steps) and, for ``seconds``, epochs
    2 .. N + 1.  Returns (the program, the book, the clock, the checked
    steps' record, N)."""
    from gantts_tpu_torch.train.__main__ import steps_per_dispatch

    stamps = [] if stamps is None else stamps
    weights = weights_of(config, sd, device)
    prog = Program(config, raw, weights, sd, device, tmp)
    stamps.append(("program", time.perf_counter()))
    K = steps_per_dispatch(0, str(device), False)
    N = 0 if seconds is None else window_epochs(prog, config, seconds)
    book = Book()
    feeds = feeds_of(prog, book, K, N)
    probe, saved, record = Probe(prog), prog.optimizer_state(), []

    def end_of_setup():
        record.append(probe.close(weights))
        prog.restore(weights, saved)
        weights.clear()
        saved.clear()

    trace_epoch = (3 if N >= 2 else 2) if traced else None
    clock = Clock(device, trace_epoch, tmp, lambda: _graphs(prog),
                  end_of_setup)
    stamps.append(("plan", time.perf_counter()))
    prog.loop(feeds, N + 1, clock, sd["loop"], K)
    return prog, book, clock, record[0], N


def _run(config, traffic, end_to_end, per_layer, sd, seconds, traced, device,
         t_start, tmp, say):
    stamps = [("start", t_start), ("imports", time.perf_counter())]
    raw = corpus.make(config, traffic, sd["corpus"], device)
    stamps.append(("corpus", time.perf_counter()))
    with program_output_to_stderr():
        prog, book, clock, program_record, N = drive(
            config, raw, sd, device, tmp, seconds, traced, stamps)
    stamps.append(("epoch 1", clock.ends[1]))
    t_end = clock.ends[N + 1]
    window_s = t_end - clock.ends[1]
    setup_s = clock.ends[1] - t_start
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
    else:
        window_peak = 0
    memory_peak = max(window_peak, clock.setup_peak)
    notes = _notes(book, N, clock.graphs_at_start, _graphs(prog))
    notes.append("set-up, seconds: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(stamps,
                                                            stamps[1:])))
    window = list(range(2, N + 2))
    train_steps = len(book.batches(window, "train"))
    frames = N * int(np.sum(prog.lengths["train"]))
    failed = _failed_steps(clock.values, book, window)
    hp = hparams_of(config)
    clock.graphs = clock.end_of_setup = None  # they hold the program
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window
    ref_family, ops = family(config)
    weights = weights_of(config, sd, device)
    t_ref = time.perf_counter()
    reference = check.reference_record(ref_family, hp, config["run"], raw,
                                       weights, sd["loop"], device)
    notes.append(f"the reference took {time.perf_counter() - t_ref:.3f} s")
    values = check.readings(program_record, reference)
    correct, compared = check.verdict(values, config["limits"])
    correct = correct and failed == 0

    ctx = dict(book=book, window=window, ends=clock.ends, hp=hp, ops=ops,
               trace=None, trace_epoch=clock.trace_epoch)
    result = {"correct": bool(correct), "attempted": train_steps,
              "failed": failed}
    if traced:
        if clock.trace_path is None:
            raise RuntimeError("the traced epoch was not traced")
        events = trace.load(clock.trace_path)
        ctx["trace"] = events
        metrics = {}
        for m in per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = trace.device_events(events)
        busy, pieces = trace.union([trace.span(e) for e in dev])
        a, b = trace.extent(events)
        device_info = {"busy_s": busy / 1e6, "window_s": (b - a) / 1e6}
        result["breakdown"] = {
            "device_ops": trace.top_ops(dev),
            "idle_gaps": trace.idle_gaps(pieces, a, b,
                                         trace.host_ranges(events))}
        notes += _launch_notes(events, clock)
    else:
        e2e = {"train_frames_per_s": frames / window_s,
               "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end}
        device_info = {}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(memory_peak), **device_info}
    phases = {(e, name.split()[0]): v for e, name, v in clock.values
              if name.endswith(" epoch_seconds")}
    result["window"] = {"epochs": N, "seconds": window_s,
                        "train_steps": train_steps, "train_frames": frames,
                        "phase_seconds": [[phases.get((e, p)) for p in
                                           ("train", "test")]
                                          for e in window]}
    result["compared"] = compared
    for line in notes:
        say(line)
    return result


def _graphs(prog):
    graphs = getattr(prog.trainer, "_graphs", None)
    return 0 if graphs is None else len(graphs.graphs)


def _notes(book, N, before, after):
    """Lines on what the window met that set-up did not prepare."""
    notes = []
    warm = {(f[1], f[3]) for f in book.batches([1])}
    new = sorted({(f[1], f[3]) for f in book.batches(range(2, N + 2))}
                 - warm)
    if new:
        notes.append(f"note: shapes first met inside the window: {new}")
    if after != before:
        notes.append(f"note: {after - before} step graph(s) captured inside "
                     "the window")
    return notes


def _failed_steps(values, book, window):
    """Training steps of window epochs whose logged training losses are not
    finite."""
    bad = {e for e, name, v in values if e in window and name.startswith(
        "train ") and name.endswith(" loss") and not math.isfinite(v)}
    return len([f for f in book.batches(bad, "train")])


def _launch_notes(events, clock):
    """The trace's launches of the port's counted kernels against its own
    counters over the same epoch; a disagreement is named."""
    start, stop = clock.launches.get("start"), clock.launches.get("stop")
    if not start or not stop:
        return []
    counted = {k: stop[k] - start.get(k, 0) for k in stop}
    seen = trace.counted_launches(events)
    off = {k: (seen.get(k, 0), counted[k]) for k in counted
           if seen.get(k, 0) != counted[k]}
    if off:
        return [f"note: the trace's kernel counts differ from the program's "
                f"launch counters (trace, counters): {off}"]
    return [f"trace kernel counts agree with the launch counters: "
            f"{ {k: v for k, v in counted.items() if v} }"]


def forbidden_modules():
    """Top-level names of loaded modules that must not be."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))
