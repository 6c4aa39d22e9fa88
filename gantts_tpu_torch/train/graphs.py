"""K consecutive training steps as one CUDA graph replay (the port's
counterpart of the JAX package's ``GanTrainer.multi_step_fn``).

A ``StepGraph`` is captured once for each (train or test phase, the stacked
batch's shapes, K) of a trainer, whose configuration (the compute dtype,
the step's flags) is fixed: K calls of ``GanTrainer.step`` on the slices
of static stacked inputs (xs (K, B, T, ·), ys, lengths (K, B), the noise
zs), one static adversarial weight and the MLPG matrix R of the bucket
length, with the models' parameters and the optimizers' state updated in
place as the eager steps update them.  A replay copies the caller's stacked
batch into the static inputs (``non_blocking`` from pinned host staging, or
on the device), replays, and returns a copy of the K steps' scalars, so
that the next replay (of this graph or of another one sharing its memory)
cannot overwrite what the caller holds.  While the loop's phase records
(``tracing.py``), a replay is the span ``graphs.replay``.

What makes the replay equal to K eager steps, bit for bit:

  * the optimizers keep their learning rate and step count in device
    scalars (train/optim.py): a replay reads the values of its moment;
  * the dropout ``torch.Generator`` is registered with each graph, so a
    replay draws the masks the eager steps would draw from its state and
    advances it as they would;
  * the states a step reads across replays (parameters, optimizer state,
    R, the generator) were made by eager steps before the capture; the
    capture's own allocations (activations, gradients, the stacked
    scalars) come from one memory pool that all of a trainer's graphs
    share, which is safe because replays run one at a time on the
    caller's stream and each returns a copy of its outputs.

The kernels' launch counters count when a wrapper is called, and a
capture calls each wrapper once per launch it records without launching
anything.  So the capture's counts are taken back out, the captured graph's
kernel nodes are read from the graph itself (``kernel_nodes``: its DOT
description, by kernel function), the capture raises unless they equal
the wrapper calls, and every replay adds those node counts.

A capture collects unreachable objects first and none while it runs: a
CUDA graph destroyed inside another graph's capture (one that only a
reference cycle kept alive, such as a dropped trainer's) invalidates that
capture.

Nothing falls back: a failed capture or replay raises.  The JAX package
retries a rejected fused program in ``lax.scan`` form
(gantts_tpu/train/loop.py), an answer to a TPU compiler's program-size
limit that a CUDA graph does not meet, so that form is not ported.
"""

from __future__ import annotations

import gc
import os
import re
import tempfile
import time
import warnings

import torch

from gantts_tpu_torch import tracing
from gantts_tpu_torch.kernels import launch_counts

# The kernel function that each counted wrapper launches once a call, by
# the counter's name (the f32 GEMM's split-K sum is a second kernel of the
# same call, not counted)
KERNEL_FUNCTIONS = {name: re.compile(pattern) for name, pattern in (
    ("sru_proj_gemm", r"proj_gemm_(?:f32|bf16)(?!_split)"),
    ("sru_fwd_scan", r"sru_fwd_scan_kernel"),
    ("sru_bwd_scan", r"sru_bwd_scan_kernel"),
    ("lstm_fwd_scan", r"lstm_fwd_(?:cluster_|flag_)?kernel"),
    ("lstm_bwd_scan", r"lstm_bwd_(?:cluster_|flag_)?kernel"),
    ("linear_recurrence_fwd", r"linear_recurrence_fwd_kernel"),
    ("linear_recurrence_bwd", r"linear_recurrence_bwd_kernel"))}
_NODE = re.compile(r'^\s*"graph_\d+_node_\d+"\s*\[', re.MULTILINE)


def kernel_nodes(graph):
    """The kernel nodes of ``graph`` (a ``torch.cuda.CUDAGraph(keep_graph=
    True)`` after its capture) by KERNEL_FUNCTIONS' names, read from the
    graph's DOT description; the executable graph is not touched."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torch announces the dump
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("torch wrote no description of the graph")
        with open(path) as f:
            text = f.read()
    starts = [m.start() for m in _NODE.finditer(text)] + [len(text)]
    nodes = [text[a:b] for a, b in zip(starts, starts[1:])]
    if not nodes:
        raise RuntimeError("the graph's description holds no node")
    counts = {name: 0 for name in KERNEL_FUNCTIONS}
    for node in nodes:
        if "KERNEL" in node:
            for name, pattern in KERNEL_FUNCTIONS.items():
                counts[name] += bool(pattern.search(node))
    return {name: n for name, n in counts.items() if n}


def _optimizers(gstate, dstate):
    return (gstate.optimizer, dstate.optimizer)


class StepGraph:
    """One captured dispatch of K steps.  ``capture_seconds``: the host
    time the capture took; ``launches``: the kernel launches one replay
    makes, by kernel (the graph's kernel nodes); ``count_seconds``: the
    host time reading them took."""

    def __init__(self, graphs, trainer, gstate, dstate, xs, ys, lengths, R,
                 generator, train, zs):
        dev = trainer.device
        self.states = (gstate, dstate)  # not the trainer: it holds this
        self.versions = [opt.version for opt in _optimizers(gstate, dstate)]
        self.R, self.generator = R, generator
        self.xs = torch.empty(xs.shape, dtype=xs.dtype, device=dev)
        self.ys = torch.empty(ys.shape, dtype=ys.dtype, device=dev)
        self.lengths = torch.empty(lengths.shape, dtype=lengths.dtype,
                                   device=dev)
        self.zs = (None if zs is None else
                   torch.empty(zs.shape, dtype=zs.dtype, device=dev))
        self.adv_w = torch.zeros((), dtype=torch.float32, device=dev)
        self._fill(xs, ys, lengths, zs, 0.0)
        K = xs.shape[0]

        before = dict(launch_counts)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            self.graph.register_generator_state(generator)
        for opt in _optimizers(gstate, dstate):
            opt.zero_grad()
        t0 = time.perf_counter()
        gc.collect()  # unreachable graphs are destroyed here, not in there
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=graphs.pool,
                                  stream=graphs.stream):
                outs = [trainer.step(
                    gstate, dstate, self.xs[k], self.ys[k], self.lengths[k],
                    R, self.adv_w, generator=generator, train=train,
                    z=None if zs is None else self.zs[k])[2]
                    for k in range(K)]
                self.outs = {key: torch.stack([o[key] for o in outs])
                             for key in outs[0]}
        finally:
            if collecting:
                gc.enable()
        self.graph.instantiate()
        self.capture_seconds = time.perf_counter() - t0
        for opt in _optimizers(gstate, dstate):
            opt.zero_grad()  # the capture's gradients live in the pool
        called = {name: n - before[name] for name, n in launch_counts.items()
                  if n != before[name]}
        launch_counts.update(before)  # the capture launched nothing
        t0 = time.perf_counter()
        self.launches = kernel_nodes(self.graph)
        self.count_seconds = time.perf_counter() - t0
        if self.launches != called:
            raise RuntimeError(
                f"the captured graph holds the kernel nodes {self.launches}"
                f", its capture called the wrappers {called} times")

    def _fill(self, xs, ys, lengths, zs, adv_w):
        for static, given in ((self.xs, xs), (self.ys, ys),
                              (self.lengths, lengths), (self.zs, zs)):
            if static is not None:
                static.copy_(given, non_blocking=True)
        if isinstance(adv_w, torch.Tensor):
            self.adv_w.copy_(adv_w)
        else:
            self.adv_w.fill_(adv_w)

    def replay(self, gstate, dstate, xs, ys, lengths, R, adv_w, generator,
               zs):
        if gstate is not self.states[0] or dstate is not self.states[1] or \
                generator is not self.generator:
            raise ValueError("a step graph replays only with the states and "
                             "the generator it was captured with")
        if [opt.version for opt in _optimizers(gstate, dstate)] \
                != self.versions:
            raise ValueError("an optimizer's state was loaded after this step "
                             "graph was captured")
        if (R is None) != (self.R is None) or (
                R is not None and R.data_ptr() != self.R.data_ptr()):
            raise ValueError("a step graph replays only with the MLPG matrix "
                             "it was captured with")
        with tracing.span("graphs.replay"):
            self._fill(xs, ys, lengths, zs, adv_w)
            self.graph.replay()
            for name, n in self.launches.items():
                launch_counts[name] += n
            return {key: v.clone() for key, v in self.outs.items()}


class StepGraphs:
    """The step graphs of one trainer, by (phase, shapes, K), in one memory
    pool, captured on one side stream."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs = {}

    def run(self, trainer, gstate, dstate, xs, ys, lengths, R, adv_w,
            generator, train, zs):
        """Replay the graph of this dispatch, capturing it first if it is
        new.  Returns the K steps' scalars, each (K,)."""
        key = (bool(train), tuple(xs.shape), tuple(ys.shape),
               None if zs is None else tuple(zs.shape))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(
                self, trainer, gstate, dstate, xs, ys, lengths, R, generator,
                bool(train), zs)
        return graph.replay(gstate, dstate, xs, ys, lengths, R, adv_w,
                            generator, zs)
