"""Spans and counters of the port's host pipeline, kept while a torch
profiler records.

The training loop (train/loop.py) runs each phase inside ``phase(name)``,
which asks once, on the loop's thread, whether a torch profiler records
there.  While one does, ``span(name)`` opens a ``record_function`` range of
that name (the profiler's trace and its idle-gap naming see it) and appends
a ``Span`` to ``RECORD``: name, phase, thread, start and end on
``time.perf_counter_ns``, and the enclosing span of the same thread;
``count(name, value)`` appends a ``Count`` (name, phase, value).  While none does, each is one
branch: no range, no append, no clock read.

``RECORD`` holds the latest profiled epoch alone: the first phase that
finds a profiler recording after one that found none empties it.  It is
module state because its readers run in the process after the loop:
``export_worker_spans``, and the benchmark's per-layer metrics, which
read the record's fields from the loaded module and keep their own
arithmetic, so that this module cannot move them.

A profiler started on one thread does not trace ranges opened on another
(torch.profiler without ``profile_all_threads``), so a loader's worker
spans are in the record alone.  The loop's thread's spans are in both:
``clock_offset`` pairs them and gives the trace's clock minus the record's,
so that every span of the record can be placed on the trace's timeline
(``trace_us``).

The spans (the benchmark's readers in ``perfbench/metrics/``):

  ``loader.assemble``  one batch assembled (data.BatchIterator), on the
                       worker's thread or, without workers, the loop's
  ``loader.wait``      the loop's thread waiting for a batch not yet
                       assembled
  ``loop.gather``      one dispatch group pulled out of ``dispatch_groups``
  ``loop.stage``       the group's arrays stacked into (pinned) host memory
                       and, for an eager step, their copy enqueued
  ``step.launch``      one eager ``trainer.step`` call
  ``graphs.replay``    one ``StepGraph.replay``: fill, replay, output clone
  ``loop.phase_end``   the phase's one synchronisation and its logging
  ``gan_dispatch:K``   one dispatch of K steps (tools/torch_trace_report.py,
                       the benchmark's ``graphs.fused_share``)

and the counter ``loader.fetch`` (value: whether the fetched batch was
already assembled).
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from dataclasses import dataclass


@dataclass
class Span:
    name: str
    phase: str
    tid: int
    start: int  # ns, time.perf_counter_ns
    end: int | None = None
    parent: int | None = None  # index in RECORD.spans, same thread


@dataclass
class Count:
    name: str
    phase: str
    value: object


class Record:
    """The spans and counts of the latest profiled epoch."""

    def __init__(self):
        self.spans, self.counts = [], []
        self.phase = None  # the loop's phase while it records, else None
        self.loop_tid = None
        self.last_recorded = False
        self._lock = threading.Lock()
        self._open = threading.local()

    def clear(self):
        with self._lock:
            self.spans, self.counts = [], []

    def _stack(self):
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def open(self, name, phase):
        stack = self._stack()
        s = Span(name, phase, threading.get_native_id(), 0,
                 parent=stack[-1] if stack else None)
        with self._lock:
            stack.append(len(self.spans))
            self.spans.append(s)
        s.start = time.perf_counter_ns()
        return s

    def close(self, s):
        s.end = time.perf_counter_ns()
        self._stack().pop()


RECORD = Record()
_CURRENT = object()


@contextlib.contextmanager
def phase(name):
    """The loop's phase ``name``: its spans record if a torch profiler
    records on this thread as it begins.  Yields whether they do."""
    import torch

    on = torch.autograd._profiler_enabled()
    if on:
        if not RECORD.last_recorded:
            RECORD.clear()
        RECORD.loop_tid = threading.get_native_id()
    RECORD.phase = name if on else None
    try:
        yield on
    finally:
        RECORD.phase = None
        RECORD.last_recorded = on


@contextlib.contextmanager
def _recorded(name, phase_name):
    import torch

    # the clock is read before the range opens and before it closes: the
    # range's own ends are taken with the interpreter lock released, and
    # retaking it may wait for another thread for milliseconds
    s = RECORD.open(name, phase_name)
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            RECORD.close(s)


def span(name, phase=_CURRENT):
    """A context of the host work ``name``, recorded while its phase
    records.  ``phase``: by default the loop's current phase
    (``RECORD.phase``); a thread other than the loop's passes what the
    loop's thread read, None when it does not record."""
    if phase is _CURRENT:
        phase = RECORD.phase
    if phase is None:
        return contextlib.nullcontext()
    return _recorded(name, phase)


def count(name, value):
    """Counts ``value`` under ``name`` while the loop's phase records."""
    if RECORD.phase is not None:
        RECORD.counts.append(Count(name, RECORD.phase, value))


# ---------------------------------------------------------------------------
# Reading the record beside a trace
# ---------------------------------------------------------------------------


def spans(name=None, phase=None, record=None):
    """The closed spans of ``record`` (by default ``RECORD``), by name and
    phase where given."""
    record = RECORD if record is None else record
    return [s for s in record.spans if s.end is not None
            and (name is None or s.name == name)
            and (phase is None or s.phase == phase)]


def clock_offset(events, record=None):
    """(offset, spread, pairs): the trace's clock minus the record's in us,
    the median over the loop's thread's spans (each a host range of the
    trace) paired in order with the trace's ``user_annotation`` ranges of
    the same names, and the distance between the quartiles of those
    differences; None without a pair.  A name whose count differs between
    the two is not paired."""
    record = RECORD if record is None else record
    ours, theirs = {}, {}
    for s in spans(record=record):
        if s.tid == record.loop_tid:
            ours.setdefault(s.name, []).append(s.start / 1e3)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in ours:
            theirs.setdefault(e["name"], []).append(e["ts"])
    diffs = []
    for name, starts in ours.items():
        ts = sorted(theirs.get(name, ()))
        if len(ts) == len(starts):
            diffs += [b - a for a, b in zip(sorted(starts), ts)]
    if not diffs:
        return None
    q = statistics.quantiles(diffs, n=4) if len(diffs) > 1 else diffs * 3
    return statistics.median(diffs), q[2] - q[0], len(diffs)


def trace_us(s, offset):
    """(start, end) of span ``s`` on the trace's clock, in us."""
    return s.start / 1e3 + offset, s.end / 1e3 + offset


def export_worker_spans(data, record=None):
    """Adds to a Chrome trace's JSON object (``data``) the record's spans
    of threads other than the loop's, as ``user_annotation`` events on
    their own threads on the trace's clock.  Returns how many it added."""
    record = RECORD if record is None else record
    events = data["traceEvents"]
    aligned = clock_offset([e for e in events if e.get("ph") == "X"],
                           record)
    if aligned is None:
        return 0
    offset = aligned[0]
    pid = next((e["pid"] for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"), 0)
    added = [s for s in spans(record=record) if s.tid != record.loop_tid]
    for tid in sorted({s.tid for s in added}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": "loader worker"}})
    for s in added:
        a, b = trace_us(s, offset)
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name,
                       "pid": pid, "tid": s.tid, "ts": a, "dur": b - a,
                       "args": {"phase": s.phase}})
    return len(added)
