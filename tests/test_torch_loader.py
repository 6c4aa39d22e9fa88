"""The port's loader look-ahead (gantts_tpu_torch/data.py, ``BatchIterator``
with workers), on the CPU.

With ``num_workers`` 1 and 2: epochs bit-equal to the synchronous loader's
(``num_workers=0``), shuffled and not; the next epoch's first batches
requested before its ``iter()``, within the window ``max(2 * num_workers,
cache_size // batch_size)`` and never past the next epoch; an epoch
abandoned after one batch, an epoch set by hand and a swapped dataset, each
followed by an epoch equal to the synchronous loader's; ``close()``, the
loader's collection and the interpreter's exit leave no worker assembling
beyond the batch in hand.
"""

import gc
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from os.path import dirname

import numpy as np
import pytest

from gantts_tpu_torch.data import BatchIterator

REPO = dirname(dirname(os.path.abspath(__file__)))
WORKERS = [1, 2]


class Recorded:
    """``n`` items of 3-19 frames (x: the index, y: its negative) that
    record each ``__getitem__`` call and take ``delay`` seconds each."""

    def __init__(self, n, seed=0, delay=0.0):
        self.lengths = np.random.RandomState(seed).randint(3, 20, n)
        self.seed, self.delay, self.calls = seed, delay, []

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, j):
        self.calls.append(int(j))
        if self.delay:
            time.sleep(self.delay)
        T = self.lengths[j]
        return (np.full((T, 3), j + self.seed / 10, np.float64),
                np.full((T, 2), -j, np.float64))


def _order(n, B, epoch, shuffle=True, seed=1234):
    """The items of each batch of an epoch, as the reference shuffles."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    return [list(order[i: i + B]) for i in range(0, n, B)]


def _equal(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(u, v) and u.dtype == v.dtype for u, v in zip(x, y))
        for x, y in zip(a, b))


def _wait_for(cond, timeout=20.0):
    t = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t, "timed out"
        time.sleep(0.005)
    time.sleep(0.05)  # nothing more arrives after it


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("workers", WORKERS)
def test_epochs_equal_synchronous(workers, shuffle):
    """Three consecutive epochs, item cache partly full, the window from
    ``cache_size`` (5 // 3 = 1, so 2 a worker): the synchronous loader's
    batches, bit for bit."""
    kw = dict(batch_size=3, shuffle=shuffle, bucket_multiple=4, seed=7,
              cache_size=5)
    ours = BatchIterator(Recorded(11), num_workers=workers, **kw)
    sync = BatchIterator(Recorded(11), num_workers=0, **kw)
    try:
        for _ in range(3):
            batches = list(ours)
            assert len(batches) == 4 and batches[-1][2][-1] == 0
            assert _equal(batches, list(sync))
    finally:
        ours.close()


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("workers", WORKERS)
def test_look_ahead_requests(workers, B):
    """With no item cache the window is 2 a worker.  Before each ``iter()``
    the dataset has been asked for every earlier epoch's items and for
    the first min(W, batches) batches of the coming epoch, and no more;
    while an epoch runs, for at most W batches beyond those handed out,
    and for none of the next epoch's before its own last is handed out.
    B = 2: 6 batches an epoch, the window binds; B = 4 with 2 workers: 3
    batches, the next epoch's end binds."""
    n, W = 11, 2 * workers
    ds = Recorded(n)
    loader = BatchIterator(ds, B, True, num_workers=workers, cache_size=0)
    epochs = [_order(n, B, e) for e in range(4)]
    plan = [idx for batches in epochs for idx in batches]
    try:
        assert ds.calls == []
        handed = 0
        for e in range(3):
            if e:
                ahead = min(W, len(epochs[e]))
                want = [j for idx in plan[:handed + ahead] for j in idx]
                _wait_for(lambda: len(ds.calls) >= len(want))
                if workers == 1:
                    assert ds.calls == want
                else:
                    assert Counter(ds.calls) == Counter(want)
            ends = [sum(len(b) for b in epochs[:k]) for k in (e + 1, e + 2)]
            for k, batch in enumerate(loader):
                handed += 1
                last = k == len(epochs[e]) - 1
                inside = min(handed + W, ends[last])
                assert len(ds.calls) <= sum(len(idx)
                                            for idx in plan[:inside])
                assert sorted(batch[0][:, 0, 0][batch[2] > 0]) == sorted(
                    plan[handed - 1])
    finally:
        loader.close()


@pytest.mark.parametrize("workers", WORKERS)
def test_window_from_cache_size(workers):
    """cache_size 12 at batch 2: ``iter()`` submits 6 batches, whatever
    the worker count, and the dataset is asked for their items alone."""
    ds = Recorded(40)
    loader = BatchIterator(ds, 2, True, num_workers=workers, cache_size=12)
    try:
        it = iter(loader)
        want = [j for idx in _order(40, 2, 0)[:6] for j in idx]
        _wait_for(lambda: len(ds.calls) >= len(want))
        assert Counter(ds.calls) == Counter(want)
        assert len(list(it)) == 20
    finally:
        loader.close()


@pytest.mark.parametrize("workers", WORKERS)
def test_abandoned_epoch_and_changes(workers):
    """An epoch left after one batch, an epoch set by hand and a dataset
    swapped for another: each next epoch equals the synchronous loader's
    (the pending batches of the epoch before are not handed out)."""
    kw = dict(batch_size=3, shuffle=True, bucket_multiple=4, cache_size=0)
    ours = BatchIterator(Recorded(11), num_workers=workers, **kw)
    sync = BatchIterator(Recorded(11), num_workers=0, **kw)
    try:
        assert _equal(list(ours), list(sync))
        assert _equal([next(iter(ours))], [next(iter(sync))])  # abandoned
        assert _equal(list(ours), list(sync))
        ours.epoch = sync.epoch = 7
        assert _equal(list(ours), list(sync))
        ours.dataset = sync.dataset = Recorded(11, seed=1)
        assert _equal(list(ours), list(sync))
        assert ours.epoch == sync.epoch == 9
    finally:
        ours.close()


def _new_workers(before):
    return [t for t in threading.enumerate() if t not in before
            and t.name.startswith("BatchIterator")]


@pytest.mark.parametrize("how", ["close", "collected"])
@pytest.mark.parametrize("workers", WORKERS)
def test_no_worker_left(workers, how):
    """40 one-item batches pending at 0.1 s an item: after ``close()``, or
    once the loader and its iterator are dropped, every worker ends having
    asked for at most the item it had in hand."""
    before = set(threading.enumerate())
    ds = Recorded(40, delay=0.1)
    loader = BatchIterator(ds, 1, False, num_workers=workers, cache_size=40)
    it = iter(loader)
    next(it)
    threads = _new_workers(before)
    assert len(threads) == workers
    asked = len(ds.calls)
    if how == "close":
        loader.close()
        assert not any(t.is_alive() for t in threads)
    else:
        del it, loader
        gc.collect()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    assert len(ds.calls) <= asked + workers < 40


EXIT = """
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from gantts_tpu_torch.data import BatchIterator

class Slow:
    def __len__(self):
        return 40

    def __getitem__(self, j):
        sys.stdout.write("item\\n")  # one write: no thread splits it
        sys.stdout.flush()
        time.sleep(0.1)
        return np.zeros((4, 2)), np.zeros((4, 2))

loader = BatchIterator(Slow(), 1, False, num_workers={workers},
                       cache_size=40)
it = iter(loader)
next(it)
sys.stdout.write("end\\n")
sys.stdout.flush()
"""


@pytest.mark.parametrize("workers", WORKERS)
def test_interpreter_exit(workers):
    """A process that ends with 39 batches pending exits after the items
    in hand, quietly: at most one a worker started after its last
    statement."""
    done = subprocess.run(
        [sys.executable, "-c", EXIT.format(repo=REPO, workers=workers)],
        capture_output=True, text=True, timeout=60, check=True)
    assert done.stderr == ""
    lines = done.stdout.split()
    assert "end" in lines
    assert lines[lines.index("end") + 1:].count("item") <= workers
