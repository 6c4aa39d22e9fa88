"""Host data pipeline: .npy discovery, the deterministic split, normalization,
bucketed batching (the port's own copy of gantts_tpu/data/__init__.py).

  * ``NPYDataSource`` keeps the reference's split: sorted ``*.npy``, the last
    5 files are the held-out test set, the remainder is split train/val as
    sklearn's ``train_test_split(test_size=0.112, random_state=1234)`` splits
    it.  The port reproduces that split with NumPy alone (``split_files``);
    tests/test_torch_train.py holds it to sklearn's, file for file.
  * the datasets normalize per item like the reference's VCDataset and
    TTSDataset, including the optional delta re-derivation.
  * ``BatchIterator`` pads each batch's time axis up to a bucket multiple and
    the trailing batch with zero-length rows, and shuffles with
    ``RandomState(seed + epoch)``: the same batches, in the same order, as
    the JAX package's.  Masked losses make both paddings inert for every
    per-frame term; MLPG, a global banded solve, sees the zero padding in the
    last few valid frames of each utterance, as in the reference, which pads
    to the batch maximum.  With workers it assembles ahead across the end of
    an epoch, up to ``cache_size // batch_size`` batches (at least two a
    worker), so that an epoch's first batches are ready when it begins.
"""

from __future__ import annotations

import math
import os
import sys
import threading
import weakref
from os.path import join, splitext

import numpy as np

from gantts_tpu_torch import tracing

TEST_SIZE = 0.112      # reference train.py:64
RANDOM_STATE = 1234    # reference train.py:65


def split_files(files):
    """(train, test) as ``sklearn.model_selection.train_test_split(files,
    test_size=TEST_SIZE, random_state=RANDOM_STATE)`` returns them:
    ShuffleSplit puts the first ceil(TEST_SIZE n) entries of
    ``RandomState(RANDOM_STATE).permutation(n)`` in test and the next
    n - n_test in train."""
    n = len(files)
    n_test = math.ceil(TEST_SIZE * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(
            f"With n_samples={n} and test_size={TEST_SIZE}, the resulting "
            "train set would be empty")
    perm = np.random.RandomState(RANDOM_STATE).permutation(n)
    return ([files[i] for i in perm[n_test:]],
            [files[i] for i in perm[:n_test]])


class NPYDataSource:
    """Deterministic 3-way split over a directory of per-utterance .npy
    files."""

    def __init__(self, dirname, train=True, max_files=None, test=False):
        self.dirname = dirname
        self.train = train
        self.test = test
        self.max_files = max_files

    def collect_files(self):
        npy_files = sorted(join(self.dirname, f)
                           for f in os.listdir(self.dirname)
                           if splitext(f)[-1] == ".npy")
        # the final 5 files (sorted order) are the held-out eval set; the
        # remainder is split train/val
        if self.test:
            return npy_files[len(npy_files) - 5:]
        npy_files = npy_files[: len(npy_files) - 5]
        if self.max_files is not None and self.max_files > 0:
            npy_files = npy_files[: self.max_files]
        train_files, test_files = split_files(npy_files)
        return train_files if self.train else test_files

    def load(self):
        return [np.load(f) for f in self.collect_files()]


class VCDataset:
    """Pooled z-score normalization of parallel X/Y."""

    def __init__(self, X, Y, data_mean, data_std):
        self.X, self.Y = X, Y
        self.data_mean = data_mean
        self.data_std = data_std

    def __getitem__(self, idx):
        from gantts_tpu_torch.preprocessing import scale

        x = scale(self.X[idx], self.data_mean, self.data_std)
        y = scale(self.Y[idx], self.data_mean, self.data_std)
        return x, y

    def __len__(self):
        return len(self.X)


class TTSDataset:
    """Min-max (0.01, 0.99) inputs + z-score outputs."""

    def __init__(self, X, Y, X_data_min, X_data_max, Y_data_mean, Y_data_std,
                 recompute_deltas=False, windows=None, stream_sizes=None,
                 has_dynamic_features=None):
        from gantts_tpu_torch.preprocessing import minmax_scale_params

        self.X, self.Y = X, Y
        self.X_data_min, self.X_data_scale = minmax_scale_params(
            X_data_min, X_data_max, feature_range=(0.01, 0.99))
        self.Y_data_mean = Y_data_mean
        self.Y_data_std = Y_data_std
        self.recompute_deltas = recompute_deltas
        self.windows = windows
        self.stream_sizes = stream_sizes
        self.has_dynamic_features = has_dynamic_features

    def __getitem__(self, idx):
        from gantts_tpu_torch.core.streams import recompute_delta_features
        from gantts_tpu_torch.preprocessing import minmax_scale, scale

        x = minmax_scale(self.X[idx], min_=self.X_data_min,
                         scale_=self.X_data_scale, feature_range=(0.01, 0.99))
        y = scale(self.Y[idx], self.Y_data_mean, self.Y_data_std)
        # the static-delta relationship after normalization, for the MSE +
        # MGE combined loss
        if self.recompute_deltas:
            y = recompute_delta_features(
                y, self.windows, self.stream_sizes, self.has_dynamic_features)
        return x, y

    def __len__(self):
        return len(self.X)


def round_up(n, multiple):
    return -(-n // multiple) * multiple


class BatchIterator:
    """Shuffled, bucket-padded batches of (x, y, lengths) float32 arrays.

    Each epoch: optionally shuffle (``RandomState(seed + epoch)``), group
    into fixed-size batches, pad the time axis to ``round_up(batch_max_len,
    bucket_multiple)`` and pad the trailing batch with zero-length rows up to
    ``batch_size``.  ``epoch`` is the epoch that the next ``iter()`` yields.
    ``cache_size > 0`` memoizes up to that many normalized items across
    epochs.

    ``num_workers > 0`` assembles batches in a thread pool that the
    iterator keeps from one epoch to the next, in the same order and with
    the same values.  Its window of submitted batches not yet handed out
    holds ``max(2 * num_workers, cache_size // batch_size)``: the memory
    granted to cached items also bounds the batches held ahead.  Once an
    epoch's last batch is handed out the window runs on into the next epoch
    (never further), so that the next ``iter()`` finds the start of its
    epoch assembled, while the caller still works on the epoch before.  An
    ``iter()`` of another epoch than the one assembled ahead, or after a
    change of the dataset or of a setting, cancels what is pending and
    starts afresh.  ``close()``, the iterator's collection and the
    interpreter's exit cancel the pending batches; the worker finishes the
    one in hand.
    """

    def __init__(self, dataset, batch_size, shuffle, seed=1234,
                 bucket_multiple=32, num_workers=0, cache_size=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.bucket_multiple = bucket_multiple
        self.num_workers = num_workers
        self.cache_size = cache_size
        self._cache = {}
        self.epoch = 0
        self._pool = None
        self._pending = {}   # (epoch, position) -> future, submitted in order
        self._cursor = None  # (epoch, position) of the next batch to submit
        self._plan = None    # the settings the pending batches were made by
        self._next_open = False  # whether the cursor may enter the next epoch
        self._orders = {}    # the latest iter()'s epoch and the next: batches

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __del__(self):
        # at the interpreter's exit _cancel_at_exit has done it, and the
        # executor's module may be torn down already
        if self._pool is not None and not sys.is_finalizing():
            self._pool.shutdown(wait=False, cancel_futures=True)

    def close(self):
        """Cancels the batches assembled ahead and ends the worker threads
        (after the batch in hand).  A later ``iter()`` starts new ones."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._pending.clear()

    def _batches(self, epoch):
        """The item indices of each of the epoch's batches, in order."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + epoch)
            rs.shuffle(order)
        B = self.batch_size
        return [order[i: i + B] for i in range(0, n, B)]

    def _parts(self):
        """What assembling a batch reads: ``_assemble``'s arguments."""
        return (self.dataset, self._cache, self.cache_size, self.batch_size,
                self.bucket_multiple)

    def _assemble_here(self, idx):
        """A batch assembled on the caller's thread, which waits for it."""
        tracing.count("loader.fetch", False)
        with tracing.span("loader.wait"), tracing.span("loader.assemble"):
            return _assemble(idx, *self._parts())

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        if self.num_workers <= 0:
            tracing.count("loader.ahead", 0)
            return (self._assemble_here(idx) for idx in self._batches(epoch))
        self._take_over(epoch)
        tracing.count("loader.ahead", sum(f.done() for f in
                                          self._pending.values()))
        self._top_up()
        return self._prefetched(epoch, self._orders[epoch])

    def _take_over(self, epoch):
        """Keeps the pending batches if they are ``epoch``'s, from its first
        on, made with the settings the iterator has now; cancels the
        rest."""
        plan = self._parts() + (self.seed, self.shuffle)
        same = self._plan is not None and plan[0] is self._plan[0] and \
            plan[1:] == self._plan[1:]
        self._plan = plan
        ours = [k for k in self._pending if k[0] == epoch]
        keep = same and ours == [(epoch, p) for p in range(len(ours))]
        for k in list(self._pending):
            if not keep or k[0] != epoch:
                self._pending.pop(k).cancel()
        self._orders = {e: self._batches(e) for e in (epoch, epoch + 1)}
        self._cursor = (epoch, len(self._pending))
        self._next_open = False
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                self.num_workers, thread_name_prefix="BatchIterator")
            # the hooks that run before the interpreter joins non-daemon
            # threads, newest first: concurrent.futures' join runs after
            threading._register_atexit(_cancel_at_exit,
                                       weakref.ref(self._pool))

    def _top_up(self):
        """Submits batches, in the order they are handed out, until the
        window is full, the latest ``iter()``'s epoch is all submitted and
        its last batch not yet handed out, or the epoch after it is all
        submitted."""
        if self._pool is None:  # closed
            return
        window = max(2 * self.num_workers,
                     self.cache_size // self.batch_size)
        epoch, p = self._cursor
        while len(self._pending) < window:
            batches = self._orders[epoch]
            if p == len(batches):
                if epoch == self.epoch or not self._next_open:
                    break
                epoch, p = epoch + 1, 0
                continue
            self._pending[epoch, p] = self._pool.submit(
                _assemble_ahead, weakref.ref(self), batches[p])
            p += 1
        self._cursor = (epoch, p)

    def _prefetched(self, epoch, batches):
        for p, idx in enumerate(batches):
            fut = self._pending.pop((epoch, p), None)
            # None: closed, or a later iter() took the epoch's batches
            out = self._assemble_here(idx) if fut is None else _fetch(fut)
            # The next epoch's batches wait for this one's last: until then
            # the caller stages the batches it takes, often while the card
            # waits for them, and a worker running beside those copies slows
            # them several times over.
            if p == len(batches) - 1:
                self._next_open = True
            self._top_up()
            yield out


def _assemble(idx, dataset, cache, cache_size, batch_size, multiple):
    """One batch of the items ``idx``, each normalized item memoized in
    ``cache`` while it holds fewer than ``cache_size``."""
    items = []
    for j in map(int, idx):
        item = cache.get(j) if cache_size > 0 else None
        if item is None:
            item = dataset[j]
            if cache_size > 0 and len(cache) < cache_size:
                cache[j] = item
        items.append(item)
    lengths = np.array([len(x) for x, _ in items], dtype=np.int32)
    T = round_up(int(lengths.max()), multiple)
    Dx = items[0][0].shape[-1]
    Dy = items[0][1].shape[-1]
    x = np.zeros((batch_size, T, Dx), dtype=np.float32)
    y = np.zeros((batch_size, T, Dy), dtype=np.float32)
    for k, (xi, yi) in enumerate(items):
        x[k, : len(xi)] = xi
        y[k, : len(yi)] = yi
    full_lengths = np.zeros(batch_size, dtype=np.int32)
    full_lengths[: len(lengths)] = lengths
    return x, y, full_lengths


def _assemble_ahead(ref, idx):
    """A worker's batch of ``ref()``'s items ``idx``.  The worker holds the
    iterator only while it reads its parts, so that an iterator with
    batches pending can be collected."""
    loader = ref()
    if loader is None:
        return None
    parts = loader._parts()
    del loader
    with tracing.worker_span("loader.assemble"):
        return _assemble(idx, *parts)


def _cancel_at_exit(pool_ref):
    """At the interpreter's exit, before it joins the worker threads: the
    pending batches are cancelled, so that it waits for the ones in hand
    alone."""
    pool = pool_ref()
    if pool is not None:
        pool.shutdown(wait=False, cancel_futures=True)


def _fetch(fut):
    """A batch from the worker's future, counted (``loader.fetch``: whether
    it was ready) and its wait spanned where it was not, while the loop's
    phase records."""
    if tracing.RECORD.phase is not None:
        ready = fut.done()
        tracing.count("loader.fetch", ready)
        if not ready:
            with tracing.span("loader.wait"):
                return fut.result()
    return fut.result()
