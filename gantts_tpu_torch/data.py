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
    to the batch maximum.
"""

from __future__ import annotations

import math
import os
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
    ``batch_size``.  ``num_workers > 0`` assembles batches in a thread pool
    with a bounded prefetch window, in the same order; ``cache_size > 0``
    memoizes up to that many normalized items across epochs.
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

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _item(self, j):
        j = int(j)
        if self.cache_size <= 0:
            return self.dataset[j]
        item = self._cache.get(j)
        if item is None:
            item = self.dataset[j]
            if len(self._cache) < self.cache_size:
                self._cache[j] = item
        return item

    def _assemble(self, idx, phase=None):
        """One batch of the items ``idx``; ``phase``: the loop's recording
        phase, as the iterator read it (``tracing.span``)."""
        with tracing.span("loader.assemble", phase):
            B = self.batch_size
            items = [self._item(j) for j in idx]
            lengths = np.array([len(x) for x, _ in items], dtype=np.int32)
            T = round_up(int(lengths.max()), self.bucket_multiple)
            Dx = items[0][0].shape[-1]
            Dy = items[0][1].shape[-1]
            x = np.zeros((B, T, Dx), dtype=np.float32)
            y = np.zeros((B, T, Dy), dtype=np.float32)
            for k, (xi, yi) in enumerate(items):
                x[k, : len(xi)] = xi
                y[k, : len(yi)] = yi
            full_lengths = np.zeros(B, dtype=np.int32)
            full_lengths[: len(lengths)] = lengths
            return x, y, full_lengths

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            rs.shuffle(order)
        self.epoch += 1
        B = self.batch_size
        batches = [order[i: i + B] for i in range(0, n, B)]
        # whether this epoch records (tracing.py), asked on the loop's
        # thread and handed to the workers, which cannot ask
        phase = tracing.RECORD.phase
        if self.num_workers <= 0:
            for idx in batches:
                tracing.count("loader.fetch", False)
                with tracing.span("loader.wait"):
                    out = self._assemble(idx, phase)
                yield out
            return
        from concurrent.futures import ThreadPoolExecutor

        depth = max(2, 2 * self.num_workers)  # bounded prefetch window
        with ThreadPoolExecutor(self.num_workers) as ex:
            pending = [ex.submit(self._assemble, idx, phase)
                       for idx in batches[:depth]]
            for idx in batches[depth:]:
                out = _fetch(pending.pop(0), phase)
                pending.append(ex.submit(self._assemble, idx, phase))
                yield out
            for fut in pending:
                yield _fetch(fut, phase)


def _fetch(fut, phase):
    """A batch from the worker's future, counted (``loader.fetch``: whether
    it was ready) and its wait spanned where it was not, while ``phase``
    records."""
    if phase is not None:
        ready = fut.done()
        tracing.count("loader.fetch", ready)
        if not ready:
            with tracing.span("loader.wait"):
                return fut.result()
    return fut.result()
