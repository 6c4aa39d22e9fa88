"""DTW alignment of parallel utterance pairs (voice conversion front end):
the port's own copy of gantts_tpu/preprocessing/alignment.py.

Equivalent of ``nnmnkwii.preprocessing.alignment.DTWAligner``
(reference use: prepare_features_vc.py:19,102).  Exact dynamic-time-warping
(no radius approximation) with Euclidean frame distance, vectorized NumPy DP
rows; the per-utterance O(Tx*Ty) work runs in the C++ engine where it is
built.
"""

from __future__ import annotations

import numpy as np


def dtw_path(x, y):
    """Exact DTW path between (Tx, D) and (Ty, D) trajectories.

    Returns (path_x, path_y) index arrays of equal length, monotonically
    non-decreasing, covering (0,0) .. (Tx-1, Ty-1), using steps
    (1,0), (0,1), (1,1) and Euclidean local cost.

    The C++ engine's DP (cpp/frontend.cpp dtw_path) serves where it is
    built; ``_dtw_path_numpy`` is its oracle and the fallback.
    """
    from gantts_tpu_torch.frontend import native

    if native.available():
        return native.dtw_path(np.asarray(x, np.float64),
                               np.asarray(y, np.float64))
    return _dtw_path_numpy(x, y)


def _dtw_path_numpy(x, y):
    """Pure-NumPy oracle for ``dtw_path`` (environments without a C++
    toolchain; tests/test_torch_tts_io.py holds the engine to it)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    Tx, Ty = x.shape[0], y.shape[0]
    # Pairwise distances, (Tx, Ty), computed blockwise to bound memory.
    cost = np.empty((Tx, Ty), dtype=np.float64)
    step = max(1, int(2e7 // max(Ty, 1)))
    for i0 in range(0, Tx, step):
        i1 = min(Tx, i0 + step)
        d = x[i0:i1, None, :] - y[None, :, :]
        cost[i0:i1] = np.sqrt((d * d).sum(-1))

    # DP over accumulated cost; backpointers: 0=diag, 1=up(x-1), 2=left(y-1)
    acc_prev = np.empty(Ty, dtype=np.float64)
    acc_cur = np.empty(Ty, dtype=np.float64)
    bp = np.zeros((Tx, Ty), dtype=np.int8)
    acc_prev[0] = cost[0, 0]
    for j in range(1, Ty):
        acc_prev[j] = acc_prev[j - 1] + cost[0, j]
        bp[0, j] = 2
    for i in range(1, Tx):
        acc_cur[0] = acc_prev[0] + cost[i, 0]
        bp[i, 0] = 1
        # candidates for j >= 1
        diag = acc_prev[:-1]
        up = acc_prev[1:]
        stacked = np.stack([diag, up], axis=0)
        best = stacked.argmin(axis=0)
        best_val = stacked.min(axis=0)
        # left transitions must be resolved sequentially; do it in a tight loop
        row_cost = cost[i]
        for j in range(1, Ty):
            left = acc_cur[j - 1]
            if left < best_val[j - 1]:
                acc_cur[j] = left + row_cost[j]
                bp[i, j] = 2
            else:
                acc_cur[j] = best_val[j - 1] + row_cost[j]
                bp[i, j] = best[j - 1]  # 0=diag, 1=up
        acc_prev, acc_cur = acc_cur, acc_prev

    # Backtrack
    path_x, path_y = [Tx - 1], [Ty - 1]
    i, j = Tx - 1, Ty - 1
    while i > 0 or j > 0:
        move = bp[i, j]
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
        path_x.append(i)
        path_y.append(j)
    return np.array(path_x[::-1]), np.array(path_y[::-1])


class DTWAligner:
    """Align parallel (X, Y) corpora by exact DTW.

    ``transform((X, Y))`` takes two arrays of shape (N, T, D) (zero-padded;
    trailing all-zero frames are treated as padding) and returns warped
    (X', Y') with per-pair equal lengths, zero-padded back to a common max.
    Matches the call contract at prepare_features_vc.py:102.
    """

    def __init__(self, dist=None, verbose=0):
        self.verbose = verbose

    def transform(self, XY):
        X, Y = XY
        from gantts_tpu_torch.preprocessing import trim_zeros_frames

        aligned_x, aligned_y = [], []
        for x, y in zip(X, Y):
            x, y = trim_zeros_frames(x), trim_zeros_frames(y)
            px, py = dtw_path(x, y)
            aligned_x.append(x[px])
            aligned_y.append(y[py])
        max_len = max(a.shape[0] for a in aligned_x)
        D = aligned_x[0].shape[1]
        Xw = np.zeros((len(aligned_x), max_len, D), dtype=X[0].dtype)
        Yw = np.zeros((len(aligned_y), max_len, D), dtype=Y[0].dtype)
        for i, (a, b) in enumerate(zip(aligned_x, aligned_y)):
            Xw[i, : len(a)] = a
            Yw[i, : len(b)] = b
        return Xw, Yw
