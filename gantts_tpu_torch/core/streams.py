"""Multi-stream feature arithmetic (counterpart of
gantts_tpu/core/streams.py).  Stream boundaries are Python ints."""

from __future__ import annotations

import numpy as np
import torch

from gantts_tpu_torch.core.windows import delta_features


def get_static_stream_sizes(stream_sizes, has_dynamic_features, num_windows):
    """Static dimension of each stream."""
    static_stream_sizes = np.array(stream_sizes)
    dyn = np.asarray(has_dynamic_features)
    static_stream_sizes[dyn] = static_stream_sizes[dyn] // num_windows
    return static_stream_sizes


def _starts(stream_sizes):
    return np.hstack(([0], np.cumsum(stream_sizes)[:-1])).astype(int)


def select_streams(inputs, stream_sizes=(60, 1, 1, 1),
                   streams=(True, True, True, True)):
    """Concatenate the enabled streams of (..., T, D) features."""
    ret = [inputs[..., s:s + size]
           for s, size, enabled in zip(_starts(stream_sizes), stream_sizes,
                                       streams)
           if enabled]
    return torch.cat(ret, dim=-1)


def get_static_features(inputs, num_windows, stream_sizes=(180, 3, 1, 3),
                        has_dynamic_features=(True, True, False, True),
                        streams=(True, True, True, True)):
    """Static blocks of static+dynamic features."""
    D = inputs.shape[-1]
    if stream_sizes is None or (len(stream_sizes) == 1
                                and has_dynamic_features[0]):
        return inputs[..., :D // num_windows]
    if len(stream_sizes) == 1 and not has_dynamic_features[0]:
        return inputs
    ret = []
    for s, size, v, enabled in zip(_starts(stream_sizes), stream_sizes,
                                   has_dynamic_features, streams):
        if enabled:
            ret.append(inputs[..., s:s + (size // num_windows if v else size)])
    return torch.cat(ret, dim=-1)


def recompute_delta_features(Y, windows, stream_sizes=(180, 3, 1, 3),
                             has_dynamic_features=(True, True, False, True)):
    """Re-derive each dynamic stream's delta blocks from its static block of
    a (T, D) numpy array (host-side, in the data pipeline after
    normalization); returns a modified copy."""
    Y = np.array(Y, copy=True)
    static_sizes = get_static_stream_sizes(stream_sizes, has_dynamic_features,
                                           len(windows))
    for s, size, static_size, dyn in zip(_starts(stream_sizes), stream_sizes,
                                         static_sizes, has_dynamic_features):
        if dyn:
            Y[:, s:s + size] = delta_features(Y[:, s:s + static_size],
                                              windows)
    return Y
