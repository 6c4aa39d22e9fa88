"""The port's core math and metrics against the JAX package's, on the same
numpy inputs.  Elementwise and masked-sum code agrees to f32 rounding
(rtol 1e-6, atol 1e-6); the MLPG matmul sums 3T products in another order,
so it is held to atol 1e-5 on O(1) features."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gantts_tpu import hparams as jax_hparams
from gantts_tpu.core import masking as jm
from gantts_tpu.core import paramgen as jp
from gantts_tpu.core import streams as js
from gantts_tpu.core.windows import unit_variance_mlpg_matrix as jax_R
from gantts_tpu.train import metrics as jmet
from gantts_tpu_torch import _shared
from gantts_tpu_torch.core import masking, paramgen, streams
from gantts_tpu_torch.train import metrics

torch.set_num_threads(1)

STREAMS = (180, 3, 1, 3)
DYN = (True, True, False, True)


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _batch(seed, B=3, T=40, D=187):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, D).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    return rs, x, lengths


def test_shared_host_code_is_the_jax_packages():
    """The by-path loader gives the same bundles and the same MLPG matrix
    (the port solves with scipy, the JAX package with its C++ solver)."""
    assert (_shared.hparams.tts_acoustic.values().keys()
            == jax_hparams.tts_acoustic.values().keys())
    assert (_shared.hparams.tts_acoustic.generator_params
            == jax_hparams.tts_acoustic.generator_params)
    hp = _shared.hparams.tts_acoustic.copy().parse("batch_size=7")
    assert hp.batch_size == 7 and _shared.hparams.tts_acoustic.batch_size == 20
    W = _shared.hparams.tts_acoustic.windows
    np.testing.assert_allclose(_shared.unit_variance_mlpg_matrix(W, 50),
                               jax_R(W, 50), atol=1e-6)


def test_masking_matches_jax():
    _, x, lengths = _batch(0)
    y = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    T = x.shape[1]
    _close(masking.sequence_mask(torch.tensor(lengths), T),
           jm.sequence_mask(jnp.asarray(lengths), T), 0, 0)
    got = masking.masked_mse_loss(torch.tensor(x), torch.tensor(y),
                                  lengths=torch.tensor(lengths))
    ref = jm.masked_mse_loss(jnp.asarray(x), jnp.asarray(y),
                             lengths=jnp.asarray(lengths))
    _close(got, ref)
    # the denominator counts valid frames, not frames x dims
    m = (np.arange(T)[None] < lengths[:, None])[..., None]
    _close(got, np.sum(((x - y) * m) ** 2) / m.sum(), rtol=1e-5)


def test_streams_match_jax():
    _, x, _ = _batch(2)
    sizes = js.get_static_stream_sizes(STREAMS, DYN, 3)
    assert list(streams.get_static_stream_sizes(STREAMS, DYN, 3)) == \
        list(sizes) == [60, 1, 1, 1]
    _close(streams.get_static_features(torch.tensor(x), 3, STREAMS, DYN),
           js.get_static_features(jnp.asarray(x), 3, STREAMS, DYN), 0, 0)
    statics = x[..., :63]
    for sel in [(True, False, False, False), (True, True, False, True)]:
        _close(streams.select_streams(torch.tensor(statics), sizes, sel),
               js.select_streams(jnp.asarray(statics), sizes, sel), 0, 0)


def test_multi_stream_mlpg_matches_jax():
    _, x, _ = _batch(3)
    R = _shared.unit_variance_mlpg_matrix(_shared.hparams.tts_acoustic
                                          .windows, x.shape[1])
    got = paramgen.multi_stream_mlpg(torch.tensor(x), torch.tensor(R),
                                     STREAMS, DYN)
    ref = jp.multi_stream_mlpg(jnp.asarray(x), jnp.asarray(R), STREAMS, DYN)
    assert got.shape == (3, 40, 63)
    _close(got, ref, rtol=0, atol=1e-5)


def test_mlpg_exactness_invariant():
    """unit_variance_mlpg(R, delta_features(s)) recovers s: the R product
    runs in exact f32 (no TF32, no bf16)."""
    rs = np.random.RandomState(42)
    T, S = 40, 6
    s = rs.randn(T, S)
    u = _shared.delta_features(s, _shared.windows.DEFAULT_WINDOWS)
    R = torch.tensor(_shared.unit_variance_mlpg_matrix(
        _shared.windows.DEFAULT_WINDOWS, T))
    out = paramgen.unit_variance_mlpg(R, torch.tensor(u, dtype=torch.float32))
    assert out.shape == (T, S)
    assert np.abs(out.numpy() - s).max() < 1e-6 * max(np.abs(s).max(), 1)
    batched = paramgen.unit_variance_mlpg(
        R, torch.tensor(np.stack([u] * 2), dtype=torch.float32))
    assert torch.equal(batched[1], out)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("covoiced", [True, False])
def test_metrics_match_jax(covoiced):
    rs, _, lengths = _batch(4, D=1)
    B, T = 3, 40
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)[..., None]
    a = rs.randn(B, T, 59).astype(np.float32)
    b = rs.randn(B, T, 59).astype(np.float32)
    lf0, lf0_h = (rs.randn(B, T, 1).astype(np.float32) for _ in range(2))
    vuv = (rs.rand(B, T) > 0.5).astype(np.float32)
    vuv_h = (rs.rand(B, T) > 0.5).astype(np.float32)
    if not covoiced:
        vuv_h = 1.0 - vuv
    t = [torch.tensor(v) for v in (a, b, lf0, lf0_h, vuv, vuv_h, mask)]
    j = [jnp.asarray(v) for v in (a, b, lf0, lf0_h, vuv, vuv_h, mask)]
    _close(metrics.melcd(t[0], t[1], t[6]), jmet.melcd(j[0], j[1], j[6]),
           rtol=1e-5)
    _close(metrics.vuv_error(t[4], t[5], t[6]),
           jmet.vuv_error(j[4], j[5], j[6]))
    _close(metrics.mean_squared_error(t[0], t[1], t[6]),
           jmet.mean_squared_error(j[0], j[1], j[6]), rtol=1e-5)
    got = float(metrics.lf0_mean_squared_error(t[2], t[4], t[3], t[5], t[6]))
    ref = float(jmet.lf0_mean_squared_error(j[2], j[4], j[3], j[5], j[6]))
    assert np.isnan(got) == np.isnan(ref) == (not covoiced)
    if covoiced:
        _close(got, ref, rtol=1e-5)
