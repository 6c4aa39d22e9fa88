"""The port's stencil MLPG (core/fast_mlpg.py) against the JAX package's
stencil and against the dense R, on the same numpy inputs.

Every comparison is held to 2e-5 absolute, the limit of
tests/test_fast_mlpg.py: the stencil's truncation at W = 24 and float32
summation orders leave about 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gantts_tpu.core import fast_mlpg as JF
from gantts_tpu.core.paramgen import multi_stream_mlpg as jax_multi_stream
from gantts_tpu_torch.core import fast_mlpg as F
from gantts_tpu_torch.core.paramgen import (
    multi_stream_mlpg,
    unit_variance_mlpg,
)
from gantts_tpu_torch.core.windows import (
    DEFAULT_WINDOWS,
    unit_variance_mlpg_matrix,
)

torch.set_num_threads(1)

LIMIT = 2e-5
STREAMS = (180, 3, 1, 3)
DYN = (True, True, False, True)


def _means(rs, B, T, S, K=3):
    return rs.randn(B, T, K * S).astype(np.float32)


def _dense(means, T):
    R = torch.tensor(unit_variance_mlpg_matrix(DEFAULT_WINDOWS, T))
    return unit_variance_mlpg(R, torch.tensor(means))


@pytest.mark.parametrize("T", [98, 256, 1000])
def test_stencil_matches_jax_and_dense(T):
    m = _means(np.random.RandomState(T), 2, T, 5)
    got = F.unit_variance_mlpg_stencil(torch.tensor(m), DEFAULT_WINDOWS)
    ref = np.asarray(JF.unit_variance_mlpg_stencil(jnp.asarray(m),
                                                   DEFAULT_WINDOWS))
    assert got.shape == (2, T, 5)
    assert np.abs(got.numpy() - ref).max() < LIMIT
    assert (got - _dense(m, T)).abs().max() < LIMIT
    # a (T, K*S) input gives (T, S)
    one = F.unit_variance_mlpg_stencil(torch.tensor(m[0]), DEFAULT_WINDOWS)
    assert torch.equal(one, got[0])


def test_multi_stream_stencil_matches_jax_and_dense():
    rs = np.random.RandomState(1)
    T = 160
    x = rs.randn(2, T, sum(STREAMS)).astype(np.float32)
    got = F.multi_stream_mlpg_stencil(torch.tensor(x), DEFAULT_WINDOWS,
                                      STREAMS, DYN)
    ref = np.asarray(JF.multi_stream_mlpg_stencil(
        jnp.asarray(x), DEFAULT_WINDOWS, STREAMS, DYN))
    R = unit_variance_mlpg_matrix(DEFAULT_WINDOWS, T)
    dense = multi_stream_mlpg(torch.tensor(x), torch.tensor(R), STREAMS, DYN)
    dense_jax = np.asarray(jax_multi_stream(jnp.asarray(x), jnp.asarray(R),
                                            STREAMS, DYN))
    assert got.shape == (2, T, 60 + 1 + 1 + 1)
    assert np.abs(got.numpy() - ref).max() < LIMIT
    assert (got - dense).abs().max() < LIMIT
    assert np.abs(dense.numpy() - dense_jax).max() < LIMIT


def test_dynamic_stencil_at_ragged_lengths():
    """Zero-padded features with each example's true length: the JAX
    package's dynamic operator, and the dense R at that length up to and
    including the last frame; the padding is exactly zero."""
    rs = np.random.RandomState(2)
    Tp, S = 320, 4
    lengths = np.array([320, 301, 160, 98], np.int32)
    m = _means(rs, len(lengths), Tp, S)
    m *= (np.arange(Tp)[None, :, None] < lengths[:, None, None])
    op = F.MLPGStencil.create(DEFAULT_WINDOWS)
    got = unit_variance_mlpg(op, torch.tensor(m), torch.tensor(lengths))
    jop = JF.MLPGStencil.create(DEFAULT_WINDOWS)
    ref = np.asarray(JF.unit_variance_mlpg_dynamic(
        jop, jnp.asarray(m), jnp.asarray(lengths)))
    assert np.abs(got.numpy() - ref).max() < LIMIT
    for b, L in enumerate(lengths):
        exact = _dense(m[b:b + 1, :L], L)[0]
        assert (got[b, :L] - exact).abs().max() < LIMIT, L
        assert (got[b, L - 1] - exact[L - 1]).abs().max() < LIMIT
        assert (got[b, L:] == 0).all()
    # one (T, K*S) utterance with a scalar length
    one = unit_variance_mlpg(op, torch.tensor(m[2]), torch.tensor(160))
    assert torch.equal(one, got[2])


def test_dynamic_stencil_gradient_is_dense_transpose():
    """The backward through the operator (interior product, boundary rows
    placed at the length, masking) is R^T g at the true length."""
    rs = np.random.RandomState(3)
    Tp, L, S = 256, 211, 3
    m = torch.tensor(_means(rs, 1, Tp, S), requires_grad=True)
    g = torch.tensor(rs.randn(1, Tp, S).astype(np.float32))
    op = F.MLPGStencil.create(DEFAULT_WINDOWS)
    (unit_variance_mlpg(op, m, torch.tensor([L])) * g).sum().backward()
    R = torch.tensor(unit_variance_mlpg_matrix(DEFAULT_WINDOWS, L))
    mv = m.detach()[:, :L].clone().requires_grad_(True)
    (unit_variance_mlpg(R, mv) * g[:, :L]).sum().backward()
    assert (m.grad[:, :L] - mv.grad).abs().max() < LIMIT
    assert (m.grad[:, L:] == 0).all()


def test_stencil_refuses_what_it_cannot_do():
    with pytest.raises(ValueError, match="too short"):
        F.unit_variance_mlpg_stencil(torch.zeros(1, 97, 9), DEFAULT_WINDOWS)
    with pytest.raises(ValueError, match="lengths"):
        unit_variance_mlpg(F.MLPGStencil.create(DEFAULT_WINDOWS),
                           torch.zeros(1, 128, 9))


def test_stencil_parts_match_jax():
    """The operator's parts, built in float64 from the port's own windows
    code and cast to float32, equal the JAX package's to 1e-12 (its R solve
    may run in its C++ engine, the port's in scipy: about 1e-17 apart), and
    ``to`` moves them together."""
    op = F.MLPGStencil.create(DEFAULT_WINDOWS)
    jop = JF.MLPGStencil.create(DEFAULT_WINDOWS)
    for name in ("stencil", "top", "bot"):
        a, b = getattr(op, name).numpy(), np.asarray(getattr(jop, name))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert op.halfwidth == 24 and op.windows_key == jop.windows_key
    moved = op.to("cpu")
    assert moved.windows_key == op.windows_key
    assert torch.equal(moved.bot, op.bot)
