"""The f32 LSTM scans' flag design, on the CPU: its plan, and the plain
versions it is held to on the card against the JAX package.

The plan (``kernels/lstm_scan.py`` ``_flag_plan``, the launcher's
``f32_flag_plan`` rule) at the port's f32 path shapes: every hidden unit
is owned by exactly one block of a row slice, every row by one slice, a
block's shared memory fits Hopper's 232,448 bytes, every block of every
direction and slice has an SM of its own on an H100's 132, and the shapes
it refuses go to the cooperative design.

The plain versions (``lstm_fwd_scan_plain`` / ``lstm_bwd_scan_plain``,
which CPU tensors take) against the JAX package's Pallas LSTM kernels in
interpret mode, through ``fused_lstm_layer`` on both sides, at the cases
the flag kernels must get right: one row, rows of length 0, reversed.  y
and the gradients of dxp, dW_hh and the bias within tests/test_torch_lstm.py's
f32 limits (5e-6 and 5e-5 of scale); padded frames exactly 0.

Phase 2's SASS rules for the f32 LSTM kernels (``chip_smoke.LSTM_SASS_RULES``)
on synthetic ``cuobjdump`` text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LSTM_SASS_RULES, sass_counts, sass_problems
from gantts_tpu.kernels import lstm_scan as JL
from gantts_tpu_torch.kernels import lstm_scan as L

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("way", ["fwd", "bwd"])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("H", [64, 512, 9])
@pytest.mark.parametrize("B", [1, 3, 20])
def test_flag_plan_at_the_path_shapes(B, H, ndir, way):
    plan = L._flag_plan(B, H, ndir, torch.float32, SMS, way)
    assert (plan is not None) == (H == 512)
    assert L._flag_plan(B, H, ndir, torch.bfloat16, SMS, way) is None
    if plan is None:
        return
    # block k of a direction and row slice owns units [k U, (k + 1) U):
    # each once
    owned = [k * plan.units + u for k in range(plan.blocks)
             for u in range(plan.units)]
    assert sorted(owned) == list(range(H))
    assert plan.grid == ndir * plan.slices * plan.blocks <= SMS
    assert plan.smem <= 232448
    # one direction: B >= 2 rows in two slices of 64 blocks of 8 units a
    # way (128 blocks), one row at 4 units forward (128 blocks) and 8
    # backward (64); two directions: 64 blocks of 8 each, all rows
    split = ndir == 1 and B >= 2
    assert plan.slices == (2 if split else 1)
    assert plan.units == (4 if ndir == 1 and way == "fwd" and B == 1 else 8)
    # slice i holds rows [i ceil(B / S), ...): every row once, every slice
    # at least one, within the block's padded rows (a multiple of 2, of 4
    # with one slice)
    per = -(-B // plan.slices)
    rows = [list(range(i * per, min(B, (i + 1) * per)))
            for i in range(plan.slices)]
    assert sum(rows, []) == list(range(B)) and all(rows)
    assert all(len(r) <= plan.rows for r in rows)
    assert plan.rows % (2 if split else 4) == 0
    # the threads' split of the products: 32 K splits a forward thread
    # of H / 32 k, KG = 32 U row groups of the backward's partial dh
    assert H % (32 * plan.units) == 0


@pytest.mark.parametrize("way", ["fwd", "bwd"])
@pytest.mark.parametrize("B,H,ndir", [(25, 512, 1), (20, 1024, 1),
                                      (20, 256, 3), (0, 512, 1)])
def test_flag_plan_refuses(B, H, ndir, way):
    """More rows than its 24, an H above 512, more directions than fit the
    card's SMs, and no rows: the cooperative design takes them."""
    assert L._flag_plan(B, H, ndir, torch.float32, SMS, way) is None


CASES = [  # T, lengths, reverse
    (21, [21], False),
    (21, [13], True),
    (21, [21, 0, 9], False),
    (21, [0, 21, 5], True),
]


@pytest.mark.parametrize("Tn,lengths,reverse", CASES)
def test_plain_f32_matches_jax(Tn, lengths, reverse):
    """y, dxp, dW_hh and db of one f32 layer from xp: the port's plain
    scans (CPU tensors) against the JAX Pallas kernels in interpret
    mode."""
    rs = np.random.RandomState(11 + len(lengths) + 2 * reverse)
    Hn = 9
    lens = np.asarray(lengths, np.int32)
    xp = (rs.randn(Tn, len(lens), 4 * Hn) * 0.5).astype(np.float32)
    whh = (rs.randn(Hn, 4 * Hn) * 0.3).astype(np.float32)
    bias = (rs.randn(4 * Hn) * 0.1).astype(np.float32)
    gy = rs.randn(Tn, len(lens), Hn).astype(np.float32)

    def jfn(xp, wh, b):
        return JL.fused_lstm_layer(xp, wh, b, jnp.asarray(lens),
                                   reverse=reverse)
    y_ref, vjp = jax.vjp(jfn, xp, whh, bias)
    g_ref = vjp(jnp.asarray(gy))

    ts = [torch.tensor(a, requires_grad=True) for a in (xp, whh, bias)]
    y = L.fused_lstm_layer(*ts, torch.tensor(lens), reverse=reverse)
    g = torch.autograd.grad(y, ts, torch.tensor(gy))

    def close(name, a, b, tol):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= tol * scale, name

    close("y", y.detach().numpy(), y_ref, 5e-6)
    for name, a, b in zip(("dxp", "dw_hh", "db"), g, g_ref):
        close(name, a.numpy(), b, 5e-5)
    pad = np.arange(Tn)[:, None] >= lens[None, :]
    assert (y.detach().numpy()[pad] == 0).all()
    assert (g[0].numpy()[pad] == 0).all()


FLAG_FWD = ("_ZN12_GLOBAL__N_120lstm_fwd_flag_kernelILi4EEEvPKfS2_S2_PKiPfS5_"
            "S5_S5_Pjiiiii")
FLAG_BWD = ("_ZN12_GLOBAL__N_120lstm_bwd_flag_kernelILi4EEEvPKfPKiS2_S2_S2_Pf"
            "S5_S5_Pjiiiii")
COOP_FWD = "_ZN12_GLOBAL__N_115lstm_fwd_kernelIfEEvPKT_S3_PKfPKiPS1_PfS8_S8_Pj"
COOP_BWD = "_ZN12_GLOBAL__N_115lstm_bwd_kernelIfEEvPKT_PKiPKfS3_S3_PS1_PfPj"
COOP_BF16 = ("_ZN12_GLOBAL__N_115lstm_fwd_kernelI13__nv_bfloat16EEvPKT_S4_"
             "PKfPKiPS2_PfS9_S9_Pj")
LSTM_GOOD = {name: ["FFMA R8, R4, R12, R8 ;", "LDS.64 R4, [R2+0x40] ;"]
             for name in (FLAG_FWD, FLAG_BWD, COOP_FWD, COOP_BWD)}


def _sass(functions):
    lines = ["\tcode for sm_90a"]
    for name, body in functions.items():
        lines.append(f"\t\tFunction : {name}")
        lines += [f"        /*{16 * i:04x}*/  {op}" for i, op in
                  enumerate(body)]
    return "\n".join(lines)


@pytest.mark.parametrize("name,add,drop,bad", [
    (None, None, None, False),
    (FLAG_FWD, "STL [R1+0x4], R8 ;", None, True),       # a spill
    (FLAG_BWD, "LDL R8, [R1+0x4] ;", None, True),
    (COOP_FWD, "HMMA.1688.F32.TF32 R4, R8, R12, R4 ;", None, True),
    (FLAG_BWD, None, "FFMA R8, R4, R12, R8 ;", True),   # no f32 FMA
    (COOP_BF16, "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;", None, False),
])
def test_lstm_sass_rules(name, add, drop, bad):
    """Each f32 LSTM kernel must hold FFMA and no spill or tensor-core
    instruction; the bf16 cooperative instance (tensor cores by design)
    is not held to them."""
    functions = {k: list(v) for k, v in LSTM_GOOD.items()}
    functions[COOP_BF16] = ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    if add:
        functions[name].append(add)
    if drop:
        functions[name].remove(drop)
    counts = sass_counts(_sass(functions), LSTM_SASS_RULES)
    assert set(counts) == set(LSTM_GOOD)
    assert bool(sass_problems(counts, LSTM_SASS_RULES)) == bad


def test_lstm_sass_rules_need_every_kernel():
    functions = {k: v for k, v in LSTM_GOOD.items() if k != FLAG_FWD}
    problems = sass_problems(sass_counts(_sass(functions), LSTM_SASS_RULES),
                             LSTM_SASS_RULES)
    assert problems and "lstm_fwd_flag_kernel" in problems[0]
