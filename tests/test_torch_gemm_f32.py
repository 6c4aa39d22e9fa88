"""The f32 ``sru_proj_gemm``'s plan, its split-order sum, and phase 2's SASS
rules, on the CPU.

The kernel itself runs only on the card (tests/test_torch_gpu.py); what
surrounds it is Python and is checked here: ``_f32_gemm_plan`` at every
shape the port's f32 paths give the GEMM and at TTS synthesis's one
utterance (B=1) of 32 to 800 steps, for the H100's 132 SMs; the plan's
split-K sum (the plain version over each split's K range, added in order
of split, as the kernel's second pass adds them) against the product that
the JAX package's ``_proj_u`` forms (f32 accumulation), within 1e-6 of
scale (f32 sums in another order); and the SASS rules that make phase 2
fail on a spill or a tensor-core instruction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import F32_GEMM_SHAPES, sass_counts, sass_problems
from gantts_tpu.kernels.sru_scan import _proj_u
from gantts_tpu_torch.kernels import sru_scan as K

torch.set_num_threads(1)

SMS = 132  # an H100 SXM
STEP_SHAPES = sorted({(M, D, N) for _, M, D, N in F32_GEMM_SHAPES})
SYNTH_SHAPES = [(Tn, D, 2048) for Tn in range(32, 801, 32)
                for D in (416, 425, 1024)]


def _partition(intervals, end):
    """The (begin, end) intervals are non-empty, in order, and join to
    [0, end)."""
    assert intervals and intervals[0][0] == 0 and intervals[-1][1] == end
    for (a0, a1), (b0, _) in zip(intervals, intervals[1:]):
        assert a1 == b0
    assert all(a < b for a, b in intervals)


@pytest.mark.parametrize("M,D,N", STEP_SHAPES + SYNTH_SHAPES)
def test_plan_covers_the_product(M, D, N):
    plan = K._f32_gemm_plan(M, N, D, SMS)
    # tiles cover M x N exactly once: their rows and columns partition it
    _partition([(i * plan.tile_m, min(M, (i + 1) * plan.tile_m))
                for i in range(plan.tiles_m)], M)
    _partition([(j * plan.tile_n, min(N, (j + 1) * plan.tile_n))
                for j in range(plan.tiles_n)], N)
    assert (plan.tile_m, plan.tile_n) in K.F32_TILES
    # every split's K range is non-empty, in order, and they join to [0, K),
    # at the k steps the kernel derives from (splits, k_steps)
    _partition(list(plan.k_ranges), D)
    assert len(plan.k_ranges) == plan.splits
    span = plan.k_steps * K.F32_TILE_K
    assert plan.k_ranges == tuple((z * span, min(D, (z + 1) * span))
                                  for z in range(plan.splits))
    # split-K only where the tiles alone leave SMs idle, and then no more
    # blocks than are resident at once, none with less than the minimum K
    tiles = plan.tiles_m * plan.tiles_n
    if tiles >= SMS:
        assert plan.splits == 1
    else:
        assert plan.splits * tiles <= K.F32_TILES[plan.tile_m,
                                                  plan.tile_n] * SMS
        if D >= 2 * K.F32_MIN_SPLIT_K:
            assert plan.splits > 1
    if plan.splits > 1:
        assert span >= K.F32_MIN_SPLIT_K
    assert plan.workspace == (plan.splits * M * N if plan.splits > 1 else 0)


def test_plan_at_the_step_shapes():
    """The training steps take 128x256 tiles at M = T x B = 10240 and
    128x128 at the duration step's 3072, unsplit; synthesis splits K."""
    for D in (425, 1024):
        plan = K._f32_gemm_plan(10240, 2048, D, SMS)
        assert (plan.tile_m, plan.tile_n, plan.splits) == (128, 256, 1)
    plan = K._f32_gemm_plan(3072, 2048, 416, SMS)
    assert (plan.tile_m, plan.tile_n, plan.splits) == (128, 128, 1)
    plan = K._f32_gemm_plan(64, 2048, 1024, SMS)
    assert (plan.tile_m, plan.tiles_m * plan.tiles_n) == (64, 16)
    assert plan.splits == 16 and plan.workspace == 16 * 64 * 2048
    assert K._f32_gemm_plan(608, 2048, 425, SMS).splits == 3


@pytest.mark.parametrize("M,D,N", [s for s in STEP_SHAPES if s[0] <= 608])
def test_split_order_sum_matches_jax_proj_u(M, D, N):
    """The plain version summed over the plan's K ranges in order of split
    against ``_proj_u``'s jax.lax.dot_general (f32 accumulation), from one
    numpy seed, within 1e-6 of scale."""
    rs = np.random.RandomState(D)
    x = rs.randn(M, D).astype(np.float32)
    w = (rs.uniform(-1, 1, (D, N)) / 512 ** 0.5).astype(np.float32)
    plan = K._f32_gemm_plan(M, N, D, SMS)
    assert plan.splits > 1
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = None
    for k0, k1 in plan.k_ranges:
        part = K.sru_proj_gemm_plain(xt[:, k0:k1], wt[k0:k1])
        got = part if got is None else got + part
    ref = np.asarray(_proj_u(jnp.asarray(x[None]), jnp.asarray(w),
                             jnp.float32))[0]
    assert got.shape == ref.shape == (M, N)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(K.sru_proj_gemm(xt, wt).numpy(),
                                  K.sru_proj_gemm_plain(xt, wt).numpy())


F32_NAME = "_ZN12_GLOBAL__N_113proj_gemm_f32ILi8EEEvPKfS2_Pfiiiii"
SUM_NAME = "_ZN12_GLOBAL__N_123proj_gemm_f32_split_sumEPK6float4PS1_mi"
BF16_NAME = "_ZN12_GLOBAL__N_114proj_gemm_bf16E14CUtensorMap_stS0_P13__nv_bfloat16iii"
GOOD = {
    F32_NAME: ["FFMA R8, R4, R12, R8 ;", "LDS.128 R4, [R2+0x40] ;",
               "LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R6.64] ;"],
    SUM_NAME: ["LDG.E.128 R4, desc[UR4][R2.64] ;", "FADD R4, R4, R8 ;"],
    BF16_NAME: ["HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
                "UTMALDG.2D [UR8], [UR4] ;"],
}


def _sass(functions):
    lines = ["\tcode for sm_90a"]
    for name, body in functions.items():
        lines.append(f"\t\tFunction : {name}")
        lines += [f"        /*{16 * i:04x}*/  {op}" for i, op in
                  enumerate(body)]
    return "\n".join(lines)


@pytest.mark.parametrize("name,add,drop,bad", [
    (None, None, None, False),
    (F32_NAME, "STL [R1+0x4], R8 ;", None, True),      # a spill
    (F32_NAME, "LDL R8, [R1+0x4] ;", None, True),
    (F32_NAME, "HMMA.1688.F32.TF32 R4, R8, R12, R4 ;", None, True),
    (F32_NAME, None, "LDS.128 R4, [R2+0x40] ;", True),  # scalar loads only
    (F32_NAME, "LDS.64 R4, [R2] ;", "LDS.128 R4, [R2+0x40] ;", False),
    (SUM_NAME, "STL [R1], R2 ;", None, False),          # not a GEMM
    (BF16_NAME, None, "UTMALDG.2D [UR8], [UR4] ;", True),
])
def test_sass_rules(name, add, drop, bad):
    functions = {k: list(v) for k, v in GOOD.items()}
    if add:
        functions[name].append(add)
    if drop:
        functions[name].remove(drop)
    counts = sass_counts(_sass(functions))
    assert set(counts) == {F32_NAME, BF16_NAME}
    assert bool(sass_problems(counts)) == bad


def test_sass_rules_need_every_gemm():
    functions = {k: v for k, v in GOOD.items() if k != F32_NAME}
    problems = sass_problems(sass_counts(_sass(functions)))
    assert problems and "proj_gemm_f32" in problems[0]
