"""The dry run of ``python -m gantts_tpu_torch.parallel --dryrun N`` (the
counterpart of the repository's ``__graft_entry__.dryrun_multichip``): one full
data-parallel GAN training step (generator forward and backward,
discriminator update, generator update, metrics) at tiny shapes on N gloo
ranks on the CPU, held to the single-process step on the same global batch,
plus the time-sharded MLPG at T = 512 (64 N where N does not divide 8) held
to the stencil on the whole sequence.  Rank 0 prints one line:

    dryrun(N): ok — G=... D=... mge=... mcd=... sp_mlpg_T=...
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

DRYRUN_RTOL = 2e-4  # the step's scalars against the single-process step
MLPG_TOL = 5e-5


def _tiny_hparams():
    """tts_acoustic cut to tiny widths: streams [24, 3, 1, 3] (order 8),
    10 linguistic inputs, a 2x16 SRU and a 1x8 discriminator on the
    masked mgc statics and the linguistic input."""
    from gantts_tpu_torch import hparams

    hp = hparams.tts_acoustic.copy()
    hp.stream_sizes = [24, 3, 1, 3]
    hp.order = 8
    hp.generator_params.update(in_dim=10, out_dim=31, num_hidden=2,
                               hidden_dim=16)
    hp.discriminator_params.update(in_dim=16, num_hidden=1, hidden_dim=8)
    return hp


def dryrun_rank(n):
    """One rank of the dry run (``parallel.spawn``'s target)."""
    from gantts_tpu_torch.core.fast_mlpg import unit_variance_mlpg_stencil
    from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
    from gantts_tpu_torch.parallel import (
        DataParallelGanTrainer,
        shard_time,
        time_sharded_unit_variance_mlpg,
    )
    from gantts_tpu_torch.train import GanTrainer, StepConfig
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = _tiny_hparams()
    cfg = StepConfig.from_hparams(hp, w_d=1.0, mse_w=0.5, mge_w=1.0,
                                  update_d=True, update_g=True)
    stats = (np.zeros(31, np.float32), np.ones(31, np.float32))
    B, T = 2 * n, 32
    rs = np.random.RandomState(0)
    x = rs.rand(B, T, 10).astype(np.float32)
    y = rs.rand(B, T, 31).astype(np.float32)
    lengths = rs.randint(T // 2, T + 1, B).astype(np.int32)
    R = torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T))

    def run(trainer, gstate, dstate, batch):
        gen = torch.Generator().manual_seed(0)  # dropout on, as hparams say
        batch = [torch.as_tensor(a) for a in batch[:3]]
        return trainer.step(gstate, dstate, *batch, R, 1.0, gen)[2]

    *_, gstate, dstate = init_models_and_states(hp, device="cpu")
    dp = DataParallelGanTrainer(cfg, *stats, "cpu", states=(gstate, dstate))
    out = run(dp, gstate, dstate, dp.put_batch(x, y, lengths))
    *_, gstate, dstate = init_models_and_states(hp, device="cpu")
    ref = run(GanTrainer(cfg, *stats, "cpu"), gstate, dstate,
              (x, y, lengths))
    for k, v in ref.items():  # f0_rmse is NaN on both sides: no voicing
        a, b = float(out[k]), float(v)
        if not (math.isnan(a) and math.isnan(b)
                or abs(a - b) <= DRYRUN_RTOL * abs(b) + 1e-5):
            raise RuntimeError(f"dryrun({n}): {k} = {a} on {n} ranks, {b} "
                               f"in one process")

    T_sp = 64 * n * max(1, 8 // n)
    u = torch.as_tensor(np.random.RandomState(1).randn(1, T_sp, 9)
                        .astype(np.float32))
    y_sp = time_sharded_unit_variance_mlpg(shard_time(u), hp.windows)
    err = float((y_sp - shard_time(unit_variance_mlpg_stencil(
        u, hp.windows))).abs().max())
    if not err <= MLPG_TOL:
        raise RuntimeError(f"dryrun({n}): time-sharded MLPG off the stencil "
                           f"by {err}")
    if dist.get_rank() == 0:
        print(f"dryrun({n}): ok — G={float(out['generator']):.4f} "
              f"D={float(out['discriminator']):.4f} "
              f"mge={float(out['mge']):.4f} mcd={float(out['mcd']):.3f} "
              f"sp_mlpg_T={T_sp}", flush=True)


def dryrun(n):
    """The dry run on ``n`` spawned gloo ranks."""
    from gantts_tpu_torch.parallel import spawn

    spawn("gantts_tpu_torch.parallel.dryrun:dryrun_rank", n, args=(n,))
