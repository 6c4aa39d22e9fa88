"""Rank programs of tests/test_torch_parallel.py: each runs in a process
that ``gantts_tpu_torch.parallel.spawn`` starts, one rank of a gloo group
on the CPU.  This module imports torch and the port only (no JAX), so the
worker processes hold nothing of the JAX package; each checks so.

``session(spec_path, out_dir)`` reads a spec that the test wrote (converted
weights, batches, which cases to run), runs its cases and writes this
rank's results to ``out_dir/rank{r}.pt``.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from gantts_tpu_torch import hparams as port_hparams
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.parallel import (
    DataParallelGanTrainer,
    shard_time,
    time_sharded_unit_variance_mlpg,
)
from gantts_tpu_torch.train import GanTrainer, StepConfig
from gantts_tpu_torch.train.checkpoint import restore, save_checkpoint
from gantts_tpu_torch.train.loop import train_loop
from gantts_tpu_torch.train.setup import init_models_and_states

STEP_KW = dict(w_d=1.0, mse_w=0.5, mge_w=1.0, update_d=True, update_g=True)
LOOP_KW = dict(w_d=1.0, mse_w=0.0, mge_w=1.0, update_d=True, update_g=True)


def vc_hp(module, dropout=0.0):
    """tests/test_parallel.py's ``test_dp_step_matches_single_device``
    configuration: the vc bundle at order 9, a 1x16 In2OutHighwayNet and a
    1x8 discriminator."""
    hp = module.vc.copy()
    hp.order = 9
    hp.stream_sizes = [27]
    hp.generator_params.update(in_dim=27, out_dim=27, static_dim=9,
                               num_hidden=1, hidden_dim=16, dropout=dropout)
    hp.discriminator_params.update(in_dim=9, num_hidden=1, hidden_dim=8,
                                   dropout=dropout)
    return hp


def sru_hp(module, dropout=0.0):
    """tests/test_parallel.py's ``_loop_workload`` configuration: the
    tts_acoustic bundle with a 1x16 bidirectional relu SRU on 30 inputs and
    a 1x8 discriminator on [linguistic | masked mgc statics]."""
    hp = module.tts_acoustic.copy()
    hp.nepoch = 2
    hp.generator_params.update(
        in_dim=30, out_dim=187, num_hidden=1, hidden_dim=16,
        bidirectional=True, dropout=dropout, use_relu=1,
        rnn_dropout=dropout, last_sigmoid=False)
    hp.discriminator_params.update(in_dim=58 + 30, num_hidden=1,
                                   hidden_dim=8, dropout=dropout)
    return hp


CONFIGS = {"vc": vc_hp, "sru": sru_hp}


class Recording:
    """An optimizer that keeps the gradients it is given (after the
    trainer's sums over the group), then steps."""

    def __init__(self, optimizer, module):
        self.optimizer, self.module, self.grads = optimizer, module, None

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def zero_grad(self):
        self.optimizer.zero_grad()

    def step(self):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.module.named_parameters()}
        self.optimizer.step()


def _states(case, dropout=0.0, device="cpu"):
    hp = CONFIGS[case["config"]](port_hparams, dropout)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=0,
                                                        device=device)
    gstate.model.load_state_dict(case["g"], strict=True)
    dstate.model.load_state_dict(case["d"], strict=True)
    for s in (gstate, dstate):
        s.optimizer = Recording(s.optimizer, s.model)
    return hp, gstate, dstate


def _numpy(state):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in state.model.state_dict().items()}


def _result(out, gstate, dstate):
    return {"out": {k: float(v) for k, v in out.items()},
            "g": _numpy(gstate), "d": _numpy(dstate),
            "grads_g": {k: v.cpu().numpy() for k, v in
                        gstate.optimizer.grads.items()},
            "grads_d": {k: v.cpu().numpy() for k, v in
                        dstate.optimizer.grads.items()}}


def _run_steps(trainer, gstate, dstate, batch, R, adv_w, steps, seed):
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, y, lengths = (torch.as_tensor(a, device=dev) for a in batch)
    for _ in range(steps):
        gstate, dstate, out = trainer.step(
            gstate, dstate, x, y, lengths, torch.as_tensor(R, device=dev),
            adv_w, gen)
    return out


def step_case(case, dropout=0.0, steps=1, device="cpu"):
    """The DP step on this rank's rows; on rank 0 also the single-process
    step on the whole batch from the same states."""
    res = {}
    for mode in ("dp", "single"):
        if mode == "single" and dist.get_rank() != 0:
            break
        hp, gstate, dstate = _states(case, dropout, device)
        cfg = StepConfig.from_hparams(hp, **STEP_KW)
        batch = (case["x"], case["y"], case["lengths"])
        if mode == "dp":
            trainer = DataParallelGanTrainer(
                cfg, case["Y_mean"], case["Y_std"], device,
                states=(gstate, dstate))
            batch = trainer.put_batch(*batch)[:3]
        else:
            trainer = GanTrainer(cfg, case["Y_mean"], case["Y_std"], device)
        out = _run_steps(trainer, gstate, dstate, batch, case["R"],
                         case["adv_w"], steps, seed=7)
        res[mode] = _result(out, gstate, dstate)
    return res


def world_one_bits(case, device):
    """A one-rank group's DP trainer against GanTrainer from the same
    states, 3 steps with dropout on: whether every scalar, parameter,
    optimizer value and the dropout generator's state hold the same bits,
    and each run's kernel launches."""
    from gantts_tpu_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    for mode in ("dp", "single"):
        hp, gstate, dstate = _states(case, 0.2, device)
        cfg = StepConfig.from_hparams(hp, **STEP_KW)
        trainer = (DataParallelGanTrainer(cfg, case["Y_mean"], case["Y_std"],
                                          device, states=(gstate, dstate))
                   if mode == "dp" else
                   GanTrainer(cfg, case["Y_mean"], case["Y_std"], device))
        gen = torch.Generator(device=device).manual_seed(0)
        batch = [torch.as_tensor(case[k], device=device)
                 for k in ("x", "y", "lengths")]
        reset_launch_counts()
        outs = [trainer.step(gstate, dstate, *batch,
                             torch.as_tensor(case["R"], device=device),
                             case["adv_w"], gen)[2] for _ in range(3)]
        tensors = [t.detach().cpu().clone() for s in (gstate, dstate)
                   for t in list(s.model.parameters()) + [
                       v for st in s.optimizer.inner.state.values()
                       for v in st.values()]]
        runs[mode] = (outs, tensors, gen.get_state(), dict(launch_counts))
    (o1, t1, g1, l1), (o2, t2, g2, l2) = runs["dp"], runs["single"]
    return {"scalars": all(torch.equal(a[k].cpu(), b[k].cpu()) or bool(
                torch.isnan(a[k]) and torch.isnan(b[k]))
                for a, b in zip(o1, o2) for k in b),
            "states": all(torch.equal(a, b) for a, b in zip(t1, t2)),
            "n_tensors": len(t1), "generator": torch.equal(g1, g2),
            "launches": (l1, l2), "backend": dist.get_backend()}


def mlpg_case(u, windows, device="cpu"):
    """The time-sharded MLPG of the global (B, T, K*S) ``u``, its shards
    gathered (every rank holds the whole result)."""
    y = time_sharded_unit_variance_mlpg(
        shard_time(torch.as_tensor(u, device=device)), windows)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    return torch.cat(parts, dim=1).cpu().numpy()


def refusals(windows):
    """The ValueErrors of the time-sharded MLPG: T not divisible by the
    ranks, and shards shorter than 2W frames."""
    n = dist.get_world_size()
    msgs = []
    for T, fn in ((97 * n + 1, lambda u: shard_time(u)),
                  (32 * n, lambda u: time_sharded_unit_variance_mlpg(
                      shard_time(u), windows))):
        try:
            fn(torch.zeros(1, T, 3 * len(windows)))
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def handoff(case, ck, resume):
    """tests/test_parallel.py's checkpoint handoff: without ``resume``, 3
    steps and rank 0 writes the checkpoints (and, as the reference, an
    uninterrupted 4-step run); with it, every rank restores them in a fresh
    group and takes step 4."""
    hp, gstate, dstate = _states(case)
    cfg = StepConfig.from_hparams(hp, **STEP_KW)
    if resume:
        for s, name in ((gstate, "Generator"), (dstate, "Discriminator")):
            restore(s, f"{ck}/checkpoint_epoch1_{name}.pth", False)
    trainer = DataParallelGanTrainer(cfg, case["Y_mean"], case["Y_std"],
                                     "cpu", states=(gstate, dstate))
    batch = trainer.put_batch(case["x"], case["y"], case["lengths"])[:3]
    if resume:
        # the dropout-free step 4 of the uninterrupted run
        return {"step4": _result(_run_steps(
            trainer, gstate, dstate, batch, case["R"], case["adv_w"], 1, 7),
            gstate, dstate)}
    _run_steps(trainer, gstate, dstate, batch, case["R"], case["adv_w"], 3, 7)
    for s, name in ((gstate, "Generator"), (dstate, "Discriminator")):
        save_checkpoint(s, 1, ck, name)
    hp, gstate, dstate = _states(case)
    trainer = DataParallelGanTrainer(cfg, case["Y_mean"], case["Y_std"],
                                     "cpu", states=(gstate, dstate))
    return {"uninterrupted": _result(_run_steps(
        trainer, gstate, dstate, batch, case["R"], case["adv_w"], 4, 7),
        gstate, dstate)}


def loop_case(case):
    """tests/test_parallel.py's ``_loop_workload`` through the port's
    ``train_loop``: two epochs over train batches of T = 64, 96, 64 and a
    test batch of 64, all ranks iterating the same global batches."""
    hp = sru_hp(port_hparams)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=0,
                                                        device="cpu")
    gstate.model.load_state_dict(case["g"], strict=True)
    dstate.model.load_state_dict(case["d"], strict=True)
    cfg = StepConfig.from_hparams(hp, **LOOP_KW)
    trainer = DataParallelGanTrainer(cfg, case["Y_mean"], case["Y_std"],
                                     "cpu", states=(gstate, dstate))
    rows = []

    class Writer:
        def log_value(self, name, value, step):
            rows.append((name, float(value), int(step)))

        def flush(self):
            pass

    train_loop(trainer, gstate, dstate, case["loaders"], hp,
               writer=Writer(), seed=1234, **LOOP_KW)
    return {"rows": rows, "g": _numpy(gstate), "d": _numpy(dstate)}


def session(spec_path, out_dir):
    """This rank's share of the spec's cases, written to
    ``out_dir/rank{r}.pt``."""
    spec = torch.load(spec_path, weights_only=False)
    held = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "gantts_tpu"))
    res = {"jax_modules": held, "world": dist.get_world_size()}
    windows = port_hparams.vc.windows
    device = spec.get("device", "cpu")
    for name, case in spec.get("steps", {}).items():
        res[name] = step_case(case, device=device)
    if "world_one" in spec:
        res["world_one"] = world_one_bits(spec["world_one"], device)
    for name, case in spec.get("dropout", {}).items():
        res[f"dropout_{name}"] = step_case(case, dropout=0.2)
    for T, u in spec.get("mlpg", {}).items():
        res[f"mlpg{T}"] = mlpg_case(u, windows, device)
    if spec.get("refusals"):
        res["refusals"] = refusals(windows)
    if "handoff" in spec:
        res.update(handoff(spec["handoff"], spec["ck"], spec["resume"]))
    if "loop" in spec:
        res["loop"] = loop_case(spec["loop"])
    torch.save(res, f"{out_dir}/rank{dist.get_rank()}.pt")


def make_batch(B, T, in_dim, out_dim, seed=0):
    """A ragged batch (the last row full) as the JAX tests make it."""
    rs = np.random.RandomState(seed)
    x = rs.rand(B, T, in_dim).astype(np.float32)
    y = rs.rand(B, T, out_dim).astype(np.float32)
    lengths = np.r_[rs.randint(T // 2, T, B - 1), T].astype(np.int32)
    return x, y, lengths


def mlpg_matrix(T):
    return unit_variance_mlpg_matrix(port_hparams.vc.windows, T, np.float32)


def port_case(config, B, T=64):
    """A step case from the port's own initial weights (no JAX), for the
    card's tests."""
    hp = CONFIGS[config](port_hparams)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=0,
                                                        device="cpu")
    dims = (27, 27) if config == "vc" else (30, 187)
    x, y, lengths = make_batch(B, T, *dims)
    mean, std = np.zeros(dims[1], np.float32), np.ones(dims[1], np.float32)
    return dict(config=config, g=gstate.model.state_dict(),
                d=dstate.model.state_dict(), x=x, y=y, lengths=lengths,
                R=unit_variance_mlpg_matrix(hp.windows, T, np.float32),
                Y_mean=mean, Y_std=std, adv_w=0.7)


def run_session(world, spec, tmp, device="cpu"):
    """``session`` on ``world`` spawned ranks (gloo on the CPU, NCCL on
    ``cuda``), meeting through a file in ``tmp``: each rank's results."""
    import os

    from gantts_tpu_torch import parallel

    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    parallel.spawn("torch_parallel_workers:session", world,
                   args=(spec_path, tmp), device=device,
                   init_method="file://" + os.path.join(tmp, "rendezvous"))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
