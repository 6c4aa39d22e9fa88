"""Data-parallel GAN training and time-sharded MLPG over torch.distributed
(counterpart of gantts_tpu/parallel/__init__.py).

One process per device, each a rank of a ``torch.distributed`` group (NCCL
on CUDA, gloo on the CPU):

  * every process iterates the identical global batch sequence (the same
    split, the same shuffle seed, so batch counts, bucketed shapes and the
    MLPG matrix agree across ranks by construction), and
    ``DataParallelGanTrainer.put_batch`` keeps the rank's contiguous rows of
    each global batch, padded with zero-length rows to a multiple of the
    world size (inert under the masked losses);
  * parameters and optimizer state are replicated: broadcast from rank 0
    when the trainer is built (``place_states``), then kept equal by equal
    updates of equal gradients;
  * the step body is ``GanTrainer``'s.  The JAX package gets its global
    sums from XLA's partitioner; here the step's seams do it by hand: the
    global batch's valid frames are one all-reduce, each rank's losses are
    its sum over them, its gradients are summed over the ranks (bucketed
    all-reduces between ``backward()`` and the optimizer, so the global-norm
    clip sees the global gradient), and the losses, counts and the metrics'
    numerators and denominators are summed in one all-reduce at the end of
    the step.  The sum of the ranks' gradients is then the single-device
    gradient of the global batch, and every rank logs the same values;
  * dropout: every rank draws the global batch's masks from the generator
    they share and keeps its own rows (``models.common.BatchRows``), so the
    step with dropout on is the single-device step on the global batch.

Why not ``DistributedDataParallel``: it averages the ranks' gradients of
their own means, which is not the gradient of the global mean once ranks
hold different numbers of valid frames (ragged lengths make that the rule),
and its reducer fires on every backward through a wrapped module, while the
generator's loss backpropagates through the discriminator that the same step
has just updated, frozen.  The explicit sums give the JAX package's
semantics with neither problem.

``time_sharded_unit_variance_mlpg`` shards the MLPG's time axis instead:
one halo exchange of W frames with each neighbour, then the stencil of
``core/fast_mlpg.py``.

``python -m gantts_tpu_torch.parallel --dryrun N`` runs one data-parallel
step and the time-sharded MLPG on N gloo ranks on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from gantts_tpu_torch.core.fast_mlpg import (
    DEFAULT_HALFWIDTH,
    _boundary,
    _interior_blocked,
    _stencil_parts,
    _windows_key,
)
from gantts_tpu_torch.models.common import BatchRows
from gantts_tpu_torch.train.step import GanTrainer


def _global_rank(group, r):
    """Rank ``r`` of ``group`` in the default group."""
    return r if group is None else dist.get_global_rank(group, r)


def backend_for(device):
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_group(init_method, world, rank, backend, device):
    """``init_process_group`` for one rank that runs on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None):
    """Join the data-parallel group, one process per device.  With no
    arguments, from torchrun's environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise at
    ``tcp://<coordinator_address>`` as rank ``process_id`` of
    ``num_processes``.  ``backend``: ``nccl`` when CUDA is available, else
    ``gloo``.  Under NCCL the process's device is ``cuda:<LOCAL_RANK>``
    (the rank modulo the visible devices without ``LOCAL_RANK``).
    Returns the group's ``DataGroup``."""
    if coordinator_address is None:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device = torch.device("cpu")
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % torch.cuda.device_count())
    _init_group(init_method, world, rank, backend, device)
    return make_mesh(device=device)


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The data axis (the JAX package's 1-D mesh): the number of ranks, this
    process's rank, its device and the process group (None: the default
    group)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[Any] = None


def make_mesh(n_devices=None, device=None, group=None):
    """The ``DataGroup`` of this process in ``group`` (default: the whole
    initialized group).  A rank is one process and one device, so
    ``n_devices``, when given, must be the group's size.  ``device``: the
    current CUDA device under NCCL, else the CPU."""
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the group has {world} ranks, one device each; "
                         f"{n_devices} devices asked for")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return DataGroup(world, dist.get_rank(group), torch.device(device),
                     group)


def pad_batch_to_devices(arrs, lengths, n_devices):
    """Pad the batch axis with zero-length rows to a multiple of n_devices."""
    B = arrs[0].shape[0]
    rem = (-B) % n_devices
    if rem == 0:
        return arrs, lengths
    arrs = [np.concatenate(
        [a, np.zeros((rem,) + a.shape[1:], a.dtype)], axis=0) for a in arrs]
    lengths = np.concatenate([lengths, np.zeros(rem, lengths.dtype)])
    return arrs, lengths


def local_rows(arrs, lengths, world, rank):
    """Rank ``rank``'s contiguous rows of a global host batch, padded to a
    multiple of ``world`` first (the JAX package's ``put_batch`` callback):
    (arrays, lengths)."""
    arrs, lengths = pad_batch_to_devices(list(arrs), np.asarray(lengths),
                                         world)
    b = len(lengths) // world
    rows = slice(rank * b, (rank + 1) * b)
    return [a[rows] for a in arrs], lengths[rows]


def _state_tensors(state, device):
    """The tensors of a TrainState that ranks must hold equal: the model's
    parameters and buffers, the optimizer's state and (the port's
    ``ClippedOptimizer``) its device step count and learning rates; those
    on ``device`` (torch.optim's host step counts follow the device's)."""
    opt = state.optimizer
    inner = getattr(opt, "inner", opt)
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for group in getattr(inner, "param_groups", ()):
        for p in group["params"]:
            st = inner.state.get(p, {})
            tensors += [st[k] for k in sorted(st)]
    step = getattr(opt, "_step", None)
    tensors += ([step] if step is not None else []) + list(
        getattr(opt, "_lr", []))
    return [t for t in tensors
            if isinstance(t, torch.Tensor) and t.device == device]


def _buckets(tensors, limit):
    """Consecutive runs of ``tensors`` of one dtype, each of at most
    ``limit`` bytes (or one tensor)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > limit or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


class DataParallelGanTrainer(GanTrainer):
    """``GanTrainer`` whose step is the data-parallel group's: the batch is
    sharded on the batch axis (``put_batch``), the parameters and
    optimizer states are replicated (``states`` are broadcast from rank 0
    here), and the step's seams sum over the group (the module docstring).
    ``mesh``: the ``DataGroup`` (default ``make_mesh(device=device)``).
    One step a dispatch: the loop runs no multi-step graphs here."""

    supports_multi_step = False
    BUCKET_BYTES = 25 * 2**20  # gradients summed in all-reduces of this size

    def __init__(self, cfg, Y_mean, Y_std, device=None, model_ref=None,
                 windows=None, mesh=None, states=()):
        if mesh is None:
            mesh = make_mesh(device=device)
        super().__init__(cfg, Y_mean, Y_std, mesh.device,
                         model_ref=model_ref, windows=windows)
        self.mesh = mesh
        self.place_states(*states)

    def place_states(self, *states):
        """Broadcast each TrainState's parameters and optimizer state from
        rank 0, so that every rank starts from the same bits."""
        with torch.no_grad():
            for state in states:
                for t in _state_tensors(state, self.device):
                    dist.broadcast(t, _global_rank(self.mesh.group, 0),
                                   group=self.mesh.group)
        return states

    def put_batch(self, x, y, lengths, z=None):
        arrs = [np.asarray(x), np.asarray(y)]
        if z is not None:
            arrs.append(np.asarray(z))
        arrs, lengths = local_rows(arrs, lengths, self.mesh.world,
                                   self.mesh.rank)
        return arrs[0], arrs[1], lengths, arrs[2] if z is not None else None

    def step(self, gstate, dstate, x, y, lengths, R, adv_w, generator=None,
             train=True, z=None):
        if generator is not None:
            generator = BatchRows(generator, self.mesh.rank, self.mesh.world)
        return super().step(gstate, dstate, x, y, lengths, R, adv_w,
                             generator=generator, train=train, z=z)

    def _global_sum(self, t):
        dist.all_reduce(t, group=self.mesh.group)
        return t

    def _global_sums(self, values):
        """One all-reduce of the values stacked in float64 (counts stay
        exact, and each sum is rounded once to its own dtype)."""
        keys = list(values)
        with torch.no_grad():
            total = self._global_sum(
                torch.stack([values[k].double() for k in keys]))
        return {k: total[i].to(values[k].dtype) for i, k in enumerate(keys)}

    @torch.no_grad()
    def _reduce_grads(self, module):
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        for bucket in _buckets(grads, self.BUCKET_BYTES):
            flat = self._global_sum(torch.cat([g.reshape(-1)
                                               for g in bucket]))
            for g, part in zip(bucket, flat.split([g.numel()
                                                   for g in bucket])):
                g.copy_(part.view_as(g))


# ---------------------------------------------------------------------------
# Sequence-parallel (time-sharded) MLPG
# ---------------------------------------------------------------------------

def _sharding_error(n, W, T):
    return ValueError(
        f"time-sharded MLPG needs T divisible by {n} devices with "
        f">= {2 * W} frames per shard (got T={T})")


def shard_time(means, group=None, halfwidth=None):
    """This rank's T/n contiguous frames of the global (B, T, ·) means;
    raises ``ValueError`` when T is not divisible by the n ranks."""
    n = dist.get_world_size(group)
    T = means.shape[1]
    if T % n:
        raise _sharding_error(n, halfwidth or DEFAULT_HALFWIDTH, T)
    t = T // n
    i = dist.get_rank(group)
    return means[:, i * t:(i + 1) * t]


def time_sharded_unit_variance_mlpg(means, windows, group=None,
                                    halfwidth=None):
    """Unit-variance MLPG with the TIME axis sharded over the group.

    Every output frame depends on at most W = 24 frames to each side, but
    for the first and last W frames, which take the exact boundary blocks
    (``core/fast_mlpg.py``).  So:

      * each rank holds T/n contiguous frames, rank i frames [i T/n,
        (i + 1) T/n) (``shard_time``);
      * one halo exchange (``dist.batch_isend_irecv``) gives it W frames
        from each neighbour; the edge ranks take zeros, the zero padding of
        the unsharded operator;
      * the interior is the stencil's blocked product over [halo | local |
        halo], of which the T/n centre frames are kept;
      * the first and last rank overwrite their first and last W frames
        with the exact boundary blocks (which span 2W frames, so T/n >= 2W).

    It equals ``unit_variance_mlpg_stencil`` on the whole sequence (to
    float32 rounding): the sharding adds no approximation.

    Args:
      means: (B, T/n, K*S), this rank's frames.
      windows: the delta-window set.
      group: the process group (default: the whole group).
    Returns: (B, T/n, S), this rank's frames of the result.
    """
    W = halfwidth or DEFAULT_HALFWIDTH
    key = _windows_key(windows)
    _, top, bot = _stencil_parts(key, W)
    K = len(windows)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    B, T_loc, KS = means.shape
    if T_loc < 2 * W:
        raise _sharding_error(n, W, T_loc * n)
    u = means.float().reshape(B, T_loc, K, KS // K)

    from_left = torch.zeros_like(u[:, :W])
    from_right = torch.zeros_like(u[:, :W])
    ops = []
    for nb, edge, halo in ((i - 1, u[:, :W], from_left),
                           (i + 1, u[:, -W:], from_right)):
        if 0 <= nb < n:
            ops += [dist.P2POp(dist.isend, edge.contiguous(),
                               _global_rank(group, nb), group),
                    dist.P2POp(dist.irecv, halo, _global_rank(group, nb),
                               group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    u_halo = torch.cat([from_left, u, from_right], dim=1)
    y = _interior_blocked(u_halo, key, W)[:, W:W + T_loc]
    C = 2 * W
    if i == 0:
        top = torch.as_tensor(top, device=u.device)
        y = torch.cat([_boundary(u[:, :C], top), y[:, W:]], dim=1)
    if i == n - 1:
        bot = torch.as_tensor(bot, device=u.device)
        y = torch.cat([y[:, :T_loc - W], _boundary(u[:, T_loc - C:], bot)],
                      dim=1)
    return y


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

def _rank_main(rank, target, world, init_method, backend, device_type,
               args):
    import importlib

    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _init_group(init_method, world, rank, backend, device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(target, world, args=(), device="cpu", init_method=None):
    """Run ``target(*args)`` in ``world`` spawned processes, rank r of a
    group on ``cuda:r`` (NCCL) or on the CPU (gloo), and wait for all of
    them; raises if any fails.  ``target``: ``"module:function"``, imported
    by each process (a module run as ``python -m`` is its ``__main__``,
    which a spawned process cannot find by that name); ``args`` must
    pickle.  ``init_method``: the rendezvous, by default a file in a
    temporary directory."""
    import torch.multiprocessing as mp

    kind = torch.device(device).type
    if kind == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="gantts_rdzv_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        mp.start_processes(
            _rank_main, args=(target, world, init_method, backend_for(kind),
                              kind, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
