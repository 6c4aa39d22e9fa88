"""The epoch and phase training loop (counterpart of
gantts_tpu/train/loop.py).

The reference's structure: each epoch a train phase and a test phase, the
dynamic adversarial weight ``adv_w = w_d * clip(E_mge / E_adv, 0, 1e3)``
carried from one train phase to the next, the same logged series, and
``checkpoint_epoch{N}_{Generator|Discriminator}.pth`` every
CHECKPOINT_INTERVAL epochs.  As in the JAX package, the MLPG matrix R is
built once per bucketed length and kept on the device, ``adv_w`` is
uploaded once a phase, and the per-batch scalars stay on the device until
the end of the phase: the host reads them once per phase, so it never waits
inside the batch loop.  Batches reach the card from pinned host memory,
without blocking.  Each phase logs its valid frames per second and its wall
time.

Multi-step dispatch (``steps_per_dispatch`` K, the CLI's
``--steps-per-dispatch``), with the JAX package's semantics: consecutive
batches with the same shapes are taken in groups of K, and each group runs
as one ``GanTrainer.multi_step`` (on the card, one replay of a CUDA graph of
K steps); a change of shapes or the end of a phase flushes the pending
batches, full groups fused and the rest one step at a time, in order, with
the dropout generator and the noise drawn as the unfused run draws them
(``dispatch_groups``).  The first batch of shapes the run has not met in
this phase kind runs alone and eagerly: it is the warm-up a capture needs,
and a real step.

Tracing (``gantts_tpu_torch/tracing.py``): each phase runs inside
``tracing.phase``, which asks once whether a torch profiler records on the
loop's thread.  While one does, the host work is spanned: each dispatch,
one ``trainer.step`` or one ``trainer.multi_step`` of K steps with its host
staging, as ``gan_dispatch:K`` (``dispatch_span``), so that a trace says
how many steps it holds (tools/torch_trace_report.py); inside it the
staging (``loop.stage``) and the eager step's launch (``step.launch``); the
pulling of each dispatch group out of the loader (``loop.gather``); the
phase's end (``loop.phase_end``).  While none does, a span is one branch;
tracing changes no launch and no value.

Two debugging aids, off by default (the CLI's ``--profile-dir`` and
``--debug-nans``):

  * ``profile_dir``: the second epoch of the run, ``global_epoch + 2`` (the
    first pays for building and loading the kernels and capturing the
    graphs), train and test phases, is traced by torch.profiler (CPU and,
    on the card, CUDA activity) into one Chrome trace
    ``profile_dir/trace_epoch{N}.json``, with the loader workers' spans
    added on their own threads;
  * ``debug_nans``: after each step, one read of the optimizers' gradient
    norms and the step's losses raises ``FloatingPointError`` on the first
    that is not finite, naming the epoch, phase, batch and quantity.  It
    runs one eager step at a time (K = 1) and adds one host
    synchronisation a step; without it the loop adds none.

Randomness: the generator's input noise z comes from ``RandomState(seed)``
on the host, as in the JAX package, so both draw the same z; dropout masks
come from a ``torch.Generator`` on the device seeded with ``seed``.

Data parallelism (a ``parallel.DataParallelGanTrainer``, one process a
rank): every rank iterates the same global batches and draws the same z
for each, and uploads only its rows (``trainer.put_batch``); one step a
dispatch (K = 1), as the JAX loop runs on a mesh.  The step's outputs are
already sums over the group, so every rank computes the same phase means
and adversarial weight; rank 0 alone is given a ``writer`` by the command
line, and writes the checkpoints.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from gantts_tpu_torch import tracing
from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.train.checkpoint import save_checkpoint
from gantts_tpu_torch.train.optim import exp_decayed_lr, set_learning_rate

CHECKPOINT_INTERVAL = 10  # reference train.py:66
DISPATCH_SPAN = "gan_dispatch"  # a dispatch's host range: "gan_dispatch:K"


def adv_weight(w_d, e_mge, e_adv):
    """w_d * clip(E(mge) / E(adv), 0, 1e3).  A saturated discriminator can
    make E(adv) exactly 0; the max() guard gives numpy's endpoint (inf,
    clipped to 1e3) where Python's division would raise."""
    return w_d * float(np.clip(e_mge / max(e_adv, 1e-30), 0, 1e3))


class RMatrixCache:
    """unit_variance_mlpg_matrix per bucketed length, float32 on
    ``device``."""

    def __init__(self, windows, device):
        self.windows = windows
        self.device = device
        self._cache = {}

    def get(self, T):
        if T not in self._cache:
            self._cache[T] = torch.as_tensor(
                unit_variance_mlpg_matrix(self.windows, T, np.float32),
                device=self.device)
        return self._cache[T]


LOSSES = ("discriminator", "loss_real_d", "loss_fake_d", "mse", "mge",
          "loss_adv", "generator")


def _require_finite_losses(out, where, norms=()):
    """One read of ``norms`` ((name, device scalar) of each optimizer that
    stepped) and the step's losses; raises ``FloatingPointError`` naming
    the first that is not finite."""
    keys = [k for k in LOSSES if k in out]
    names = [f"{name}'s gradient norm" for name, _ in norms] + \
        [f"{k} loss" for k in keys]
    values = [n.float() for _, n in norms] + [out[k].float() for k in keys]
    finite = torch.isfinite(torch.stack(values)).tolist()
    bad = [n for n, ok in zip(names, finite) if not ok]
    if bad:
        raise FloatingPointError(
            f"{where}: the {bad[0]} is not finite (not finite: "
            f"{', '.join(bad)})")


def dispatch_groups(batches, key, K, warm):
    """The dispatches of a phase's ``batches``, in order: lists of K
    batches that run as one fused dispatch, and lists of one.  Consecutive
    batches with the same ``key(batch)`` are taken in groups of K; a change
    of key or the end flushes the pending batches, the rest one at a time.
    With K > 1, the first batch of a key not in ``warm`` runs alone (the
    warm-up of a capture) and its key joins ``warm``."""
    pend, pend_key = [], None
    for batch in batches:
        k = key(batch)
        if pend and k != pend_key:
            yield from ([b] for b in pend)
            pend = []
        if K > 1 and k not in warm:
            warm.add(k)
            yield [batch]
            continue
        pend.append(batch)
        pend_key = k
        if len(pend) == K:
            yield pend
            pend = []
    yield from ([b] for b in pend)


class _Stager:
    """Host arrays onto the trainer's device: from pinned memory without
    blocking on the card, as they are on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"

    def host(self, arrays):
        """The arrays stacked on a new leading axis, in (pinned) host
        memory."""
        first = np.asarray(arrays[0])
        out = torch.empty((len(arrays),) + first.shape,
                          dtype=torch.from_numpy(first).dtype,
                          pin_memory=self.pin)
        for k, a in enumerate(arrays):
            out[k].copy_(torch.from_numpy(np.asarray(a)))
        return out

    def put(self, arrays):
        return self.host(arrays).to(self.device, non_blocking=True)


def dispatch_span(K):
    """The span of one dispatch of K steps (``tracing.span``)."""
    return tracing.span(f"{DISPATCH_SPAN}:{K}")


def gathered(groups):
    """``groups``, each pulled out inside a ``loop.gather`` span: the
    loader's fetches and the grouping up to the group's hand-over."""
    groups = iter(groups)
    while True:
        with tracing.span("loop.gather"):
            group = next(groups, None)
        if group is None:
            return
        yield group


def run_dispatch(trainer, gstate, dstate, group, stage, R, adv_w, generator,
                 train, check=None):
    """One dispatch of a phase: ``group``'s batches (x, y, lengths, z), host
    arrays, this trainer's rows of each (``put_batch``) as one eager step
    or, for K > 1, one ``multi_step``, inside ``dispatch_span(K)``.
    ``check(out)`` reads a one-step dispatch's outputs (``debug_nans``).
    Returns (gstate, dstate, outs), each of outs (K,)."""
    with dispatch_span(len(group)):
        group = [trainer.put_batch(*b) for b in group]
        xs, ys, ls, zs = ([b[j] for b in group] for j in range(4))
        noise = trainer.cfg.add_noise
        if len(group) == 1:
            with tracing.span("loop.stage"):
                x, y, lengths = [stage.put(a)[0] for a in (xs, ys, ls)]
                z = stage.put(zs)[0] if noise else None
            with tracing.span("step.launch"):
                gstate, dstate, out = trainer.step(
                    gstate, dstate, x, y, lengths, R, adv_w,
                    generator=generator, train=train, z=z)
            if check is not None:
                check(out)
            return gstate, dstate, {k: v.reshape(1) for k, v in out.items()}
        # the stacked batch stays on the host: a graph copies it into its
        # static inputs without blocking
        with tracing.span("loop.stage"):
            x, y, lengths = [stage.host(a) for a in (xs, ys, ls)]
            z = stage.host(zs) if noise else None
        return trainer.multi_step(gstate, dstate, x, y, lengths, R, adv_w,
                                  generator=generator, train=train, zs=z)


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir, epoch):
    """Stops the profile and writes its Chrome trace, with the loader
    workers' spans of the epoch added on the trace's clock (the profiler
    traces the loop's thread alone)."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    if tracing.export_worker_spans(data):
        with open(path, "w") as f:
            json.dump(data, f)
    print(f"Profile of epoch {epoch} written to {path}")
    return path


def _phase_sums(acc):
    """Sum each key's per-step device scalars over the phase, in step
    order, read with one copy to the host.  ``acc``: key -> list of 1-D
    tensors of consecutive steps."""
    keys = list(acc)
    steps = torch.stack([torch.cat(acc[k]).double() for k in keys])
    return dict(zip(keys, steps.sum(1).tolist()))


def train_loop(trainer, gstate, dstate, dataset_loaders, hp, w_d=0.0,
               mse_w=0.0, mge_w=1.0, update_d=True, update_g=True,
               checkpoint_dir=None, writer=None, global_epoch=0, seed=1234,
               profile_dir=None, debug_nans=False, steps_per_dispatch=1):
    """Train epochs global_epoch + 1 .. hp.nepoch.  ``trainer`` is a
    GanTrainer (with its reference discriminator when ``has_ref``) or a
    ``parallel.DataParallelGanTrainer``; the states are updated in place;
    ``steps_per_dispatch``: K, 1 under ``debug_nans`` and data
    parallelism.  Returns (gstate, dstate, final_epoch)."""
    cfg = trainer.cfg
    device = trainer.device
    r_cache = RMatrixCache(hp.windows, device) if cfg.has_dynamic else None
    noise_rs = np.random.RandomState(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stage = _Stager(device)
    K = max(1, int(steps_per_dispatch)) \
        if trainer.supports_multi_step and not debug_nans else 1
    warm = set()  # (phase, shapes) that have taken an eager step

    E_loss_mge = 1.0
    E_loss_adv = 1.0
    log = writer.log_value if writer is not None else (lambda *a: None)
    traced = None

    for epoch in range(global_epoch + 1, hp.nepoch + 1):
        # LR schedule (reference train.py:466-473)
        if hp.lr_decay_schedule and update_g:
            set_learning_rate(gstate.optimizer, exp_decayed_lr(
                hp.optimizer_g_params["lr"], epoch - 1, hp.lr_decay_epoch))
        if hp.lr_decay_schedule and update_d:
            set_learning_rate(dstate.optimizer, exp_decayed_lr(
                hp.optimizer_d_params["lr"], epoch - 1, hp.lr_decay_epoch))

        prof = (_start_profile(device) if profile_dir is not None
                and epoch == global_epoch + 2 else None)

        for phase in ["train", "test"]:
            with tracing.phase(phase):
                train = phase == "train"
                N = len(dataset_loaders[phase])
                phase_t0 = time.perf_counter()
                adv_w = adv_weight(w_d, E_loss_mge, E_loss_adv) \
                    if update_g else 0.0
                # constant within the phase: on the device once
                adv_w_dev = torch.full((), adv_w, dtype=torch.float32,
                                       device=device)
                norms = [(name, opt) for name, opt, on in (
                    ("discriminator", dstate.optimizer, cfg.update_d),
                    ("generator", gstate.optimizer, cfg.update_g)) if on
                    and train]
                acc = {}
                count = fused = 0

                def with_noise(batch):
                    x = batch[0]
                    z = (noise_rs.rand(x.shape[0], x.shape[1],
                                       hp.generator_noise_dim)
                         .astype(np.float32) if cfg.add_noise else None)
                    return batch + (z,)

                batches = (with_noise(b) for b in dataset_loaders[phase])
                for group in gathered(dispatch_groups(
                        batches, lambda b: (phase, b[0].shape, b[1].shape),
                        K, warm)):
                    R = r_cache.get(group[0][0].shape[1]) \
                        if r_cache is not None else None
                    where = f"epoch {epoch}, {phase} phase, batch {count}"
                    check = (lambda out, where=where: _require_finite_losses(
                        out, where, [(name, opt.grad_norm)
                                     for name, opt in norms])) \
                        if debug_nans else None
                    gstate, dstate, out = run_dispatch(
                        trainer, gstate, dstate, group, stage, R, adv_w_dev,
                        gen, train, check)
                    if len(group) > 1:
                        fused += len(group)
                    for k, v in out.items():
                        acc.setdefault(k, []).append(v)
                    count += len(group)

                with tracing.span("loop.phase_end"):
                    sums = _phase_sums(acc)  # the phase's one host sync
                    phase_dt = time.perf_counter() - phase_t0
                    if K > 1:
                        print(f"epoch {epoch}, {phase} phase: {count} "
                              f"steps, {fused} of them in {fused // K} "
                              f"dispatches of {K}")
                    total_num_frames = sums.pop("num_frames", 1.0)

                    log(f"{phase} frames_per_sec",
                        total_num_frames / phase_dt, epoch)
                    log(f"{phase} epoch_seconds", phase_dt, epoch)

                    # Update expectations (reference train.py:601-607); as
                    # in the reference, E_loss_mge includes the MSE term
                    # when mse_w != 0.
                    if update_d and update_g and phase == "train":
                        E_loss_mge = (mse_w * sums.get("mse", 0.0)
                                      + mge_w * sums.get("mge", 0.0)) / N
                        E_loss_adv = sums.get("loss_adv", 0.0) / N
                        log("E(mge)", E_loss_mge, epoch)
                        log("E(adv)", E_loss_adv, epoch)
                        log("MGE/ADV loss weight",
                            E_loss_mge / max(E_loss_adv, 1e-30), epoch)

                    # Loss series (train.py:609-620)
                    for ty, enabled in [
                            ("mse", update_g), ("mge", update_g),
                            ("discriminator", cfg.update_d),
                            ("loss_real_d", cfg.update_d),
                            ("loss_fake_d", cfg.update_d),
                            ("loss_adv", update_g and cfg.update_d),
                            ("generator", update_g)]:
                        if enabled and ty in sums:
                            log(f"{phase} {ty} loss", sums[ty] / N, epoch)

                    # Distortion metrics (train.py:622-625)
                    for k in ("mcd", "bap_mcd", "f0_rmse", "vuv_err",
                              "dur_rmse"):
                        if k in sums:
                            log(f"{phase} {k} metric", sums[k] / N, epoch)

                    # D accuracy (train.py:627-632)
                    if cfg.update_d:
                        log(f"Real {phase} acc",
                            sums.get("real_correct_count", 0.0)
                            / total_num_frames, epoch)
                        log(f"Fake {phase} acc",
                            sums.get("fake_correct_count", 0.0)
                            / total_num_frames, epoch)

                    # Spoofing rate (train.py:634-637)
                    if cfg.has_ref:
                        log(f"{phase} spoofing rate",
                            sums.get("regard_fake_as_natural", 0.0)
                            / total_num_frames, epoch)

        if prof is not None:
            traced = _stop_profile(prof, profile_dir, epoch)

        if writer is not None:
            writer.flush()

        if checkpoint_dir is not None and epoch % CHECKPOINT_INTERVAL == 0:
            for state, enabled, name in [(gstate, update_g, "Generator"),
                                         (dstate, cfg.update_d,
                                          "Discriminator")]:
                if enabled:
                    save_checkpoint(state, epoch, checkpoint_dir, name)

    if profile_dir is not None and traced is None:
        print(f"No profile written: the trace is of the run's second epoch, "
              f"and this run trains {max(hp.nepoch - global_epoch, 0)} "
              f"epoch(s)")
    return gstate, dstate, hp.nepoch
