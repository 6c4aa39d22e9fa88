"""The epoch and phase training loop (counterpart of
gantts_tpu/train/loop.py).

The reference's structure: each epoch a train phase and a test phase, the
dynamic adversarial weight ``adv_w = w_d * clip(E_mge / E_adv, 0, 1e3)``
carried from one train phase to the next, the same logged series, and
``checkpoint_epoch{N}_{Generator|Discriminator}.pth`` every
CHECKPOINT_INTERVAL epochs.  As in the JAX package, the MLPG matrix R is
built once per bucketed length and kept on the device, and the per-batch
scalars stay on the device until the end of the phase: the host reads them
once per phase, so it never waits inside the batch loop.  Each phase logs its
valid frames per second and its wall time.

Randomness: the generator's input noise z comes from ``RandomState(seed)``
on the host, as in the JAX package, so both draw the same z; dropout masks
come from a ``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gantts_tpu_torch.core.windows import unit_variance_mlpg_matrix
from gantts_tpu_torch.train.checkpoint import save_checkpoint
from gantts_tpu_torch.train.optim import exp_decayed_lr, set_learning_rate

CHECKPOINT_INTERVAL = 10  # reference train.py:66


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


def _phase_sums(outs):
    """Sum each per-batch device scalar over the phase, read with one copy
    to the host."""
    keys = list(outs[0])
    stacked = torch.stack([torch.stack([o[k].double() for k in keys])
                           for o in outs])
    return dict(zip(keys, stacked.sum(0).tolist()))


def train_loop(trainer, gstate, dstate, dataset_loaders, hp, w_d=0.0,
               mse_w=0.0, mge_w=1.0, update_d=True, update_g=True,
               checkpoint_dir=None, writer=None, global_epoch=0, seed=1234):
    """Train epochs global_epoch + 1 .. hp.nepoch.  ``trainer`` is a
    GanTrainer (with its reference discriminator when ``has_ref``); the
    states are updated in place.  Returns (gstate, dstate, final_epoch)."""
    cfg = trainer.cfg
    device = trainer.device
    r_cache = RMatrixCache(hp.windows, device) if cfg.has_dynamic else None
    noise_rs = np.random.RandomState(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    E_loss_mge = 1.0
    E_loss_adv = 1.0
    log = writer.log_value if writer is not None else (lambda *a: None)

    def put(a):
        return torch.as_tensor(a, device=device)

    for epoch in range(global_epoch + 1, hp.nepoch + 1):
        # LR schedule (reference train.py:466-473)
        if hp.lr_decay_schedule and update_g:
            set_learning_rate(gstate.optimizer, exp_decayed_lr(
                hp.optimizer_g_params["lr"], epoch - 1, hp.lr_decay_epoch))
        if hp.lr_decay_schedule and update_d:
            set_learning_rate(dstate.optimizer, exp_decayed_lr(
                hp.optimizer_d_params["lr"], epoch - 1, hp.lr_decay_epoch))

        for phase in ["train", "test"]:
            train = phase == "train"
            N = len(dataset_loaders[phase])
            phase_t0 = time.perf_counter()
            adv_w = adv_weight(w_d, E_loss_mge, E_loss_adv) \
                if update_g else 0.0
            outs = []
            for x, y, lengths in dataset_loaders[phase]:
                z = (noise_rs.rand(x.shape[0], x.shape[1],
                                   hp.generator_noise_dim)
                     .astype(np.float32) if cfg.add_noise else None)
                R = r_cache.get(x.shape[1]) if r_cache is not None else None
                gstate, dstate, out = trainer.step(
                    gstate, dstate, put(x), put(y), put(lengths), R, adv_w,
                    generator=gen, train=train,
                    z=put(z) if z is not None else None)
                outs.append(out)

            sums = _phase_sums(outs)  # the phase's one host sync
            phase_dt = time.perf_counter() - phase_t0
            total_num_frames = sums.pop("num_frames", 1.0)

            log(f"{phase} frames_per_sec", total_num_frames / phase_dt, epoch)
            log(f"{phase} epoch_seconds", phase_dt, epoch)

            # Update expectations (reference train.py:601-607); as in the
            # reference, E_loss_mge includes the MSE term when mse_w != 0.
            if update_d and update_g and phase == "train":
                E_loss_mge = (mse_w * sums.get("mse", 0.0)
                              + mge_w * sums.get("mge", 0.0)) / N
                E_loss_adv = sums.get("loss_adv", 0.0) / N
                log("E(mge)", E_loss_mge, epoch)
                log("E(adv)", E_loss_adv, epoch)
                log("MGE/ADV loss weight",
                    E_loss_mge / max(E_loss_adv, 1e-30), epoch)

            # Loss series (train.py:609-620)
            for ty, enabled in [("mse", update_g),
                                ("mge", update_g),
                                ("discriminator", cfg.update_d),
                                ("loss_real_d", cfg.update_d),
                                ("loss_fake_d", cfg.update_d),
                                ("loss_adv", update_g and cfg.update_d),
                                ("generator", update_g)]:
                if enabled and ty in sums:
                    log(f"{phase} {ty} loss", sums[ty] / N, epoch)

            # Distortion metrics (train.py:622-625)
            for k in ("mcd", "bap_mcd", "f0_rmse", "vuv_err", "dur_rmse"):
                if k in sums:
                    log(f"{phase} {k} metric", sums[k] / N, epoch)

            # D accuracy (train.py:627-632)
            if cfg.update_d:
                log(f"Real {phase} acc",
                    sums.get("real_correct_count", 0.0) / total_num_frames,
                    epoch)
                log(f"Fake {phase} acc",
                    sums.get("fake_correct_count", 0.0) / total_num_frames,
                    epoch)

            # Spoofing rate (train.py:634-637)
            if cfg.has_ref:
                log(f"{phase} spoofing rate",
                    sums.get("regard_fake_as_natural", 0.0)
                    / total_num_frames, epoch)

        if writer is not None:
            writer.flush()

        if checkpoint_dir is not None and epoch % CHECKPOINT_INTERVAL == 0:
            for state, enabled, name in [(gstate, update_g, "Generator"),
                                         (dstate, cfg.update_d,
                                          "Discriminator")]:
                if enabled:
                    save_checkpoint(state, epoch, checkpoint_dir, name)

    return gstate, dstate, hp.nepoch
