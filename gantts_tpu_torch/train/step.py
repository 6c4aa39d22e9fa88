"""The GAN training step (counterpart of gantts_tpu/train/step.py).

One ``GanTrainer.step`` runs, in the JAX package's order:

  1. the generator forward, once, on the linguistic input or, with
     ``add_noise``, on [x | z] for the caller's noise z;
  2. with ``has_ref``, the spoofing rate: frames whose selected static
     stream a frozen reference discriminator takes for natural;
  3. the discriminator update on real features and the detached fake, both
     in one discriminator call;
  4. the generator update: masked MSE + MGE + the adversarial loss taken
     through the just-updated discriminator, whose parameters receive no
     gradient from it (the JAX package's fix of the reference's D-gradient
     leak, PARITY.md "Consciously changed" 1);
  5. distortion metrics on the detached outputs, every batch.

The generator forward follows the model's protocol: an In2Out generator
(the VC bundle's) takes R and the lengths and applies MLPG itself, returning
(y_hat, y_hat_static); any other generator's output goes through
``multi_stream_mlpg``, or with ``mlpg_impl="stencil"`` and T >= 4*24+2
through the stencil MLPG of ``core/fast_mlpg.py``, from the trainer's
``windows``.  In2Out generators take the dense R in training, as in the JAX
package; the stencil reaches them through synthesis.

The step returns its losses and counts as 0-dim device tensors, so nothing
waits for the device until the caller reads them.  The adversarial weight
may be a float or a 0-dim float32 tensor (the training loop uploads it once
a phase, and a CUDA graph reads it from there); the product is the same.
``GanTrainer.multi_step`` takes K same-shape batches stacked on a leading
axis: on the card one replay of a CUDA graph of K steps (train/graphs.py),
elsewhere K eager steps, which are its reference.

Data parallelism (``gantts_tpu_torch.parallel``) enters through four seams
that are the identity here: the rows of a global batch a trainer steps on
(``put_batch``), sums over the group (``_global_sum`` for the global
batch's valid frames, ``_global_sums`` for the losses, counts and the
metrics' numerators and denominators, in one collective), and the
gradients' sum between ``backward()`` and the optimizer (``_reduce_grads``).
Every loss is this batch's sum over the global batch's valid frames, so the
sums over the group are the single-device step's on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from gantts_tpu_torch.core.fast_mlpg import (
    DEFAULT_HALFWIDTH,
    multi_stream_mlpg_stencil,
)
from gantts_tpu_torch.core.masking import masked_mse_loss, sequence_mask
from gantts_tpu_torch.core.paramgen import multi_stream_mlpg
from gantts_tpu_torch.core.streams import (
    get_static_features,
    get_static_stream_sizes,
    select_streams,
)
from gantts_tpu_torch.models import include_parameter_generation
from gantts_tpu_torch.models.common import batch_view
from gantts_tpu_torch.train import metrics as M

EPS = 1e-20


def _safe_log(p):
    """log(max(p, EPS)): the reference's log(p + eps) without the
    reassociation hazard, and with a zero gradient in the clamped region."""
    return torch.log(torch.clamp_min(p, EPS))


@dataclasses.dataclass
class TrainState:
    """A model and the optimizer that updates it, both mutated in place."""

    model: Any
    optimizer: Any


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration distilled from an hparams bundle."""

    name: str                      # "vc" | "duration" | "acoustic"
    stream_sizes: tuple
    has_dynamic_features: tuple
    num_windows: int
    adversarial_streams: Optional[tuple]
    mask_nth_mgc_for_adv_loss: int
    discriminator_linguistic_condition: bool
    order: int = 59
    mse_w: float = 0.0
    mge_w: float = 1.0
    update_d: bool = True
    update_g: bool = True
    use_adv: bool = True           # w_d > 0
    has_ref: bool = False
    add_noise: bool = False
    mlpg_impl: str = "dense"

    @classmethod
    def from_hparams(cls, hp, w_d, mse_w, mge_w, update_d, update_g,
                     has_ref=False):
        return cls(
            name=hp.name,
            stream_sizes=tuple(hp.stream_sizes),
            has_dynamic_features=tuple(hp.has_dynamic_features),
            num_windows=len(hp.windows),
            adversarial_streams=(tuple(hp.adversarial_streams)
                                 if hp.adversarial_streams is not None
                                 else None),
            mask_nth_mgc_for_adv_loss=hp.mask_nth_mgc_for_adv_loss,
            discriminator_linguistic_condition=(
                hp.discriminator_linguistic_condition),
            order=getattr(hp, "order", 59),
            mse_w=mse_w, mge_w=mge_w,
            update_d=update_d and w_d > 0,
            update_g=update_g,
            use_adv=w_d > 0,
            has_ref=has_ref,
            add_noise=hp.generator_add_noise,
            mlpg_impl=getattr(hp, "mlpg_impl", "dense"),
        )

    @property
    def has_dynamic(self):
        return any(self.has_dynamic_features)

    @property
    def static_stream_sizes(self):
        return tuple(int(s) for s in get_static_stream_sizes(
            self.stream_sizes, self.has_dynamic_features, self.num_windows))


def get_selected_static_stream(y_static, cfg: StepConfig):
    """Adversarial stream selection + leading-mgc masking."""
    y_sel = select_streams(y_static, cfg.static_stream_sizes,
                           streams=cfg.adversarial_streams)
    if cfg.mask_nth_mgc_for_adv_loss > 0:
        y_sel = y_sel[..., cfg.mask_nth_mgc_for_adv_loss:]
    return y_sel


def _split_streams_inv_scale(y_static, Y_mean, Y_std, cfg: StepConfig):
    """Split acoustic statics and denormalize each stream.  The stats are
    indexed in the static+dynamic domain; statics lead each stream."""
    mgc_dim, lf0_dim, vuv_dim, bap_dim = cfg.stream_sizes
    K = cfg.num_windows
    lf0_start = mgc_dim
    vuv_start = lf0_start + lf0_dim
    bap_start = vuv_start + vuv_dim
    s_mgc, s_lf0, s_vuv, s_bap = cfg.static_stream_sizes

    mgc = y_static[..., :s_mgc]
    lf0 = y_static[..., s_mgc:s_mgc + s_lf0]
    vuv = y_static[..., s_mgc + s_lf0]
    bap = y_static[..., s_mgc + s_lf0 + s_vuv:]

    mgc = mgc * Y_std[:mgc_dim // K] + Y_mean[:mgc_dim // K]
    lf0 = lf0 * Y_std[lf0_start:lf0_start + lf0_dim // K] + \
        Y_mean[lf0_start:lf0_start + lf0_dim // K]
    bap = bap * Y_std[bap_start:bap_start + bap_dim // K] + \
        Y_mean[bap_start:bap_start + bap_dim // K]
    vuv = vuv * Y_std[vuv_start] + Y_mean[vuv_start]
    vuv = (vuv > 0.5).float()
    return mgc, lf0, vuv, bap


def distortion_sums(y_static, y_hat_static, Y_mean, Y_std, mask,
                    cfg: StepConfig):
    """The numerator and denominator of each distortion metric of one
    batch, on the device: name -> (num, den)."""
    if cfg.name == "acoustic":
        mgc, lf0, vuv, bap = _split_streams_inv_scale(
            y_static, Y_mean, Y_std, cfg)
        mgc_h, lf0_h, vuv_h, bap_h = _split_streams_inv_scale(
            y_hat_static, Y_mean, Y_std, cfg)
        return {
            "mcd": M.melcd_sums(mgc[..., 1:], mgc_h[..., 1:], mask),
            "bap_mcd": M.melcd_sums(bap, bap_h, mask),
            "f0_rmse": M.lf0_sums(lf0, vuv, lf0_h, vuv_h, mask,
                                  linear_domain=True),
            "vuv_err": M.vuv_sums(vuv, vuv_h, mask),
        }
    elif cfg.name == "duration":
        a = y_static * Y_std + Y_mean
        b = y_hat_static * Y_std + Y_mean
        return {"dur_rmse": M.mse_sums(a, b, mask)}
    elif cfg.name == "vc":
        sd = cfg.order
        a = y_static * Y_std[:sd] + Y_mean[:sd]
        b = y_hat_static * Y_std[:sd] + Y_mean[:sd]
        return {"mcd": M.melcd_sums(a, b, mask)}
    raise ValueError(f"Unknown step config name {cfg.name!r}")


class _frozen:
    """Context in which a module's parameters take no gradient."""

    def __init__(self, module):
        self.params = [p for p in module.parameters() if p.requires_grad]

    def __enter__(self):
        for p in self.params:
            p.requires_grad_(False)

    def __exit__(self, *exc):
        for p in self.params:
            p.requires_grad_(True)


class GanTrainer:
    """Static step configuration plus denormalization stats; the models and
    optimizers travel in the ``TrainState``s passed to ``step``.
    ``model_ref``, required when ``cfg.has_ref``, is the frozen reference
    discriminator (weights loaded), run in eval mode without gradient.
    ``windows`` serves ``mlpg_impl="stencil"`` only; without them the step
    takes the dense R, as the JAX package's does."""

    # the loop may run K same-shape steps as one dispatch (multi_step)
    supports_multi_step = True

    def __init__(self, cfg: StepConfig, Y_mean, Y_std, device,
                 model_ref=None, windows=None):
        if cfg.has_ref and model_ref is None:
            raise ValueError("has_ref needs the reference discriminator "
                             "(model_ref)")
        self.model_ref = model_ref.eval() if model_ref is not None else None
        self.cfg = cfg
        self.windows = windows
        self.device = torch.device(device)
        self.Y_mean = torch.as_tensor(Y_mean, dtype=torch.float32,
                                      device=self.device)
        self.Y_std = torch.as_tensor(Y_std, dtype=torch.float32,
                                     device=self.device)
        self._graphs = None

    def _gen_forward(self, model_g, x, R, lengths, generator):
        if include_parameter_generation(model_g):
            return model_g(x, R, lengths, generator=generator)
        y_hat = model_g(x, lengths, generator=generator)
        return y_hat, self._mlpg(y_hat, R)

    def _mlpg(self, y_hat, R):
        cfg = self.cfg
        if (cfg.mlpg_impl == "stencil" and self.windows is not None
                and y_hat.shape[1] >= 4 * DEFAULT_HALFWIDTH + 2):
            return multi_stream_mlpg_stencil(
                y_hat, self.windows, cfg.stream_sizes,
                cfg.has_dynamic_features)
        return multi_stream_mlpg(y_hat, R, cfg.stream_sizes,
                                 cfg.has_dynamic_features)

    def step(self, gstate, dstate, x, y, lengths, R, adv_w, generator=None,
             train=True, z=None):
        """One step on a (B, T, ·) batch; updates the states in place when
        ``train`` and returns ``(gstate, dstate, out)``.  ``z`` (B, T,
        noise_dim) is the generator's input noise when ``cfg.add_noise``."""
        if self.cfg.add_noise and z is None:
            raise ValueError("add_noise needs the generator input noise z")
        with torch.set_grad_enabled(train):
            return self._step(gstate, dstate, x, y, lengths, R, adv_w,
                              generator, train, z)

    def multi_step(self, gstate, dstate, xs, ys, lengths, R, adv_w,
                   generator=None, train=True, zs=None):
        """K steps on K same-shape batches stacked on a leading axis (xs
        (K, B, T, ·), ys, lengths (K, B), zs), in order, with the generator
        drawn as K ``step`` calls draw it; returns ``(gstate, dstate,
        outs)`` with each of ``outs`` (K,).  On a CUDA device the K steps
        are one replay of a CUDA graph (captured at a dispatch of new
        shapes; the states must have taken an eager step first), and the
        inputs may lie on the host (pinned: copied without blocking);
        elsewhere they are K eager steps."""
        if self.device.type == "cuda":
            if self._graphs is None:
                from gantts_tpu_torch.train.graphs import StepGraphs

                self._graphs = StepGraphs(self.device)
            return gstate, dstate, self._graphs.run(
                self, gstate, dstate, xs, ys, lengths, R, adv_w, generator,
                train, zs)
        outs = [self.step(gstate, dstate, xs[k], ys[k], lengths[k], R, adv_w,
                          generator=generator, train=train,
                          z=None if zs is None else zs[k])[2]
                for k in range(xs.shape[0])]
        return gstate, dstate, {key: torch.stack([o[key] for o in outs])
                                for key in outs[0]}

    # The data-parallel seams (parallel.DataParallelGanTrainer): on one
    # device each is the identity.
    def put_batch(self, x, y, lengths, z=None):
        """The rows of a global host batch that this trainer steps on: all
        of them."""
        return x, y, lengths, z

    def _global_sum(self, t):
        """``t`` summed over the data-parallel group."""
        return t

    def _global_sums(self, values):
        """``values`` (name -> 0-dim tensor), each summed over the group in
        one collective; on one device they stay as they are."""
        return values

    def _reduce_grads(self, module):
        """Between ``backward()`` and the optimizer's step: the module's
        gradients summed over the group (nothing on one device)."""

    def _step(self, gstate, dstate, x, y, lengths, R, adv_w, generator,
              train, z):
        cfg = self.cfg
        model_g, model_d = gstate.model, dstate.model
        model_g.train(train)
        model_d.train(train)
        T = x.shape[1]
        mask = sequence_mask(lengths, T)[..., None]
        # The global batch's valid frames.  Every loss and count below is
        # this batch's share of a sum over the global batch, so summing the
        # shares (and the gradients) over a data-parallel group gives the
        # single-device step on the global batch.
        Tm = self._global_sum(torch.sum(mask))
        y_static = get_static_features(
            y, cfg.num_windows, cfg.stream_sizes, cfg.has_dynamic_features)

        # 1. generator forward
        gen_in = torch.cat([x, z], dim=-1) if cfg.add_noise else x
        y_hat, y_hat_static = self._gen_forward(model_g, gen_in, R, lengths,
                                                generator)
        out = {"num_frames": torch.sum(lengths)}

        # 2. spoofing rate against the frozen reference discriminator
        if cfg.has_ref:
            with torch.no_grad():
                y_ref = y_hat_static.detach()
                if cfg.adversarial_streams is not None:
                    y_ref = get_selected_static_stream(y_ref, cfg)
                target = self.model_ref(y_ref, lengths)
            out["regard_fake_as_natural"] = torch.sum(
                (target > 0.5).float() * mask)

        def adv_input(y_sel):
            if cfg.adversarial_streams is not None:
                y_sel = get_selected_static_stream(y_sel, cfg)
            if cfg.discriminator_linguistic_condition:
                y_sel = torch.cat([x, y_sel], dim=-1)
            return y_sel

        # 3. discriminator update on real and detached fake, one D call
        if cfg.update_d:
            y_adv = adv_input(y_static)
            y_hat_adv = adv_input(y_hat_static.detach())
            B0 = y_adv.shape[0]
            D_both = model_d(torch.cat([y_adv, y_hat_adv], dim=0),
                             torch.cat([lengths, lengths]),
                             generator=batch_view(generator, parts=2))
            D_real, D_fake = D_both[:B0], D_both[B0:]
            loss_real_d = -torch.sum(_safe_log(D_real) * mask) / Tm
            loss_fake_d = -torch.sum(_safe_log(1 - D_fake) * mask) / Tm
            loss_d = loss_real_d + loss_fake_d
            if train:
                dstate.optimizer.zero_grad()
                loss_d.backward()
                self._reduce_grads(model_d)
                dstate.optimizer.step()
            out.update(
                discriminator=loss_d.detach(),
                loss_real_d=loss_real_d.detach(),
                loss_fake_d=loss_fake_d.detach(),
                real_correct_count=torch.sum((D_real > 0.5).float() * mask),
                fake_correct_count=torch.sum((D_fake < 0.5).float() * mask))

        # 4. generator update through the just-updated, frozen discriminator
        if cfg.update_g:
            loss_mge = masked_mse_loss(y_hat_static, y_static, mask=mask,
                                       denom=Tm)
            loss_mse = masked_mse_loss(y_hat, y, mask=mask, denom=Tm)
            if cfg.use_adv:
                with _frozen(model_d):
                    D_fake_g = model_d(adv_input(y_hat_static), lengths,
                                       generator=generator)
                loss_adv = -torch.sum(_safe_log(D_fake_g) * mask) / Tm
            else:
                loss_adv = torch.zeros((), device=x.device)
            loss_g = (cfg.mse_w * loss_mse + cfg.mge_w * loss_mge
                      + adv_w * loss_adv)
            if train:
                gstate.optimizer.zero_grad()
                loss_g.backward()
                self._reduce_grads(model_g)
                gstate.optimizer.step()
            out.update(mse=loss_mse.detach(), mge=loss_mge.detach(),
                       loss_adv=loss_adv.detach(), generator=loss_g.detach())

        # 5. distortion metrics, every batch: their numerators and
        # denominators summed with the losses and counts, then divided
        with torch.no_grad():
            sums = distortion_sums(y_static, y_hat_static.detach(),
                                   self.Y_mean, self.Y_std, mask, cfg)
        parts = dict(out)
        for k, (num, den) in sums.items():
            parts[f"{k}/num"], parts[f"{k}/den"] = num, den
        parts = self._global_sums(parts)
        out = {k: parts[k] for k in out}
        out.update({k: M.FROM_SUMS[k](parts[f"{k}/num"], parts[f"{k}/den"])
                    for k in sums})
        return gstate, dstate, out
