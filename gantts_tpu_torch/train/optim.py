"""Optimizers by name, with the global-norm clip before every step
(counterpart of gantts_tpu/train/optim.py).

The JAX package re-derives torch's update rules in optax; here they are
torch.optim itself:

  Adagrad  accumulator starts at 0, eps=1e-10, weight_decay added to the raw
           gradient (non-decoupled);
  Adam     eps=1e-8, (b1, b2) from ``betas``, non-decoupled weight_decay;
  SGD      optional ``momentum`` (torch's buffer, no dampening, which is
           optax's ``trace``), non-decoupled weight_decay.

The learning rate lives in ``param_groups`` and is rewritten between steps
by ``set_learning_rate`` (the reference's ``exp_lr_scheduler``).
"""

from __future__ import annotations

import torch

GRAD_CLIP_NORM = 1.0


class ClippedOptimizer:
    """A torch optimizer whose ``step`` first clips the global gradient norm
    of its parameters to GRAD_CLIP_NORM.  With ``check_finite`` set to the
    name of what it updates (the loop's ``debug_nans``), a norm that is not
    finite raises ``FloatingPointError`` instead, at the cost of one host
    synchronisation a step."""

    def __init__(self, inner):
        self.inner = inner
        self.check_finite = None

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)

    def step(self):
        params = [p for group in self.inner.param_groups
                  for p in group["params"] if p.grad is not None]
        try:
            torch.nn.utils.clip_grad_norm_(
                params, GRAD_CLIP_NORM,
                error_if_nonfinite=self.check_finite is not None)
        except RuntimeError as e:
            if self.check_finite is None or "non-finite" not in str(e):
                raise
            raise FloatingPointError(
                f"the {self.check_finite}'s gradient norm is not finite") \
                from e
        self.inner.step()


def create_optimizer(name, params_dict, parameters):
    """Build the named optimizer over ``parameters`` from the torch kwargs of
    the hparams bundles (``lr``, ``weight_decay``, ``betas``)."""
    kwargs = dict(params_dict)
    lr = kwargs.pop("lr")
    wd = kwargs.pop("weight_decay", 0.0)
    params = list(parameters)
    if name == "Adagrad":
        inner = torch.optim.Adagrad(params, lr=lr, weight_decay=wd,
                                    initial_accumulator_value=0.0, eps=1e-10)
    elif name == "Adam":
        betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
        inner = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=wd)
    elif name in ("SGD", "Sgd"):
        inner = torch.optim.SGD(params, lr=lr,
                                momentum=kwargs.pop("momentum", 0.0),
                                weight_decay=wd)
    else:
        raise ValueError(
            f"Unknown optimizer {name!r} (Adagrad/Adam/SGD supported)")
    if kwargs:
        raise ValueError(f"Unsupported {name} kwargs: {sorted(kwargs)}")
    return ClippedOptimizer(inner)


def set_learning_rate(optimizer, lr):
    """Rewrite the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def exp_decayed_lr(init_lr, epoch, lr_decay_epoch):
    """lr * 0.1**(epoch // lr_decay_epoch)."""
    return init_lr * (0.1 ** (epoch // lr_decay_epoch))
