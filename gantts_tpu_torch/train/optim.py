"""Optimizers by name, with the global-norm clip before every step
(counterpart of gantts_tpu/train/optim.py).

The JAX package re-derives torch's update rules in optax; here they are
torch.optim's:

  Adagrad  accumulator starts at 0, eps=1e-10, weight_decay added to the raw
           gradient (non-decoupled);
  Adam     eps=1e-8, (b1, b2) from ``betas``, non-decoupled weight_decay;
  SGD      optional ``momentum`` (torch's buffer, no dampening, which is
           optax's ``trace``), non-decoupled weight_decay.

A torch.optim object holds the parameter groups and the state, and its
``state_dict`` / ``load_state_dict`` are the checkpoints' (keys, layout and
a step count on the host, as torch.optim keeps them).  The update itself is
computed here, so that a CUDA graph can hold it (torch.optim's Adagrad and
SGD read the learning rate, and Adam its bias correction, as Python floats
a capture would freeze): the learning rate of each group and the step
count live on the device, as float64 scalars (torch computes them as Python
floats), the learning rate rewritten in place by ``fill_`` when a group's
``lr`` changes (``set_learning_rate``, the reference's
``exp_lr_scheduler``).  The arithmetic is torch.optim's single-tensor
update, operation for operation, with each Python scalar that changes
between steps taken from those device scalars; on the CPU it equals
torch.optim's bit for bit (tests/test_torch_dispatch.py), and on the card
the eager and the captured step run the same kernels.

Every parameter of an optimizer takes a gradient in every step (as in the
port's models), so one step count serves them all; a step that finds some
gradients missing raises, where torch.optim would advance those parameters'
counts alone.
"""

from __future__ import annotations

import torch

GRAD_CLIP_NORM = 1.0


def _capturing(device):
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class ClippedOptimizer:
    """A torch optimizer whose ``step`` first clips the global gradient norm
    of its parameters to GRAD_CLIP_NORM and keeps it in ``grad_norm`` (a
    device scalar), then applies the update rule of ``inner``.  Nothing
    here reads the norm on the host: a norm that is not finite makes a
    step that is not finite, as torch's clip does (the training loop's
    ``debug_nans`` reads the norms and the losses of a step at once)."""

    def __init__(self, inner):
        kind = type(inner).__name__
        if kind not in _UPDATES:
            raise ValueError(f"no update rule for torch.optim.{kind}")
        for group in inner.param_groups:
            for flag in ("maximize", "nesterov", "amsgrad",
                         "decoupled_weight_decay", "differentiable"):
                if group.get(flag):
                    raise ValueError(f"{kind} with {flag} is not supported")
            if group.get("dampening", 0.0):
                raise ValueError("SGD with dampening is not supported")
        self.inner = inner
        self.grad_norm = None
        self.version = 0  # counts load_state_dict: state tensors replaced
        self._update = _UPDATES[kind]
        self._device = inner.param_groups[0]["params"][0].device
        self._lr = [torch.zeros((), dtype=torch.float64, device=self._device)
                    for _ in inner.param_groups]
        self._lr_host = [None] * len(inner.param_groups)
        self._step = torch.zeros((), dtype=torch.float64, device=self._device)
        self._load_step()
        self.sync_learning_rate()

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self):
        return [p for group in self.inner.param_groups
                for p in group["params"]]

    def _load_step(self):
        steps = {float(self.inner.state[p]["step"]) for p in self._params()
                 if "step" in self.inner.state.get(p, {})}
        if len(steps) > 1:
            raise ValueError(f"the parameters' step counts differ "
                             f"({sorted(steps)}): one count serves them all")
        self._step.fill_(steps.pop() if steps else 0.0)

    def sync_learning_rate(self):
        """Write each group's ``lr`` into its device scalar where it
        changed (never while a CUDA graph is being captured: the graph
        would hold the write)."""
        for i, group in enumerate(self.inner.param_groups):
            if group["lr"] != self._lr_host[i]:
                if _capturing(self._device):
                    raise RuntimeError(
                        "the learning rate changed inside a CUDA graph "
                        "capture; set it before the capture")
                self._lr[i].fill_(group["lr"])
                self._lr_host[i] = group["lr"]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        """torch.optim's ``state_dict``, its step counts brought up to the
        device's (one host synchronisation)."""
        step = float(self._step)
        for p in self._params():
            st = self.inner.state.get(p, {})
            if "step" in st:
                st["step"].fill_(step)
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)
        self.version += 1
        self._load_step()
        self.sync_learning_rate()

    def step(self):
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return
        if len(params) != len(self._params()):
            raise ValueError(
                f"{len(self._params()) - len(params)} of the optimizer's "
                f"{len(self._params())} parameters have no gradient")
        self.grad_norm = torch.nn.utils.clip_grad_norm_(params,
                                                        GRAD_CLIP_NORM)
        self.sync_learning_rate()
        self._step.add_(1.0)
        for group, lr in zip(self.inner.param_groups, self._lr):
            ps = group["params"]
            self._update(group, ps, [p.grad for p in ps], self.inner.state,
                         lr, self._step)


def _scaled(tensors, factor64):
    """Each tensor times the float32 rounding of a float64 device scalar:
    torch's ``value=`` of a Python float, applied as a tensor."""
    return torch._foreach_mul(tensors, factor64.float())


@torch.no_grad()
def _adagrad(group, params, grads, state, lr, step):
    # torch.optim.adagrad._single_tensor_adagrad
    wd, eps = group["weight_decay"], group["eps"]
    if wd != 0:
        grads = torch._foreach_add(grads, params, alpha=wd)
    sums = [state[p]["sum"] for p in params]
    torch._foreach_addcmul_(sums, grads, grads, value=1)
    std = torch._foreach_sqrt(sums)
    torch._foreach_add_(std, eps)
    clr = lr / (1 + (step - 1) * group["lr_decay"])
    torch._foreach_addcdiv_(params, _scaled(grads, -clr), std)


@torch.no_grad()
def _adam(group, params, grads, state, lr, step):
    # torch.optim.adam._single_tensor_adam (capturable=False)
    beta1, beta2 = group["betas"]
    wd, eps = group["weight_decay"], group["eps"]
    states = [state[p] for p in params]
    for p, st in zip(params, states):
        if not st:  # torch.optim's lazy state, made by the first (eager) step
            if _capturing(p.device):
                raise RuntimeError("Adam's state must exist before a CUDA "
                                   "graph capture: take one eager step")
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
    if wd != 0:
        grads = torch._foreach_add(grads, params, alpha=wd)
    exp_avgs = [st["exp_avg"] for st in states]
    exp_avg_sqs = [st["exp_avg_sq"] for st in states]
    torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
    torch._foreach_mul_(exp_avg_sqs, beta2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1 - beta2)
    bias_correction1 = 1 - torch.pow(beta1, step)
    bias_correction2 = 1 - torch.pow(beta2, step)
    step_size = lr / bias_correction1
    # Python's ** 0.5 is pow(), not sqrt(): an exponent tensor keeps pow
    bias_correction2_sqrt = torch.pow(
        bias_correction2, torch.full_like(bias_correction2, 0.5))
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, bias_correction2_sqrt.float())
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, _scaled(exp_avgs, -step_size), denom)


@torch.no_grad()
def _sgd(group, params, grads, state, lr, step):
    # torch.optim.sgd._single_tensor_sgd (no dampening, no nesterov)
    wd, momentum = group["weight_decay"], group["momentum"]
    if wd != 0:
        grads = torch._foreach_add(grads, params, alpha=wd)
    if momentum != 0:
        states = [state[p] for p in params]
        bufs = []
        for g, st in zip(grads, states):
            buf = st.get("momentum_buffer")
            if buf is None:
                if _capturing(g.device):
                    raise RuntimeError("SGD's momentum buffers must exist "
                                       "before a CUDA graph capture: take "
                                       "one eager step")
                st["momentum_buffer"] = torch.clone(g).detach()
            else:
                bufs.append((buf, g))
        if bufs:
            torch._foreach_mul_([b for b, _ in bufs], momentum)
            torch._foreach_add_([b for b, _ in bufs], [g for _, g in bufs])
        grads = [st["momentum_buffer"] for st in states]
    # param.add_(grad, alpha=-lr) is one fused multiply-add; so is addcmul
    neg = (-lr).float()
    torch._foreach_addcmul_(params, grads, [neg] * len(params))


_UPDATES = {"Adagrad": _adagrad, "Adam": _adam, "SGD": _sgd}


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
    """Rewrite the learning rate of every parameter group (on the device
    too)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.sync_learning_rate()
    return optimizer


def exp_decayed_lr(init_lr, epoch, lr_decay_epoch):
    """lr * 0.1**(epoch // lr_decay_epoch)."""
    return init_lr * (0.1 ** (epoch // lr_decay_epoch))
