"""Plain float32 reference of the GAN curriculum's adversarial training step.

Written from the published recipe (r9y9/gantts ``train.py`` and
``hparams.py``, Saito et al. 2018) in plain PyTorch, with nothing of the
program under test imported: the data split and batch order, the
normalization statistics, the MLPG matrix, the discriminator, the losses,
the global-norm clip and Adagrad are all worked out here again.  The
generator of each family lives beside this file (``srurnn.py``,
``in2out_rnn.py``); a configuration file names its family.

Dropout masks: the step draws every mask with ``torch.rand(shape,
generator=g) < keep`` from one ``torch.Generator`` seeded with the loop's
seed, in the order the recipe applies dropout (the generator's layers, then
the discriminator on [real | fake], then the discriminator on the fake for
the generator's loss).  This reference draws the same shapes in the same
order from its own generator on the same device seeded with the same
number, so both reach the same Philox stream and the same masks.

Parameters are held in a dict, name -> float32 tensor, under the names of
the benchmark's weight table (``param_specs`` of each family), so that one
set of seed-made weights serves both sides.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS_LOG = 1e-20       # log(max(p, 1e-20)) in the adversarial losses
CLIP_NORM = 1.0       # global gradient-norm clip before every update
ADAGRAD_EPS = 1e-10   # torch.optim.Adagrad's default
TEST_SIZE = 0.112     # train.py's train_test_split(test_size=0.112,
SPLIT_STATE = 1234    # random_state=1234)
SHUFFLE_SEED = 1234   # the batch shuffle: RandomState(1234 + epoch)


def set_precision(tf32):
    """float32 products exactly (``tf32=False``), or in TF32 (the control);
    returns the previous settings for ``restore_precision``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    return old


def restore_precision(old):
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# Data: split, statistics, normalization, batches
# ---------------------------------------------------------------------------


def split(n):
    """(train, test) utterance indices as sklearn's ``train_test_split(
    range(n), test_size=0.112, random_state=1234)`` draws them: the first
    ceil(0.112 n) of ``RandomState(1234).permutation(n)`` are the test
    set, the rest the training set."""
    n_test = math.ceil(TEST_SIZE * n)
    perm = np.random.RandomState(SPLIT_STATE).permutation(n)
    return perm[n_test:], perm[:n_test]


def batch_indices(n, batch_size, epoch, shuffle=True):
    """Positions (into the phase's utterance list) of each batch of an
    epoch: shuffled by ``RandomState(1234 + epoch)``, in order."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(SHUFFLE_SEED + epoch).shuffle(order)
    return [order[i:i + batch_size] for i in range(0, n, batch_size)]


def _nonzero(v):
    return np.where(v == 0, 1.0, v)


def stats(X_train, Y_train, kind):
    """Normalization statistics from the training utterances, float64:
    ``tts`` min/max of X and mean/population variance of Y; ``vc`` one
    pooled mean/variance over every frame of X and Y."""
    if kind == "tts":
        X = np.concatenate(X_train).astype(np.float64)
        Y = np.concatenate(Y_train).astype(np.float64)
        return dict(x_min=X.min(0), x_max=X.max(0), y_mean=Y.mean(0),
                    y_std=np.sqrt(Y.var(0)))
    Z = np.concatenate(list(X_train) + list(Y_train)).astype(np.float64)
    mean, std = Z.mean(0), np.sqrt(Z.var(0))
    return dict(x_mean=mean, x_std=std, y_mean=mean, y_std=std)


def normalize(x, y, st):
    """One utterance: X min-max scaled into (0.01, 0.99) (tts) or
    z-scored (vc), Y z-scored; float32."""
    x = np.asarray(x, np.float64)
    if "x_min" in st:
        scale = 0.98 / _nonzero(st["x_max"] - st["x_min"])
        x = (x - st["x_min"]) * scale + 0.01
    else:
        x = (x - st["x_mean"]) / _nonzero(st["x_std"])
    y = (np.asarray(y, np.float64) - st["y_mean"]) / _nonzero(st["y_std"])
    return x.astype(np.float32), y.astype(np.float32)


def make_batch(items, batch_size, multiple):
    """Pad a list of (x, y) to (B, round_up(max length, multiple), .) with
    zero frames, and to ``batch_size`` rows with rows of length 0."""
    lengths = np.zeros(batch_size, np.int64)
    lengths[:len(items)] = [len(x) for x, _ in items]
    T = -(-int(lengths.max()) // multiple) * multiple
    x = np.zeros((batch_size, T, items[0][0].shape[1]), np.float32)
    y = np.zeros((batch_size, T, items[0][1].shape[1]), np.float32)
    for k, (xi, yi) in enumerate(items):
        x[k, :len(xi)] = xi
        y[k, :len(yi)] = yi
    return x, y, lengths


# ---------------------------------------------------------------------------
# MLPG
# ---------------------------------------------------------------------------


def window_matrix(window, T):
    """Dense T x T matrix of a window (l, u, coeffs): W[t, t + k] =
    coeffs[l + k], taps outside [0, T) dropped."""
    l, u, coeffs = window
    W = np.zeros((T, T))
    for k in range(-l, u + 1):
        t = np.arange(max(0, -k), min(T, T - k))
        W[t, t + k] = coeffs[l + k]
    return W


def mlpg_matrix(windows, T, device, dtype=torch.float32):
    """R = (sum_k W_k^T W_k)^{-1} [W_0^T | ... | W_{K-1}^T], (T, K T), the
    maximum-likelihood static trajectory under unit variances as one
    matrix; solved in float64, returned in ``dtype``."""
    Ws = [torch.as_tensor(window_matrix(w, T), device=device)
          for w in windows]
    P = sum(W.T @ W for W in Ws)
    R = torch.linalg.solve(P, torch.cat([W.T for W in Ws], dim=1))
    return R.to(dtype)


def multi_stream_mlpg(y, R, stream_sizes, has_dynamic):
    """Each dynamic stream of (B, T, .) features, laid out window-major,
    through R; static-only streams pass."""
    B, T, _ = y.shape
    K = R.shape[1] // R.shape[0]
    out, start = [], 0
    for size, dyn in zip(stream_sizes, has_dynamic):
        x = y[..., start:start + size]
        if dyn:
            S = size // K
            m = x.reshape(B, T, K, S).permute(0, 2, 1, 3).reshape(B, K * T, S)
            x = torch.matmul(R, m)
        out.append(x)
        start += size
    return torch.cat(out, dim=-1)


def static_features(y, stream_sizes, has_dynamic, K):
    """The static block that leads each stream."""
    out, start = [], 0
    for size, dyn in zip(stream_sizes, has_dynamic):
        out.append(y[..., start:start + (size // K if dyn else size)])
        start += size
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def keep_mask(shape, rate, gen, device):
    """A Bernoulli(1 - rate) keep-mask drawn as ``rand < 1 - rate``."""
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout(x, rate, gen):
    """Per-element dropout, kept values scaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def linear(P, name, x):
    """x @ kernel + bias, the kernel (in, out)."""
    return x @ P[f"{name}.kernel"] + P[f"{name}.bias"]


def mlp(P, x, gen, hp):
    """The per-frame discriminator: hidden layers of Linear, leaky ReLU
    (slope 0.01) and dropout, then a Linear to one output and a sigmoid.
    ``gen`` None: no dropout (evaluation)."""
    dp = hp["discriminator_params"]
    h = x
    for i in range(dp["num_hidden"]):
        h = F.leaky_relu(linear(P, f"layers_{i}", h), 0.01)
        if gen is not None and dp["dropout"] > 0:
            h = dropout(h, dp["dropout"], gen)
    h = linear(P, "last_linear", h)
    return torch.sigmoid(h) if dp["last_sigmoid"] else h


def mlp_specs(hp):
    """The discriminator's weight table: (name, shape, init bound), torch's
    default init U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    dp = hp["discriminator_params"]
    specs, d = [], dp["in_dim"]
    for i in range(dp["num_hidden"]):
        b = 1.0 / math.sqrt(d)
        specs += [(f"layers_{i}.kernel", (d, dp["hidden_dim"]), b),
                  (f"layers_{i}.bias", (dp["hidden_dim"],), b)]
        d = dp["hidden_dim"]
    b = 1.0 / math.sqrt(d)
    return specs + [("last_linear.kernel", (d, dp["out_dim"]), b),
                    ("last_linear.bias", (dp["out_dim"],), b)]


class LinearRecurrence(torch.autograd.Function):
    """c_t = a_t c_{t-1} + b_t along axis 0 from c_{-1} = 0, a step at a
    time, and its adjoint: g^_t = g_t + a_{t+1} g^_{t+1}, db = g^,
    da_t = g^_t c_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        c, prev = [], torch.zeros_like(b[0])
        for t in range(a.shape[0]):
            prev = torch.addcmul(b[t], a[t], prev)
            c.append(prev)
        c = torch.stack(c)
        ctx.save_for_backward(a, c)
        return c

    @staticmethod
    def backward(ctx, gc):
        a, c = ctx.saved_tensors
        T = a.shape[0]
        acc = gc[T - 1]
        ghat = [acc]
        for t in range(T - 2, -1, -1):
            acc = torch.addcmul(gc[t], a[t + 1], acc)
            ghat.append(acc)
        ghat = torch.stack(ghat[::-1])
        c_prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
        return ghat * c_prev, ghat


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def sequence_mask(lengths, T):
    """(B, T, 1) float mask of valid frames."""
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).float()[..., None]


def adversarial_input(y_static, x, hp):
    """The discriminator's input: the adversarial streams' statics less
    their first ``mask_nth_mgc_for_adv_loss`` dims, after the linguistic
    features when the discriminator is conditioned on them."""
    K = len(hp["windows"])
    sizes = [s // K if d else s for s, d in zip(hp["stream_sizes"],
                                                 hp["has_dynamic_features"])]
    parts, start = [], 0
    for size, on in zip(sizes, hp["adversarial_streams"]):
        if on:
            parts.append(y_static[..., start:start + size])
        start += size
    y = torch.cat(parts, dim=-1)[..., hp["mask_nth_mgc_for_adv_loss"]:]
    if hp["discriminator_linguistic_condition"]:
        y = torch.cat([x, y], dim=-1)
    return y


def masked_mse(a, b, mask, denom):
    d = (a - b) * mask
    return torch.sum(d * d) / denom


def _neg_log(p, mask, denom):
    return -torch.sum(torch.log(torch.clamp_min(p, EPS_LOG)) * mask) / denom


class Adagrad:
    """Clip the global gradient norm to 1, add weight decay to the
    gradient, then Adagrad from a zero accumulator.  ``step`` returns the
    gradients as the update reads them."""

    def __init__(self, params, lr, weight_decay):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.sums = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads):
        total = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        coef = torch.clamp(CLIP_NORM / (total + 1e-6), max=1.0)
        used = {}
        for k, p in self.params.items():
            g = grads[k] * coef + self.wd * p
            self.sums[k] += g * g
            p -= self.lr * g / (torch.sqrt(self.sums[k]) + ADAGRAD_EPS)
            used[k] = g
        return used


class GanStep:
    """The adversarial step of the curriculum's fifth stage (w_d > 0, both
    updates): the generator forward once, the discriminator's update on
    [real | detached fake], then the generator's on its masked MGE (and
    MSE) loss plus ``adv_w`` times the adversarial loss through the updated
    discriminator, whose parameters take no gradient from it.  ``dtype``:
    the arithmetic's (the weights' and the data's); ``update`` False: the
    optimizers leave the state unchanged (a fault)."""

    def __init__(self, generator, G, D, hp, run, device, dtype=torch.float32,
                 update=True):
        self.generator, self.G, self.D = generator, G, D
        self.hp, self.run, self.device = hp, run, device
        self.dtype, self.update = dtype, update
        self.opt_g = Adagrad(G, hp["optimizer_g_params"]["lr"],
                             hp["optimizer_g_params"]["weight_decay"])
        self.opt_d = Adagrad(D, hp["optimizer_d_params"]["lr"],
                             hp["optimizer_d_params"]["weight_decay"])
        self._R = {}

    def R(self, T):
        if T not in self._R:
            self._R[T] = mlpg_matrix(self.hp["windows"], T, self.device,
                                     self.dtype)
        return self._R[T]

    def __call__(self, x, y, lengths, gen, adv_w):
        """One training step on host arrays; returns (losses, the
        generator's and the discriminator's gradients as their updates
        read them)."""
        hp, run = self.hp, self.run
        dev = self.device
        x = torch.as_tensor(x, device=dev).to(self.dtype)
        y = torch.as_tensor(y, device=dev).to(self.dtype)
        lengths = torch.as_tensor(lengths, device=dev)
        T = x.shape[1]
        mask = sequence_mask(lengths, T).to(self.dtype)
        Tm = torch.sum(mask)
        K = len(hp["windows"])
        y_static = static_features(y, hp["stream_sizes"],
                                   hp["has_dynamic_features"], K)
        G = {k: v.requires_grad_(True) for k, v in self.G.items()}
        y_first, y_hat_static = self.generator(G, x, lengths, self.R(T), gen,
                                               hp)

        # the discriminator's update
        D = {k: v.requires_grad_(True) for k, v in self.D.items()}
        real = adversarial_input(y_static, x, hp)
        fake = adversarial_input(y_hat_static.detach(), x, hp)
        B = real.shape[0]
        both = mlp(D, torch.cat([real, fake]), gen, hp)
        loss_real = _neg_log(both[:B], mask, Tm)
        loss_fake = _neg_log(1 - both[B:], mask, Tm)
        loss_d = loss_real + loss_fake
        grads_d = dict(zip(D, torch.autograd.grad(loss_d, list(D.values()))))
        used_d = self.opt_d.step(grads_d) if self.update else \
            {k: torch.zeros_like(v) for k, v in grads_d.items()}

        # the generator's update through the updated, frozen discriminator
        D_frozen = {k: v.detach() for k, v in self.D.items()}
        loss_mge = masked_mse(y_hat_static, y_static, mask, Tm)
        loss_mse = masked_mse(y_first, y, mask, Tm)
        p = mlp(D_frozen, adversarial_input(y_hat_static, x, hp), gen, hp)
        loss_adv = _neg_log(p, mask, Tm)
        loss_g = (run["mse_w"] * loss_mse + run["mge_w"] * loss_mge
                  + adv_w * loss_adv)
        params = [v for v in G.values()]
        grads = torch.autograd.grad(loss_g, params, allow_unused=True)
        grads_g = {k: torch.zeros_like(v) if g is None else g
                   for (k, v), g in zip(G.items(), grads)}
        used_g = self.opt_g.step(grads_g) if self.update else \
            {k: torch.zeros_like(v) for k, v in grads_g.items()}
        for v in list(self.G.values()) + list(self.D.values()):
            v.requires_grad_(False)
        losses = {k: float(v.detach()) for k, v in (
            ("discriminator", loss_d), ("generator", loss_g),
            ("mge", loss_mge), ("loss_adv", loss_adv))}
        return losses, used_g, used_d
