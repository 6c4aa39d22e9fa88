"""Plain float32 reference of the SRURNN generator (the TTS acoustic
model of r9y9/gantts: a stack of bidirectional SRU layers, Lei et al. 2018,
with a linear head, then MLPG).

One direction of one layer, time-major, from u = x @ W (D, 4H) cut into
[x~ | f | r | x']:

    f_t = sigmoid(u_f + b_f),  r_t = sigmoid(u_r + b_r)
    c_t = f_t c_{t-1} + (1 - f_t) x~_t
    h_t = r_t g(c_t) + (1 - r_t) x'_t,   g = relu (use_relu) or tanh

Past a row's length the state is carried unchanged and h is 0; the
reversed direction runs the same recurrence from the last frame.  Before
each layer its input takes variational dropout (rnn_dropout: one (1, B, D)
mask for every time step), and between layers the output too (dropout).
Only the bidirectional stack (every layer's input wider than H) is written
here.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.gan import (
    LinearRecurrence,
    keep_mask,
    linear,
    multi_stream_mlpg,
)


def param_specs(hp):
    """The generator's weight table: (name, shape, init bound); SRU
    parameters U(-1/sqrt(H), 1/sqrt(H)), the head torch's Linear init."""
    gp = hp["generator_params"]
    H, L = gp["hidden_dim"], gp["num_hidden"]
    dirs = ("fwd", "bwd") if gp["bidirectional"] else ("fwd",)
    if not gp["bidirectional"]:
        raise ValueError("the plain SRURNN covers the bidirectional stack")
    specs, d = [], gp["in_dim"]
    b = 1.0 / math.sqrt(H)
    for i in range(L):
        for way in dirs:
            specs += [(f"gru.l{i}_{way}.w", (d, 4 * H), b),
                      (f"gru.l{i}_{way}.bf", (H,), b),
                      (f"gru.l{i}_{way}.br", (H,), b)]
        d = H * len(dirs)
    bh = 1.0 / math.sqrt(d)
    return specs + [("hidden2out.kernel", (d, gp["out_dim"]), bh),
                    ("hidden2out.bias", (gp["out_dim"],), bh)]


def _vdrop(x, rate, gen):
    if gen is None or rate <= 0:
        return x
    mask = keep_mask((1,) + tuple(x.shape[1:]), rate, gen, x.device)
    return x * (mask.to(x.dtype) / (1.0 - rate))


def _layer(P, i, x, m, use_relu):
    """Both directions of layer i on time-major x (T, B, D); the two
    recurrences run as one."""
    T, B, D = x.shape
    a, b, r, hw = [], [], [], []
    for way in ("fwd", "bwd"):
        H = P[f"gru.l{i}_{way}.bf"].shape[0]
        u = (x.reshape(T * B, D) @ P[f"gru.l{i}_{way}.w"]).reshape(T, B, 4 * H)
        f = torch.sigmoid(u[..., H:2 * H] + P[f"gru.l{i}_{way}.bf"])
        a.append(f * m + (1.0 - m))
        b.append((1.0 - f) * u[..., :H] * m)
        r.append(torch.sigmoid(u[..., 2 * H:3 * H] + P[f"gru.l{i}_{way}.br"]))
        hw.append(u[..., 3 * H:])
    # the reversed direction as a forward recurrence over flipped time
    c = LinearRecurrence.apply(torch.stack([a[0], a[1].flip(0)], 1),
                               torch.stack([b[0], b[1].flip(0)], 1))
    c = torch.stack([c[:, 0], c[:, 1].flip(0)], 0)
    g = torch.relu(c) if use_relu else torch.tanh(c)
    h = [(r[k] * g[k] + (1.0 - r[k]) * hw[k]) * m for k in range(2)]
    return torch.cat(h, dim=-1)


def generator(P, x, lengths, R, gen, hp):
    """(B, T, in) -> (the head's output y_hat, MLPG(y_hat)); ``gen`` None:
    evaluation, no dropout."""
    gp = hp["generator_params"]
    out = x.transpose(0, 1)
    T = out.shape[0]
    m = (torch.arange(T, device=x.device)[:, None]
         < lengths[None, :]).float()[..., None]
    for i in range(gp["num_hidden"]):
        out = _layer(P, i, _vdrop(out, gp["rnn_dropout"], gen), m,
                     gp["use_relu"])
        if gp["dropout"] > 0 and i < gp["num_hidden"] - 1:
            out = _vdrop(out, gp["dropout"], gen)
    y = linear(P, "hidden2out", out.transpose(0, 1))
    if gp["last_sigmoid"]:
        y = torch.sigmoid(y)
    return y, multi_stream_mlpg(y, R, hp["stream_sizes"],
                                hp["has_dynamic_features"])
