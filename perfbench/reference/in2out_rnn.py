"""Plain float32 reference of the In2OutRNNHighwayNet generator (the RNN
voice-conversion model of r9y9/gantts: an LSTM trunk and a linear head,
MLPG, and a highway from the input's statics).

    h      = head(LSTM(x))                    (B, T, 3 S)
    y_hat  = x_s + sigmoid(T(x_s)) * MLPG(h)  x_s = the first S dims of x

The LSTM (torch's gate order i, f, g, o; both biases added) is masked as a
packed sequence: the output is 0 past each row's length.  Between layers
the output takes per-element dropout.  The model returns its input as its
first output, so an MSE term on it carries no gradient.  Only the
unidirectional trunk is written here.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.gan import dropout, linear, multi_stream_mlpg


def param_specs(hp):
    """The generator's weight table: (name, shape, init bound); the LSTM
    U(-1/sqrt(H), 1/sqrt(H)), the Linear layers torch's default."""
    gp = hp["generator_params"]
    if gp.get("bidirectional"):
        raise ValueError("the plain In2OutRNNHighwayNet covers one direction")
    S, H = gp["static_dim"], gp["hidden_dim"]
    specs = [("T.kernel", (S, S), 1.0 / math.sqrt(S)),
             ("T.bias", (S,), 1.0 / math.sqrt(S))]
    b, d = 1.0 / math.sqrt(H), gp["in_dim"]
    for i in range(gp["num_hidden"]):
        specs += [(f"lstm.l{i}_fwd.w_ih", (d, 4 * H), b),
                  (f"lstm.l{i}_fwd.w_hh", (H, 4 * H), b),
                  (f"lstm.l{i}_fwd.b_ih", (4 * H,), b),
                  (f"lstm.l{i}_fwd.b_hh", (4 * H,), b)]
        d = H
    return specs + [("hidden2out.kernel", (H, gp["out_dim"]), b),
                    ("hidden2out.bias", (gp["out_dim"],), b)]


def _lstm_layer(P, i, x, m):
    """One layer on time-major x (T, B, D), a step at a time."""
    T, B, D = x.shape
    w_hh = P[f"lstm.l{i}_fwd.w_hh"]
    H = w_hh.shape[0]
    xp = (x.reshape(T * B, D) @ P[f"lstm.l{i}_fwd.w_ih"]).reshape(T, B, 4 * H)
    xp = xp + (P[f"lstm.l{i}_fwd.b_ih"] + P[f"lstm.l{i}_fwd.b_hh"])
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    out = []
    for t in range(T):
        z = xp[t] + h @ w_hh
        i_g = torch.sigmoid(z[:, :H])
        f_g = torch.sigmoid(z[:, H:2 * H])
        g_g = torch.tanh(z[:, 2 * H:3 * H])
        o_g = torch.sigmoid(z[:, 3 * H:])
        c = f_g * c + i_g * g_g
        h = o_g * torch.tanh(c)
        out.append(h)
    # rows end with their padding: the carries past a length reach no
    # valid frame, and the output there is 0
    return torch.stack(out) * m


def generator(P, x, lengths, R, gen, hp):
    """(B, T, in) -> (x itself, the highway output); ``gen`` None:
    evaluation, no dropout."""
    gp = hp["generator_params"]
    out = x.transpose(0, 1)
    T = out.shape[0]
    m = (torch.arange(T, device=x.device)[:, None]
         < lengths[None, :]).float()[..., None]
    for i in range(gp["num_hidden"]):
        out = _lstm_layer(P, i, out, m)
        if gen is not None and gp["dropout"] > 0 and i < gp["num_hidden"] - 1:
            out = dropout(out, gp["dropout"], gen)
    h = linear(P, "hidden2out", out.transpose(0, 1))
    S = gp["static_dim"]
    x_s = x[..., :S]
    mlpg = multi_stream_mlpg(h, R, [h.shape[-1]], [True])
    return x, x_s + torch.sigmoid(linear(P, "T", x_s)) * mlpg
