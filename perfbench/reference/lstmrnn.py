"""Plain float32 reference of the LSTMRNN generator (r9y9/gantts
``gantts/models.py`` ``LSTMRNN``: a packed-sequence (bi)LSTM stack and a
linear head), with MLPG applied after it as the TTS step applies it.

    y_hat = head(LSTM(x))                    (B, T, out)
    return  y_hat, MLPG(y_hat)

One direction of one layer, from xp = x @ W_ih + b_ih + b_hh cut into torch's
gate blocks [i | f | g | o]:

    i, f, o = sigmoid(.),  g = tanh(.)   of xp_t + h_{t-1} @ W_hh
    c_t = f c_{t-1} + i g,   h_t = o tanh(c_t)

Where this departs from ``nn.LSTM`` with ``pack_padded_sequence``, and why
the result is the same:

  * the weights are (in, out): ``w_ih`` (D, 4H), ``w_hh`` (H, 4H), the
    port's layout and names, where ``nn.LSTM`` keeps (4H, D);
  * sequences stay padded.  The reversed direction reads each row from its
    own last frame back to its first (each row's valid frames reversed in
    place, padding left where it is), so that in both directions a row's
    valid frames are a prefix of the traversal.  The carries past a row's
    length therefore reach no valid frame and are left to run: freezing
    them, as a packed sequence does, would change nothing that is output.
    The output is 0 past each row's length;
  * both directions of a layer run as one batched recurrence, a
    (2, B, H) x (2, H, 4H) product a step, so that the reference's time
    on the card stays short;
  * between layers the output takes per-element dropout on the time-major
    (T, B, 2H) layout, drawn from the step's generator in layer order, the
    program's order; ``nn.LSTM``'s own dropout draws with torch's global
    generator.

Only the bidirectional stack is written here.  Its products run in exact
float32: ``check.reference_record`` calls it under ``gan.set_precision``
with TF32 off.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.gan import dropout, linear, multi_stream_mlpg

WAYS = ("fwd", "bwd")


def param_specs(hp):
    """The generator's weight table: (name, shape, init bound); the LSTM
    U(-1/sqrt(H), 1/sqrt(H)), the head torch's Linear init."""
    gp = hp["generator_params"]
    if not gp["bidirectional"]:
        raise ValueError("the plain LSTMRNN covers the bidirectional stack")
    H, L = gp["hidden_dim"], gp["num_hidden"]
    specs, d = [], gp["in_dim"]
    b = 1.0 / math.sqrt(H)
    for i in range(L):
        for way in WAYS:
            specs += [(f"lstm.l{i}_{way}.w_ih", (d, 4 * H), b),
                      (f"lstm.l{i}_{way}.w_hh", (H, 4 * H), b),
                      (f"lstm.l{i}_{way}.b_ih", (4 * H,), b),
                      (f"lstm.l{i}_{way}.b_hh", (4 * H,), b)]
        d = 2 * H
    bh = 1.0 / math.sqrt(d)
    return specs + [("hidden2out.kernel", (d, gp["out_dim"]), bh),
                    ("hidden2out.bias", (gp["out_dim"],), bh)]


def reversal(lengths, T):
    """(T, B) time indices that reverse each row's first ``length`` frames
    and leave its padding in place; the map is its own inverse."""
    t = torch.arange(T, device=lengths.device)[:, None]
    n = lengths.to(torch.int64)[None, :]
    return torch.where(t < n, n - 1 - t, t)


def _per_row(x, idx):
    """x (T, B, C) with each row's frames taken in the order of ``idx``."""
    return torch.gather(x, 0, idx[..., None].expand(-1, -1, x.shape[-1]))


def _layer(P, i, x, m, idx):
    """Both directions of layer i on time-major x (T, B, D): (T, B, 2H),
    the forward direction's output first."""
    T, B, D = x.shape
    xp, whh = [], []
    for way in WAYS:
        p = f"lstm.l{i}_{way}."
        u = (x.reshape(T * B, D) @ P[p + "w_ih"]).reshape(T, B, -1)
        xp.append(u + (P[p + "b_ih"] + P[p + "b_hh"]))
        whh.append(P[p + "w_hh"])
    xp = torch.stack([xp[0], _per_row(xp[1], idx)], 1)  # (T, 2, B, 4H)
    whh = torch.stack(whh)                               # (2, H, 4H)
    H = whh.shape[1]
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    out = []
    for t in range(T):
        z = xp[t] + torch.bmm(h, whh)
        i_g = torch.sigmoid(z[..., :H])
        f_g = torch.sigmoid(z[..., H:2 * H])
        g_g = torch.tanh(z[..., 2 * H:3 * H])
        o_g = torch.sigmoid(z[..., 3 * H:])
        c = f_g * c + i_g * g_g
        h = o_g * torch.tanh(c)
        out.append(h)
    y = torch.stack(out)                                 # (T, 2, B, H)
    return torch.cat([y[:, 0], _per_row(y[:, 1], idx)], dim=-1) * m


def trunk(P, x, lengths, gen, gp):
    """The LSTM stack: (B, T, in) -> (B, T, 2H), the forward direction's
    output first; ``gen`` None: no dropout."""
    out = x.transpose(0, 1)
    T = out.shape[0]
    m = (torch.arange(T, device=x.device)[:, None]
         < lengths[None, :]).to(x.dtype)[..., None]
    idx = reversal(lengths, T)
    for i in range(gp["num_hidden"]):
        out = _layer(P, i, out, m, idx)
        if gen is not None and gp["dropout"] > 0 and i < gp["num_hidden"] - 1:
            out = dropout(out, gp["dropout"], gen)
    return out.transpose(0, 1)


def generator(P, x, lengths, R, gen, hp):
    """(B, T, in) -> (the head's output y_hat, MLPG(y_hat)); ``gen`` None:
    evaluation, no dropout."""
    gp = hp["generator_params"]
    y = linear(P, "hidden2out", trunk(P, x, lengths, gen, gp))
    if gp["last_sigmoid"]:
        y = torch.sigmoid(y)
    return y, multi_stream_mlpg(y, R, hp["stream_sizes"],
                                hp["has_dynamic_features"])
