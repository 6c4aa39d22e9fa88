"""Corpora made from a traffic file and a seed, in memory.

Lengths: a traffic file states how many utterances there are and their
frame counts: ``fixed``, one count; ``listed``, each utterance's count in
the file (a real corpus's); ``lognormal``, the distribution's quantiles at
(i + 1/2) / n under a permutation fixed by the file.  Every seed gets the
same lengths in the same order, so every seed trains on the same batch
shapes and does the same work; the seed draws the feature values and the
weights.

Features: drawn on the device from the seed, smoothed along time (a 21-tap
Hann window), then copied to the host once and cut into utterances:

  ``tts``  X: binary linguistic answers held over phone-like segments
           (``question_dim`` of them) and smooth frame features; Y: static
           mel-cepstra, log F0, a voiced flag and aperiodicity, with the
           deltas and delta-deltas of the configuration's windows;
  ``vc``   X and Y: static mel-cepstra with their deltas, Y a smooth
           transform of X.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtri


def lengths(traffic):
    """The utterances' frame counts, the same for every seed."""
    n, spec = traffic["utterances"], traffic["frames"]
    if spec["kind"] == "fixed":
        return np.full(n, int(spec["frames"]), np.int64)
    if spec["kind"] == "listed":
        out = np.asarray(spec["frames"], np.int64)
        if out.shape != (n,) or out.min() < 1:
            raise ValueError(f"{n} utterances, the list holds {out.shape}")
        return out
    if spec["kind"] != "lognormal":
        raise ValueError(f"unknown frame distribution {spec['kind']!r}")
    q = (np.arange(n) + 0.5) / n
    raw = np.exp(np.log(spec["median"]) + spec["sigma_log"] * ndtri(q))
    out = np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)
    return out[np.random.RandomState(spec["order_seed"]).permutation(n)]


def _smooth(x, taps=21):
    """Each column of (N, C) low-passed along N by a Hann window."""
    k = torch.hann_window(taps + 2, periodic=False, device=x.device)[1:-1]
    k = (k / k.sum()).expand(x.shape[1], 1, taps).contiguous()
    y = torch.nn.functional.conv1d(x.t()[None], k, padding=taps // 2,
                                   groups=x.shape[1])
    return y[0].t()


def _with_deltas(s, windows):
    """Statics (N, S) and each window's taps along N: (N, K S)."""
    out = []
    for l, u, coeffs in windows:
        acc = torch.zeros_like(s)
        for k in range(-l, u + 1):
            c = float(coeffs[l + k])
            if c == 0.0:
                continue
            shifted = torch.roll(s, -k, dims=0)
            acc += c * shifted
        out.append(acc)
    return torch.cat(out, dim=1)


def _tts(cfg, N, g, dev):
    c = cfg["corpus"]
    Q, F = c["question_dim"], c["frame_feature_dim"]
    seg = torch.cumsum(torch.rand(N, generator=g, device=dev)
                       < 1.0 / c["mean_phone_frames"], 0)
    density = 0.02 + 0.48 * torch.rand(Q, generator=g, device=dev)
    answers = (torch.rand(int(seg[-1]) + 1, Q, generator=g, device=dev)
               < density).float()
    frame = _smooth(torch.randn(N, F, generator=g, device=dev)) * 3.0
    X = torch.cat([answers[seg], frame], dim=1)
    hp = cfg["hparams"]
    K = len(hp["windows"])
    mgc_dim = hp["stream_sizes"][0] // K
    decay = 1.0 / (1.0 + torch.arange(mgc_dim, device=dev))
    mgc = _smooth(torch.randn(N, mgc_dim, generator=g, device=dev)) * 3.0 \
        * decay
    lf0 = 5.3 + 0.6 * _smooth(torch.randn(N, 1, generator=g, device=dev))
    vuv = (_smooth(torch.randn(N, 1, generator=g, device=dev)) > -0.2)
    bap = -1.0 + _smooth(torch.randn(N, 1, generator=g, device=dev))
    w = hp["windows"]
    Y = torch.cat([_with_deltas(mgc, w), _with_deltas(lf0, w),
                   vuv.float(), _with_deltas(bap, w)], dim=1)
    return X, Y


def _vc(cfg, N, g, dev):
    hp = cfg["hparams"]
    S = hp["generator_params"]["static_dim"]
    decay = 1.0 / (1.0 + torch.arange(S, device=dev))
    xs = _smooth(torch.randn(N, S, generator=g, device=dev)) * 3.0 * decay
    ys = 0.9 * xs + 0.05 + \
        _smooth(torch.randn(N, S, generator=g, device=dev)) * decay
    w = hp["windows"]
    return _with_deltas(xs, w), _with_deltas(ys, w)


def make(cfg, traffic, seed, device):
    """(lengths, X, Y): lists of float32 host arrays, one per utterance."""
    L = lengths(traffic)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    kind = cfg["corpus"]["kind"]
    X, Y = {"tts": _tts, "vc": _vc}[kind](cfg, int(L.sum()), g, device)
    cuts = np.cumsum(L)[:-1]
    X = np.split(X.float().cpu().numpy(), cuts)
    Y = np.split(Y.float().cpu().numpy(), cuts)
    return L, X, Y
