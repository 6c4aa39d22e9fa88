"""VC synthesis on the port (counterpart of the VC half of
gantts_tpu/synthesis.py): the generator's forward on one utterance, and the
whole conversion chain from a waveform.

  apply_vc_model    the generator on one normalized utterance, either
                    protocol, returning the static mel-cepstra;
  vc_from_waveform  WORLD analysis, mel-cepstra, modulation-spectrum
                    smoothing, deltas, the generator, then the MLSA filter
                    on the source waveform (``diffvc``) or WORLD synthesis
                    (evaluation_vc.py's chain).

The generator runs on its own device in eval mode under ``torch.no_grad()``;
the vocoder work runs on the host in float64 (``frontend/``).  The forward
follows the JAX package's ``JittedForward``, though eagerly, with no compile
cache to keep:

  * an In2Out model applies MLPG inside itself, over the whole padded
    length, so zero padding would bend the trajectory's tail.  From
    4*24+2 = 98 frames it gets the ``MLPGStencil`` operator with the true
    length, on the input padded to ``batch_bucket_multiple``, and shorter
    utterances get the exact dense R at the true length;
  * any other model is padded to ``batch_bucket_multiple``, trimmed, and its
    output goes through the dense R at the true length.

TTS synthesis is not here yet.
"""

from __future__ import annotations

import numpy as np
import torch

from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.core.fast_mlpg import DEFAULT_HALFWIDTH, MLPGStencil
from gantts_tpu_torch.core.paramgen import multi_stream_mlpg
from gantts_tpu_torch.core.windows import (
    delta_features,
    unit_variance_mlpg_matrix,
)
from gantts_tpu_torch.data import round_up
from gantts_tpu_torch.frontend import sptk, world
from gantts_tpu_torch.models import include_parameter_generation

MIN_STENCIL_T = 4 * DEFAULT_HALFWIDTH + 2


def _dense_R(hp, T, device):
    return torch.as_tensor(unit_variance_mlpg_matrix(hp.windows, T),
                           device=device)


def model_forward(model, x, hp):
    """x (T, D) float32 numpy -> the model's output(s), trimmed back to T, as
    numpy: (first, y_static) for an In2Out model, y otherwise."""
    device = next(model.parameters()).device
    T = x.shape[0]
    needs_R = include_parameter_generation(model)
    use_stencil = needs_R and T >= MIN_STENCIL_T
    if needs_R and not use_stencil:
        T_pad = T  # short utterance: exact dense R at the true length
    else:
        T_pad = round_up(T, hp.batch_bucket_multiple)
    xp = np.zeros((1, T_pad, x.shape[1]), np.float32)
    xp[0, :T] = x
    xp = torch.as_tensor(xp, device=device)
    lengths = torch.tensor([T], dtype=torch.int32, device=device)
    model.eval()
    with torch.no_grad():
        if needs_R:
            R = (MLPGStencil.create(hp.windows, device=device) if use_stencil
                 else _dense_R(hp, T_pad, device))
            out = model(xp, R, lengths)
        else:
            out = model(xp, lengths)
    if isinstance(out, tuple):
        return tuple(o[0, :T].float().cpu().numpy() for o in out)
    return out[0, :T].float().cpu().numpy()


def apply_vc_model(model, mc_scaled, hp):
    """Either generator protocol on one normalized (T, D) utterance;
    returns the (T, static) prediction (evaluation_vc.py:74-83)."""
    if include_parameter_generation(model):
        _, y_hat_static = model_forward(model, mc_scaled, hp)
        return y_hat_static
    y_hat = model_forward(model, mc_scaled, hp)
    T = y_hat.shape[0]
    device = next(model.parameters()).device
    with torch.no_grad():
        y_hat_static = multi_stream_mlpg(
            torch.as_tensor(y_hat, device=device)[None],
            _dense_R(hp, T, device), tuple(hp.stream_sizes),
            tuple(hp.has_dynamic_features))
    return y_hat_static[0].cpu().numpy()


def vc_from_waveform(model, x, fs, data_mean, data_std, hp, diffvc=True):
    """The whole VC chain on one waveform (evaluation_vc.py:40-110).

    Returns (waveform, inputs, outputs): the converted audio, and the
    source's and the prediction's static mel-cepstra."""
    hop_length = int(fs * (hp.frame_period * 0.001))
    x = np.asarray(x, dtype=np.float64)
    f0, timeaxis = world.dio(x, fs, frame_period=hp.frame_period)
    f0 = world.stonemask(x, f0, timeaxis, fs)
    spectrogram = world.cheaptrick(x, f0, timeaxis, fs)
    aperiodicity = world.d4c(x, f0, timeaxis, fs)
    alpha = sptk.mcepalpha(fs)
    mc = sptk.sp2mc(spectrogram, order=hp.order, alpha=alpha)
    c0, mc = mc[:, 0], mc[:, 1:]
    static_dim = mc.shape[-1]
    mc = P.modspec_smoothing(mc, fs / hop_length, cutoff=50)
    mc = delta_features(mc, hp.windows).astype(np.float32)

    inputs = mc[:, :static_dim].copy()

    mc_scaled = P.scale(mc, data_mean, data_std).astype(np.float32)
    mc_static_pred = apply_vc_model(model, mc_scaled, hp)
    mc_static_pred = P.inv_scale(
        mc_static_pred.astype(np.float64),
        data_mean[:static_dim], data_std[:static_dim])
    outputs = mc_static_pred.copy()

    if diffvc:
        mc_static_pred = mc_static_pred - mc[:, :static_dim]

    mc_full = np.hstack((c0[:, None], mc_static_pred))
    if diffvc:
        mc_full[:, 0] = 0  # remove the power coefficient
        b = sptk.mc2b(mc_full.astype(np.float64), alpha=alpha)
        waveform = sptk.mlsa_synthesis(x, b, alpha, hopsize=hop_length)
    else:
        fftlen = world.get_cheaptrick_fft_size(fs)
        spectrogram = sptk.mc2sp(
            mc_full.astype(np.float64), alpha=alpha, fftlen=fftlen)
        waveform = world.synthesize(
            f0, spectrogram, aperiodicity, fs, hp.frame_period)

    return waveform, inputs, outputs
