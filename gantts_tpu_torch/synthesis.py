"""VC and TTS synthesis on the port (counterpart of gantts_tpu/synthesis.py):
the generator's forward on one utterance, the whole conversion chain from a
waveform, and two-stage TTS from an HTS label.

  model_forward     one generator on one utterance (both uses below);
  apply_vc_model    the generator on one normalized utterance, either
                    protocol, returning the static mel-cepstra;
  vc_from_waveform  WORLD analysis, mel-cepstra, modulation-spectrum
                    smoothing, deltas, the generator, then the MLSA filter
                    on the source waveform (``diffvc``) or WORLD synthesis
                    (evaluation_vc.py's chain);
  gen_parameters    per-stream host MLPG and denormalization of a predicted
                    acoustic track (evaluation_tts.py:51-100);
  gen_waveform      those parameters, the optional Merlin post-filter, then
                    WORLD synthesis (evaluation_tts.py:103-130);
  gen_duration      the duration model's prediction written back into the
                    label's timings (evaluation_tts.py:143-179);
  tts_from_label    labels -> durations -> frame-level linguistic features
                    -> the acoustic model -> waveform
                    (evaluation_tts.py:182-225).

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

Each TTS model builds its noise input (``generator_add_noise``) from its
own bundle, a fix of the reference, which builds the acoustic model's from
the duration model's hparams (evaluation_tts.py:219), kept from the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.core.fast_mlpg import DEFAULT_HALFWIDTH, MLPGStencil
from gantts_tpu_torch.core.paramgen import multi_stream_mlpg
from gantts_tpu_torch.core.windows import (
    delta_features,
    mlpg,
    unit_variance_mlpg_matrix,
)
from gantts_tpu_torch.data import round_up
from gantts_tpu_torch.frontend import sptk, world
from gantts_tpu_torch.io import hts, merlin
from gantts_tpu_torch.models import include_parameter_generation
from gantts_tpu_torch.postfilters import merlin_post_filter

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


# ---------------------------------------------------------------------------
# TTS
# ---------------------------------------------------------------------------

def gen_parameters(y_predicted, Y_mean, Y_std, hp_acoustic,
                   mge_training=True):
    """Per-stream MLPG and denormalization (evaluation_tts.py:51-100).

    mge_training=True: MLPG with unit variances on the normalized features,
    then denormalize (MGE-trained models); else denormalize first and use
    the training set's variances."""
    hp = hp_acoustic
    mgc_dim, lf0_dim, vuv_dim, bap_dim = hp.stream_sizes
    lf0_start = mgc_dim
    vuv_start = lf0_start + lf0_dim
    bap_start = vuv_start + vuv_dim
    windows = hp.windows
    K = len(windows)

    if mge_training:
        mgc = mlpg(y_predicted[:, :lf0_start], np.ones(mgc_dim), windows)
        lf0 = mlpg(y_predicted[:, lf0_start:vuv_start], np.ones(lf0_dim),
                   windows)
        vuv = y_predicted[:, vuv_start]
        bap = mlpg(y_predicted[:, bap_start:], np.ones(bap_dim), windows)

        mgc = P.inv_scale(mgc, Y_mean[:mgc_dim // K], Y_std[:mgc_dim // K])
        lf0 = P.inv_scale(lf0, Y_mean[lf0_start:lf0_start + lf0_dim // K],
                          Y_std[lf0_start:lf0_start + lf0_dim // K])
        bap = P.inv_scale(bap, Y_mean[bap_start:bap_start + bap_dim // K],
                          Y_std[bap_start:bap_start + bap_dim // K])
        vuv = P.inv_scale(vuv, Y_mean[vuv_start], Y_std[vuv_start])
    else:
        y = P.inv_scale(y_predicted, Y_mean, Y_std)
        Y_var = Y_std * Y_std
        mgc = mlpg(y[:, :lf0_start], Y_var[:lf0_start], windows)
        lf0 = mlpg(y[:, lf0_start:vuv_start], Y_var[lf0_start:vuv_start],
                   windows)
        vuv = y[:, vuv_start]
        bap = mlpg(y[:, bap_start:], Y_var[bap_start:], windows)

    return mgc, lf0, vuv, bap


def gen_waveform(y_predicted, Y_mean, Y_std, hp_acoustic, post_filter=False,
                 coef=1.4, fs=16000, mge_training=True):
    """Predicted acoustic features -> waveform (evaluation_tts.py:103-130):
    frames with vuv < 0.5 are unvoiced, lf0 is exponentiated elsewhere, and
    the waveform is scaled to a peak of 32767.  Returns (waveform, mgc,
    lf0, vuv, bap)."""
    alpha = sptk.mcepalpha(fs)
    fftlen = world.get_cheaptrick_fft_size(fs)
    frame_period = hp_acoustic.frame_period

    mgc, lf0, vuv, bap = gen_parameters(
        y_predicted, Y_mean, Y_std, hp_acoustic, mge_training)

    if post_filter:
        mgc = merlin_post_filter(mgc, alpha, coef=coef)

    spectrogram = sptk.mc2sp(mgc, alpha=alpha, fftlen=fftlen)
    aperiodicity = world.decode_aperiodicity(
        bap.astype(np.float64), fs, fftlen)
    f0 = lf0.copy().reshape(-1)
    vuv_flat = np.asarray(vuv).reshape(-1)
    f0[vuv_flat < 0.5] = 0
    nz = np.nonzero(f0)
    f0[nz] = np.exp(f0[nz])

    generated = world.synthesize(
        f0.astype(np.float64), spectrogram.astype(np.float64),
        aperiodicity.astype(np.float64), fs, frame_period)
    generated = generated / np.max(np.abs(generated)) * 32767  # int16 range

    return generated, mgc, lf0, vuv, bap


def generator_input(hp, x):
    """The generator's input: ``x``, with uniform noise of
    ``generator_noise_dim`` columns appended when the bundle asks for it
    (evaluation_tts.py:133-140), from a fresh RandomState(1234) on each
    call."""
    if hp.generator_add_noise:
        rs = np.random.RandomState(1234)
        z = rs.rand(x.shape[0], hp.generator_noise_dim).astype(np.float32)
        return np.concatenate([x, z], axis=-1)
    return x


def gen_duration(label_path, duration_model, X_min, X_max, Y_mean, Y_std,
                 hp_duration, binary_dict, continuous_dict):
    """The duration model's prediction written back into the labels
    (evaluation_tts.py:143-179): rounded, values <= 0 set to 1; a
    state-aligned label takes one duration per state line, a phone-aligned
    one the sum over states.  Returns the relabelled HTSLabelFile."""
    hts_labels = hts.load(label_path)
    feats = merlin.linguistic_features(
        hts_labels, binary_dict, continuous_dict,
        add_frame_features=hp_duration.add_frame_features,
        subphone_features=hp_duration.subphone_features).astype(np.float32)

    feats = P.minmax_scale(feats, X_min, X_max, feature_range=(0.01, 0.99))
    feats = generator_input(hp_duration, feats.astype(np.float32))

    pred = model_forward(duration_model, feats.astype(np.float32),
                         hp_duration)
    pred = P.inv_scale(pred.astype(np.float64), Y_mean, Y_std)
    pred = np.round(pred)
    pred[pred <= 0] = 1
    if hts_labels.is_state_alignment:
        durations = pred.reshape(-1)
    else:
        durations = pred.sum(axis=-1)
    hts_labels.set_durations(durations)
    return hts_labels


def tts_from_label(models, label_path, X_min, X_max, Y_mean, Y_std,
                   hp_duration, hp_acoustic, binary_dict, continuous_dict,
                   post_filter=False, apply_duration_model=True, coef=1.4,
                   fs=16000, mge_training=True):
    """Two-stage TTS synthesis (evaluation_tts.py:182-225).  ``models`` and
    the stats are dicts keyed "duration" and "acoustic".  Silence frames
    are deleted from the acoustic model's input.  Returns gen_waveform's
    (waveform, mgc, lf0, vuv, bap)."""
    if apply_duration_model:
        labels = gen_duration(
            label_path, models["duration"], X_min["duration"],
            X_max["duration"], Y_mean["duration"], Y_std["duration"],
            hp_duration, binary_dict, continuous_dict)
    else:
        labels = hts.load(label_path)

    feats = merlin.linguistic_features(
        labels, binary_dict, continuous_dict,
        add_frame_features=hp_acoustic.add_frame_features,
        subphone_features=hp_acoustic.subphone_features)
    indices = labels.silence_frame_indices()
    feats = np.delete(feats, indices[indices < len(feats)], axis=0)

    feats = P.minmax_scale(feats, X_min["acoustic"], X_max["acoustic"],
                           feature_range=(0.01, 0.99)).astype(np.float32)
    feats = generator_input(hp_acoustic, feats)

    acoustic_predicted = model_forward(models["acoustic"], feats, hp_acoustic)

    return gen_waveform(acoustic_predicted.astype(np.float64),
                        Y_mean["acoustic"], Y_std["acoustic"], hp_acoustic,
                        post_filter, coef=coef, fs=fs,
                        mge_training=mge_training)
