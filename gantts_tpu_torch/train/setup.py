"""Startup wiring (counterpart of gantts_tpu/train/setup.py): dataset
discovery, stats collection and persistence, dim inference, and model and
optimizer construction."""

from __future__ import annotations

from os.path import join

import numpy as np
import torch

from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.core.streams import get_static_stream_sizes
from gantts_tpu_torch.data import (
    BatchIterator,
    NPYDataSource,
    TTSDataset,
    VCDataset,
)
from gantts_tpu_torch.models import create_model
from gantts_tpu_torch.train.optim import create_optimizer
from gantts_tpu_torch.train.step import TrainState


def load_arrays(inputs_dir, outputs_dir, max_files=None):
    """Load the train/test .npy splits for X and Y."""
    X, Y, utt_lengths = {}, {}, {}
    for phase in ["train", "test"]:
        train = phase == "train"
        X[phase] = NPYDataSource(inputs_dir, train=train,
                                 max_files=max_files).load()
        Y[phase] = NPYDataSource(outputs_dir, train=train,
                                 max_files=max_files).load()
        x_lengths = np.array([len(x) for x in X[phase]])
        y_lengths = np.array([len(y) for y in Y[phase]])
        assert np.allclose(x_lengths, y_lengths), \
            "X and Y must be time aligned"
        utt_lengths[phase] = x_lengths
        print(f"Size of dataset for {phase}: {len(X[phase])}")
    return X, Y, utt_lengths


def _loaders(hp, make_dataset):
    return {phase: BatchIterator(
        make_dataset(phase), hp.batch_size, shuffle=(phase == "train"),
        bucket_multiple=hp.batch_bucket_multiple,
        num_workers=hp.num_workers, cache_size=hp.cache_size)
        for phase in ["train", "test"]}


def prepare_vc(X, Y, utt_lengths, hp, data_dir):
    """Pooled X and Y stats, saved as data_mean / data_var; dim
    inference."""
    data_mean, data_var, n = P.meanvar(
        X["train"], utt_lengths["train"], return_last_sample_count=True)
    data_mean, data_var = P.meanvar(
        Y["train"], utt_lengths["train"], mean_=data_mean, var_=data_var,
        last_sample_count=n)
    data_std = np.sqrt(data_var)

    np.save(join(data_dir, "data_mean"), data_mean)
    np.save(join(data_dir, "data_var"), data_var)

    if hp.generator_params["in_dim"] is None:
        hp.generator_params["in_dim"] = data_mean.shape[-1]
    if hp.generator_params["out_dim"] is None:
        hp.generator_params["out_dim"] = data_mean.shape[-1]

    loaders = _loaders(hp, lambda phase: VCDataset(
        X[phase], Y[phase], data_mean, data_std))
    return loaders, data_mean, data_std


def infer_tts_dims(hp, X_data_min, Y_data_mean):
    """Generator in/out dims and the discriminator's in_dim (selected
    statics, less the masked mgc, plus the linguistic input when the
    discriminator is conditioned on it)."""
    if hp.generator_params["in_dim"] is None:
        D = X_data_min.shape[-1]
        if hp.generator_add_noise:
            D = D + hp.generator_noise_dim
        hp.generator_params["in_dim"] = D
    if hp.generator_params["out_dim"] is None:
        hp.generator_params["out_dim"] = Y_data_mean.shape[-1]
    if hp.discriminator_params["in_dim"] is None:
        sizes = get_static_stream_sizes(
            hp.stream_sizes, hp.has_dynamic_features, len(hp.windows))
        D = int(np.asarray(sizes)[np.asarray(hp.adversarial_streams)].sum())
        if hp.adversarial_streams[0]:
            D -= hp.mask_nth_mgc_for_adv_loss
        if hp.discriminator_linguistic_condition:
            D = D + X_data_min.shape[-1]
        hp.discriminator_params["in_dim"] = D


def prepare_tts(X, Y, utt_lengths, hp, data_dir):
    """X min/max and Y mean/var stats, saved under the file names the
    evaluation scripts read (``X_{acoustic|duration}_data_min`` ...)."""
    ty = hp.name if hp.name in ("acoustic", "duration") else "duration"
    X_data_min, X_data_max = P.minmax(X["train"])
    Y_data_mean, Y_data_var = P.meanvar(Y["train"])
    Y_data_std = np.sqrt(Y_data_var)

    np.save(join(data_dir, f"X_{ty}_data_min"), X_data_min)
    np.save(join(data_dir, f"X_{ty}_data_max"), X_data_max)
    np.save(join(data_dir, f"Y_{ty}_data_mean"), Y_data_mean)
    np.save(join(data_dir, f"Y_{ty}_data_var"), Y_data_var)

    infer_tts_dims(hp, X_data_min, Y_data_mean)

    loaders = _loaders(hp, lambda phase: TTSDataset(
        X[phase], Y[phase], X_data_min, X_data_max, Y_data_mean, Y_data_std,
        recompute_deltas=hp.recompute_delta_features, windows=hp.windows,
        stream_sizes=hp.stream_sizes,
        has_dynamic_features=hp.has_dynamic_features))
    return loaders, Y_data_mean, Y_data_std


def init_models_and_states(hp, seed=1234, device="cuda"):
    """Build generator and discriminator by name on ``device``, with torch's
    default init drawn from a generator seeded by ``seed``, and their
    optimizers.  Returns (model_g, model_d, opt_g, opt_d, gstate, dstate)."""
    cd = getattr(hp, "compute_dtype", "float32")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model_g = create_model(hp.generator, compute_dtype=cd, generator=gen,
                           device=device, **hp.generator_params)
    model_d = create_model(hp.discriminator, compute_dtype=cd, generator=gen,
                           device=device, **hp.discriminator_params)
    opt_g = create_optimizer(hp.optimizer_g, hp.optimizer_g_params,
                             model_g.parameters())
    opt_d = create_optimizer(hp.optimizer_d, hp.optimizer_d_params,
                             model_d.parameters())
    return (model_g, model_d, opt_g, opt_d, TrainState(model_g, opt_g),
            TrainState(model_d, opt_d))
