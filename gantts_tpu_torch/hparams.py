"""Hyper-parameter bundles (the port's own copy of gantts_tpu/hparams.py).

The same three bundles (``vc``, ``tts_duration``, ``tts_acoustic``) with the
same field names and defaults, the same ``HParams`` parsing of ``"k=v,..."``
override strings, and the same loader and compute additions.  The port keeps
its own copy so that it reads no file of the JAX package;
``tests/test_torch_train.py`` holds every bundle equal to the JAX package's.

Fields left ``None`` (model in/out dims) are inferred from data stats at
startup (``train/setup.py``).
"""

from __future__ import annotations

import ast
from os.path import dirname, join

import numpy as np


class HParams:
    """Minimal HParams: attribute access, ``values()``, ``parse("k=v,...")``.

    Parse semantics follow tf.contrib.training.HParams: values are cast to
    the type of the existing default; lists/dicts accept python-literal
    syntax; strings are taken raw (unquoted).
    """

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", dict(kwargs))

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self._values[name] = value

    def values(self):
        return dict(self._values)

    def copy(self):
        import copy

        return HParams(**copy.deepcopy(self._values))

    def parse(self, spec):
        if not spec:
            return self
        for key, raw in _split_kv(spec):
            if key not in self._values:
                raise ValueError(f"Unknown hyperparameter: {key}")
            self._values[key] = _cast_like(self._values[key], raw)
        return self

    def __repr__(self):
        return f"HParams({self._values!r})"


def _split_kv(spec):
    """Split 'a=1,b=[1, 2],c=x' on commas not inside brackets/parens."""
    items, depth, cur = [], 0, ""
    for ch in spec:
        if ch in "[({":
            depth += 1
        elif ch in "])}":
            depth -= 1
        if ch == "," and depth == 0:
            if cur.strip():
                items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur.strip())
    out = []
    for item in items:
        if "=" not in item:
            raise ValueError(f"Malformed hparam override: {item!r}")
        k, v = item.split("=", 1)
        out.append((k.strip(), v.strip()))
    return out


def _cast_like(default, raw):
    if isinstance(default, bool):
        if raw.lower() in ("true", "1"):
            return True
        if raw.lower() in ("false", "0"):
            return False
        raise ValueError(f"Cannot parse bool from {raw!r}")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, (list, tuple, dict)):
        # A typo'd literal must fail here, not far downstream.
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError) as e:
            raise ValueError(
                f"Cannot parse {raw!r} as a Python literal (the default is "
                f"a {type(default).__name__})") from e
        if not isinstance(val, (list, tuple, dict)):
            raise ValueError(
                f"Expected a {type(default).__name__} literal, got "
                f"{raw!r} ({type(val).__name__})")
        return val
    if default is None:
        # Dims (ints) and optional strings both default to None: accept any
        # literal, fall back to the raw string (e.g. subphone_features=full).
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return raw
    return raw  # str


def hparams_debug_string(params):
    values = params.values()
    hp = ["  %s: %s" % (name, values[name]) for name in sorted(values)]
    return "Hyperparameters:\n" + "\n".join(hp)


# ---------------------------------------------------------------------------
# Shared building blocks (values identical to the reference hparams.py).
# ---------------------------------------------------------------------------

# The static+delta+deltadelta window set
_DELTA_WINDOWS = [
    (0, 0, np.array([1.0])),
    (1, 1, np.array([-0.5, 0.0, 0.5])),
    (1, 1, np.array([1.0, -2.0, 1.0])),
]

_QUESTION_PATH = join(dirname(__file__), "..", "data",
                      "questions-radio_dnn_416.hed")

# SRU generator settings shared by both TTS bundles; the acoustic bundle
# overrides dropout.
_SRU_GENERATOR = dict(in_dim=None, out_dim=None, num_hidden=6, hidden_dim=512,
                      bidirectional=True, dropout=0.0, use_relu=1,
                      rnn_dropout=0.2, last_sigmoid=False)


# MLP discriminator shapes per bundle
def _mlp_discriminator(in_dim, num_hidden, hidden_dim, dropout):
    return dict(in_dim=in_dim, out_dim=1, num_hidden=num_hidden,
                hidden_dim=hidden_dim, dropout=dropout, last_sigmoid=True)


# Fields the JAX package added to the reference's bundles, kept so that the
# same --hparams strings parse: padded lengths round up to a multiple of
# batch_bucket_multiple, compute_dtype is the matmul precision, mlpg_impl
# "dense" (R matmul) or "stencil".
_TPU_ADDITIONS = dict(
    batch_bucket_multiple=32,
    compute_dtype="float32",
    mlpg_impl="dense",
)

# Host loader.  num_workers > 0 enables the prefetching thread pool in
# data.BatchIterator; cache_size caps the normalized-item memo and, over
# batch_size, the batches that pool assembles ahead (at least 2 a worker),
# across the end of an epoch; pin_memory is an accepted no-op so reference
# --hparams strings still parse.
_LOADER_DEFAULTS = dict(num_workers=1, cache_size=1200, pin_memory=False)


def _bundle(**kwargs):
    merged = dict(kwargs)
    for extra in (_LOADER_DEFAULTS, _TPU_ADDITIONS):
        for k, v in extra.items():
            merged.setdefault(k, v)
    return HParams(**merged)


# ---------------------------------------------------------------------------
# Voice conversion
# ---------------------------------------------------------------------------

vc = _bundle(
    name="vc",
    # acoustic features: 59 mel-cepstra (c0 dropped at extraction), 5 ms hop
    order=59,
    frame_period=5,
    windows=_DELTA_WINDOWS,
    stream_sizes=[59 * 3],
    has_dynamic_features=[True],
    # the single mgc stream feeds the adversarial loss; c0 already removed
    adversarial_streams=[True],
    mask_nth_mgc_for_adv_loss=0,
    # generator: In2Out highway net (swap to In2OutRNNHighwayNet for RNN VC)
    generator_add_noise=False,
    generator_noise_dim=200,
    generator="In2OutHighwayNet",
    generator_params=dict(in_dim=None, out_dim=None, num_hidden=3,
                          hidden_dim=512, static_dim=59, dropout=0.5),
    optimizer_g="Adagrad",
    optimizer_g_params=dict(lr=0.01, weight_decay=0),
    # discriminator: per-frame MLP on the 59 static mel-cepstra
    discriminator_linguistic_condition=False,
    discriminator="MLP",
    discriminator_params=_mlp_discriminator(59, 2, 256, 0.5),
    optimizer_d="Adagrad",
    optimizer_d_params=dict(lr=0.01, weight_decay=0),
    nepoch=200,  # demos override this
    lr_decay_schedule=False,
    lr_decay_epoch=10,
    batch_size=20,
)


# ---------------------------------------------------------------------------
# TTS duration model
# ---------------------------------------------------------------------------

tts_duration = _bundle(
    name="duration",
    # phone-level linguistic input, no frame expansion
    use_phone_alignment=False,
    subphone_features=None,
    add_frame_features=False,
    question_path=_QUESTION_PATH,
    # 5 per-state durations, static only (no delta windows)
    windows=_DELTA_WINDOWS[:1],
    stream_sizes=[5],
    has_dynamic_features=[False],
    recompute_delta_features=False,
    adversarial_streams=[True],
    mask_nth_mgc_for_adv_loss=0,
    generator="SRURNN",
    generator_add_noise=False,
    generator_noise_dim=200,
    generator_params=dict(_SRU_GENERATOR),
    optimizer_g="Adam",
    optimizer_g_params=dict(lr=0.001, betas=(0.5, 0.9), weight_decay=0),
    discriminator_linguistic_condition=True,
    discriminator="MLP",
    discriminator_params=_mlp_discriminator(None, 3, 256, 0.0),
    optimizer_d="Adam",
    optimizer_d_params=dict(lr=0.001, betas=(0.5, 0.9), weight_decay=0),
    nepoch=200,
    lr_decay_schedule=False,
    lr_decay_epoch=25,
    batch_size=32,
)


# ---------------------------------------------------------------------------
# TTS acoustic model
# ---------------------------------------------------------------------------

tts_acoustic = _bundle(
    name="acoustic",
    # frame-level linguistic input with the 9 "full" subphone features
    use_phone_alignment=False,
    subphone_features="full",
    add_frame_features=True,
    question_path=_QUESTION_PATH,
    # WORLD analysis settings
    order=59,
    frame_period=5,
    f0_floor=71.0,
    f0_ceil=700,
    use_harvest=True,  # False selects dio+stonemask
    windows=_DELTA_WINDOWS,
    f0_interpolation_kind="quadratic",
    mod_spec_smoothing=True,
    mod_spec_smoothing_cutoff=50,  # Hz
    recompute_delta_features=False,
    # stream layout: (mgc, lf0, vuv, bap) with deltas on all but vuv
    stream_sizes=[180, 3, 1, 3],
    has_dynamic_features=[True, True, False, True],
    # adversarial loss on the mgc stream only, first two coefficients masked
    # (Saito 2017's finding: 0th/1st mgc in the adv loss hurt quality);
    # changing adversarial_streams requires adjusting discriminator in_dim
    adversarial_streams=[True, False, False, False],
    mask_nth_mgc_for_adv_loss=2,
    generator_add_noise=False,
    generator_noise_dim=200,
    generator="SRURNN",
    generator_params=dict(_SRU_GENERATOR, dropout=0.2),
    optimizer_g="Adagrad",
    optimizer_g_params=dict(lr=0.01, weight_decay=1e-7),
    discriminator_linguistic_condition=True,
    discriminator="MLP",
    discriminator_params=_mlp_discriminator(None, 3, 256, 0.5),
    optimizer_d="Adagrad",
    optimizer_d_params=dict(lr=0.01, weight_decay=1e-7),
    nepoch=200,
    lr_decay_schedule=False,
    lr_decay_epoch=25,
    batch_size=20,
)
