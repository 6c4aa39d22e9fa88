"""The port reads the JAX package's checkpoint files: its own flax msgpack
codec (``train/flax_msgpack.py``) against flax, every model of the registry
and every optimizer of the bundles written by the JAX package's
``save_checkpoint`` and restored by the port, a GAN step resumed from such
files in both packages, the command lines on them, and the training
command line's ``--profile-dir`` and ``--debug-nans``.

Exact means exact here: parameters, optimizer tensors, ``lr``, ``step``
and ``global_epoch`` compare with ``np.array_equal`` (dtype, shape and
bits), and what ``flax_msgpack.packb`` writes is byte for byte what
``flax.serialization.msgpack_serialize`` writes.  The resumed step is held
to tests/test_torch_step.py's tolerances: losses at rtol 1e-5, and
Adagrad's update to the JAX package's up to the eps placement, element by
element (eps inside the square root in optax, after it in torch).
"""

import json
import os
import pickle
import sys
from os.path import dirname, exists, join
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from scipy.io import wavfile
from test_torch_step import _batch, _check_outputs, _hp, _torch_adagrad
from test_torch_duration import _dur_batch, _dur_hp

from gantts_tpu import hparams as jax_hparams
from gantts_tpu.core.windows import unit_variance_mlpg_matrix
from gantts_tpu.models import create_model as jax_create
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train.checkpoint import load_checkpoint as jax_load
from gantts_tpu.train.checkpoint import save_checkpoint as jax_save
from gantts_tpu.train.optim import create_optimizer as jax_optimizer
from gantts_tpu.train.setup import init_models_and_states as jax_init
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.models import create_model
from gantts_tpu_torch.train import GanTrainer, StepConfig, TrainState
from gantts_tpu_torch.train import checkpoint as ckpt
from gantts_tpu_torch.train import flax_msgpack
from gantts_tpu_torch.train.optim import create_optimizer
from gantts_tpu_torch.train.setup import init_models_and_states

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _same(a, b, path="tree"):
    """Exact equality of two decoded trees: the same keys, leaf types,
    dtypes, shapes and bits; bfloat16 compares a torch tensor (the port's)
    with an ml_dtypes array (flax's) by their 16-bit patterns."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, path
        assert tuple(a.shape) == b.shape, path
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16)), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


# ---- (a) the codec against flax ---------------------------------------------

def _bf16(rs, *shape):
    return np.asarray(jnp.asarray(rs.randn(*shape), jnp.bfloat16))


TREES = {
    "float32": lambda rs: {"w": rs.randn(3, 5).astype(np.float32),
                           "b": rs.randn(5).astype(np.float32)},
    "int32_bool": lambda rs: {"count": np.asarray(7, np.int32),
                              "ids": np.arange(-3, 40, dtype=np.int32),
                              "mask": rs.rand(4, 2) > 0.5},
    "bfloat16": lambda rs: {"x": _bf16(rs, 2, 3, 4), "s": _bf16(rs)},
    "zero_d_and_empty": lambda rs: {"a": np.asarray(2.5, np.float32),
                                    "e": np.zeros((0, 3), np.float32),
                                    "nested": {}, "none": None},
    "npscalar": lambda rs: {"f": np.float32(0.01), "d": np.float64(-3.5),
                            "i": np.int64(-2 ** 40), "u": np.uint8(200),
                            "t": np.bool_(True)},
    "python_scalars": lambda rs: {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                 -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.1, -2.0, float("inf")], "flags": [True, False],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "Dense_0"],
        "blob": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000]},
    "complex": lambda rs: {"z": complex(1.5, -2.25), "w": 3j},
    "wide_containers": lambda rs: {
        f"k{i:02d}": np.asarray([i], np.float32) for i in range(17)} | {
        "list": list(range(20)), "big": {str(i): i for i in range(70000)}},
}


@pytest.mark.parametrize("case", list(TREES))
def test_codec_matches_flax(case):
    """unpackb(flax's bytes) is flax's own tree, leaf for leaf, and packb
    writes flax's bytes (map keys sorted as msgpack_serialize's tree_map
    leaves them, so the bytes can be compared, not only the trees)."""
    tree = TREES[case](np.random.RandomState(len(case)))
    blob = serialization.msgpack_serialize(tree)
    _same(flax_msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    assert flax_msgpack.packb(tree) == blob


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_codec_chunked_arrays_match_flax(monkeypatch, dtype):
    """An array over MAX_CHUNK_SIZE bytes (lowered here, in this test's
    flax import and in the port's copy) is written as flax's chunk map and
    joined on reading."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(5)
    big = (_bf16(rs, 7, 30) if dtype == "bfloat16"
           else (rs.randn(7, 30) * 100).astype(dtype))
    tree = {"params": {"big": big, "small": np.ones(3, np.float32)}}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert flax_msgpack.packb(tree) == blob
    _same(flax_msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    assert tuple(flax_msgpack.unpackb(blob)["params"]["big"].shape) == (7, 30)


def test_codec_bfloat16_tensor_round_trip():
    """A torch.bfloat16 tensor is written as flax writes the same bits, and
    flax reads it back."""
    t = torch.randn(4, 6).to(torch.bfloat16)
    blob = flax_msgpack.packb({"t": t})
    back = serialization.msgpack_restore(blob)["t"]
    assert back.dtype == jnp.bfloat16 and back.shape == (4, 6)
    assert np.array_equal(back.view(np.int16), t.view(torch.int16).numpy())
    assert torch.equal(flax_msgpack.unpackb(blob)["t"], t)


@pytest.mark.parametrize("cut", [1, 5, 40, -1])
def test_codec_truncated_raises_with_offset(cut):
    blob = serialization.msgpack_serialize(TREES["float32"](
        np.random.RandomState(0)))
    with pytest.raises(ValueError, match=r"truncated msgpack: .* offset \d+"):
        flax_msgpack.unpackb(blob[:cut])


@pytest.mark.parametrize("blob,offset", [
    (b"\xc1", 0), (b"\x82\xa1a\x01\xa1b\xc1", 6),
    (b"\x81\xa1a\xd4\x09\x00", 3)])  # 0xc1 never used; ext type 9 unknown
def test_codec_unknown_byte_raises_with_offset(blob, offset):
    with pytest.raises(ValueError, match=f"offset {offset}$"):
        flax_msgpack.unpackb(blob)


def test_codec_extra_bytes_raise():
    with pytest.raises(ValueError, match="extra bytes"):
        flax_msgpack.unpackb(flax_msgpack.packb({"a": 1}) + b"\x00")


# ---- (b) the JAX package's files, every model and optimizer ----------------

S = 4  # static dims of the In2Out generators
MODELS = {
    "MLP": dict(in_dim=12, out_dim=1, num_hidden=2, hidden_dim=8),
    "SRURNN_bi": dict(in_dim=12, out_dim=6, num_hidden=2, hidden_dim=8,
                      bidirectional=True),
    "SRURNN_uni": dict(in_dim=12, out_dim=6, num_hidden=2, hidden_dim=8,
                       bidirectional=False),
    "LSTMRNN": dict(in_dim=12, out_dim=6, num_hidden=2, hidden_dim=8,
                    bidirectional=True),
    "GRURNN": dict(in_dim=12, out_dim=6, num_hidden=2, hidden_dim=8,
                   bidirectional=False),
    "In2OutHighwayNet": dict(in_dim=3 * S, out_dim=3 * S, static_dim=S,
                             num_hidden=2, hidden_dim=8),
    "In2OutRNNHighwayNet": dict(in_dim=3 * S, out_dim=3 * S, static_dim=S,
                                num_hidden=2, hidden_dim=8,
                                bidirectional=False),
}
OPTIMIZERS = {
    "Adagrad_wd": ("Adagrad", dict(lr=0.01, weight_decay=1e-7)),
    "Adagrad": ("Adagrad", dict(lr=0.01, weight_decay=0)),
    "Adam": ("Adam", dict(lr=0.001, betas=(0.5, 0.9), weight_decay=0)),
    "SGD_momentum": ("SGD", dict(lr=0.1, momentum=0.9)),
}
_GRADS = {}


def _jax_model(key):
    name = key.split("_")[0]
    jm = jax_create(name, **MODELS[key])
    T, B = 10, 2
    rs = np.random.RandomState(len(key))
    x = jnp.asarray(rs.randn(B, T, MODELS[key]["in_dim"]).astype(np.float32))
    lengths = jnp.asarray([T, T - 3], jnp.int32)
    if name.startswith("In2Out"):
        R = jnp.asarray(unit_variance_mlpg_matrix(jax_hparams.vc.windows, T))
        args = (x, R, lengths)
    else:
        args = (x, lengths)
    return name, jm, args


def _grad_fn(key):
    """jit(grad) of the mean square of the model's outputs, per model."""
    if key not in _GRADS:
        name, jm, args = _jax_model(key)

        def loss(params):
            out = jm.apply(params, *args)
            outs = out if isinstance(out, tuple) else (out,)
            return sum(jnp.mean(o ** 2) for o in outs)
        _GRADS[key] = (name, jm, args, jax.jit(jax.grad(loss)))
    return _GRADS[key]


def _jax_trained(key, opt_key, steps=2):
    """The model's JAX init and its optimizer after ``steps`` updates."""
    name, jm, args, grad = _grad_fn(key)
    params = jm.init(jax.random.PRNGKey(len(key)), *args)
    tx = jax_optimizer(*OPTIMIZERS[opt_key])
    state = tx.init(params)
    for _ in range(steps):
        updates, state = tx.update(grad(params), state, params)
        params = optax.apply_updates(params, updates)
    return name, params, tx, state


def _port_state(name, key, opt_key):
    model = create_model(name, device="cpu", **MODELS[key])
    opt_name, opt_params = OPTIMIZERS[opt_key]
    return TrainState(model, create_optimizer(opt_name, opt_params,
                                               model.parameters()))


def _scale_state(opt_state):
    """The JAX optimizer's scale_by_* state, by its fields."""
    found = [s for s in opt_state.inner_state
             if hasattr(s, "sum_of_squares") or hasattr(s, "mu")
             or hasattr(s, "trace")]
    return found[0] if found else None


def _check_restored(state, params, opt_state, opt_key):
    """Every parameter and optimizer tensor, lr and step, exactly."""
    names = [n for n, _ in state.model.named_parameters()]
    for k, v in convert.flax_to_torch(params).items():
        got = state.model.state_dict()[k]
        assert got.dtype == v.dtype and np.array_equal(got.numpy(),
                                                       v.numpy()), k
    sd = state.optimizer.state_dict()
    lr = np.asarray(opt_state.hyperparams["learning_rate"])
    assert lr.dtype == np.float32
    assert all(g["lr"] == float(lr) for g in sd["param_groups"])
    scale = _scale_state(opt_state)
    kind = OPTIMIZERS[opt_key][0]
    fields = {"Adagrad": {"sum": "sum_of_squares"},
              "Adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
              "SGD": {"momentum_buffer": "trace"}}[kind]
    want = {t: convert.flax_to_torch(getattr(scale, j))
            for t, j in fields.items()}
    count = {"Adagrad": opt_state.count, "Adam": getattr(scale, "count", 0),
             "SGD": None}[kind]
    assert set(sd["state"]) == set(range(len(names)))
    for i, n in enumerate(names):
        st = sd["state"][i]
        for t, tree in want.items():
            assert st[t].dtype == tree[n].dtype, (n, t)
            assert np.array_equal(st[t].numpy(), tree[n].numpy()), (n, t)
        if count is not None:
            assert st["step"].dtype == torch.float32
            assert float(st["step"]) == int(count) == 2
    return names


@pytest.mark.parametrize("opt_key", list(OPTIMIZERS))
@pytest.mark.parametrize("key", list(MODELS))
def test_jax_checkpoint_restores_exactly(tmp_path, key, opt_key):
    """A file the JAX package's save_checkpoint wrote after two training
    steps, restored by the port: parameters, optimizer state, lr, step and
    global_epoch exactly as the JAX package's own load_checkpoint reads
    them.  The port's state written back with packb is the JAX file byte for
    byte (SGD: but its count, which torch's SGD does not keep), and the JAX
    package restores it."""
    name, params, tx, opt_state = _jax_trained(key, opt_key)
    path = jax_save(JaxState(params, opt_state), 7, str(tmp_path),
                    "Generator")
    jparams, jopt, jepoch = jax_load(path, opt_template=tx.init(params))
    assert jepoch == 7
    state = _port_state(name, key, opt_key)
    assert ckpt.restore(state, path) == 7
    names = _check_restored(state, jparams, jopt, opt_key)
    assert ckpt.load_checkpoint(path)[2] == 7

    payload = ckpt.jax_payload({"state_dict": state.model.state_dict(),
                                "optimizer": state.optimizer.state_dict(),
                                "global_epoch": 7}, *OPTIMIZERS[opt_key])
    blob = flax_msgpack.packb(payload)
    with open(path, "rb") as f:
        written = f.read()
    if opt_key != "SGD_momentum":
        assert blob == written
    else:
        mine, theirs = (serialization.msgpack_restore(b)
                        for b in (blob, written))
        assert int(mine["optimizer"].pop("count")) == 0
        theirs["optimizer"].pop("count")
        _same(mine, theirs)
    back = tmp_path / "port.pth"
    back.write_bytes(blob)
    p2, o2, e2 = jax_load(str(back), opt_template=tx.init(params))
    assert e2 == 7
    state2 = _port_state(name, key, opt_key)
    ckpt.restore(state2, str(back))
    assert _check_restored(state2, p2, o2, opt_key) == names


@pytest.mark.parametrize("opt_key", list(OPTIMIZERS))
def test_fresh_optimizer_written_as_jax_init(tmp_path, opt_key):
    """A port optimizer that has not stepped (torch's Adam and SGD keep no
    state yet) is written as the JAX package writes optax's initial state,
    byte for byte."""
    name, params, tx, opt_state = _jax_trained("MLP", opt_key, steps=0)
    path = jax_save(JaxState(params, opt_state), 0, str(tmp_path), "D")
    state = _port_state(name, "MLP", opt_key)
    state.model.load_state_dict(convert.flax_to_torch(params), strict=True)
    payload = ckpt.jax_payload({"state_dict": state.model.state_dict(),
                                "optimizer": state.optimizer.state_dict(),
                                "global_epoch": 0}, *OPTIMIZERS[opt_key])
    with open(path, "rb") as f:
        assert flax_msgpack.packb(payload) == f.read()


def _nest_dense(tree):
    """The layout of files written before TorchLinear held its parameters
    directly: each {kernel, bias} one level deeper, under Dense_0."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"kernel", "bias"}:
        return {"Dense_0": dict(tree)}
    return {k: _nest_dense(v) for k, v in tree.items()}


@pytest.mark.parametrize("key", ["MLP", "In2OutRNNHighwayNet"])
def test_dense_0_nested_file_reads_as_flat(tmp_path, key):
    """A Dense_0-nested file restores the same parameters and optimizer
    state as the flat one (the JAX package's _migrate_dense_scope)."""
    name, params, tx, opt_state = _jax_trained(key, "Adagrad_wd")
    flat = jax_save(JaxState(params, opt_state), 3, str(tmp_path), "G")
    payload = serialization.msgpack_restore(open(flat, "rb").read())
    nested = {k: _nest_dense(v) for k, v in payload.items()}
    assert "Dense_0" in json.dumps(jax.tree_util.tree_map(
        lambda a: 0, nested["state_dict"]))
    path = tmp_path / "nested.pth"
    path.write_bytes(serialization.msgpack_serialize(nested))
    a, b = _port_state(name, key, "Adagrad_wd"), _port_state(
        name, key, "Adagrad_wd")
    assert ckpt.restore(a, flat) == ckpt.restore(b, str(path)) == 3
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for i, st in a.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(b.optimizer.state_dict()["state"][i][k], v)


def test_optimizer_mismatch_names_both(tmp_path):
    """An Adam file given to an Adagrad model is an error naming both."""
    name, params, _, opt_state = _jax_trained("MLP", "Adam")
    path = jax_save(JaxState(params, opt_state), 1, str(tmp_path), "G")
    state = _port_state(name, "MLP", "Adagrad_wd")
    with pytest.raises(ValueError, match="Adam's.*optimizer is Adagrad"):
        ckpt.restore(state, path)
    # reset_optimizers keeps the fresh optimizer and reads the parameters
    assert ckpt.restore(state, path, reset_optimizer=True) == 1
    assert all(float(st["step"]) == 0 for st in
               state.optimizer.state_dict()["state"].values())


class _Exploit:
    """A pickle that would write a file if it were ever unpickled."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("protocol", [2, 3, 4, 5])
def test_legacy_pickle_is_refused_without_running_it(tmp_path, protocol):
    marker = tmp_path / "ran"
    path = tmp_path / "checkpoint_epoch1_Generator.pth"
    path.write_bytes(pickle.dumps({"state_dict": _Exploit(str(marker)),
                                   "global_epoch": 1}, protocol=protocol))
    with pytest.raises(ValueError, match="legacy pickle.*never executes"):
        ckpt.load_checkpoint(str(path))
    assert not marker.exists()


@pytest.mark.parametrize("content,match", [
    (b"", "neither"), (b"\x01\x02\x03", "neither"), (b"\x80", "holds no"),
    (b"\x81\xa5state\x00", "holds no")])
def test_unknown_or_empty_file_is_an_error(tmp_path, content, match):
    path = tmp_path / "x.pth"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint(str(path))


def test_truncated_jax_file_is_an_error(tmp_path):
    name, params, _, opt_state = _jax_trained("MLP", "Adagrad_wd")
    path = jax_save(JaxState(params, opt_state), 1, str(tmp_path), "G")
    blob = open(path, "rb").read()
    cut = tmp_path / "cut.pth"
    cut.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match=r"cut\.pth: truncated msgpack"):
        ckpt.load_checkpoint(str(cut))


# ---- (c) a GAN step resumed from the JAX package's files -------------------

STEP_KW = dict(w_d=1.0, mse_w=1.0, mge_w=1.0, update_d=True, update_g=True)
_RESUMED = {}


def _second_batch(batch_fn):
    """The resumed step's batch: the test's batch, reversed in time within
    each row's length (other inputs, same shapes and lengths)."""
    x, y, lengths, R, Y_mean, Y_std = batch_fn()
    for b, n in enumerate(lengths):
        x[b, :n], y[b, :n] = x[b, :n][::-1].copy(), y[b, :n][::-1].copy()
    return x, y, lengths, R, Y_mean, Y_std


def _jax_step(jtr, jg, jd, batch, adv_w):
    x, y, lengths, R, _, _ = batch
    return jtr.step_fn(True)(
        jg, jd, None, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths),
        None if R is None else jnp.asarray(R), None, jnp.float32(adv_w),
        jax.random.PRNGKey(1))


def _resumed(hp_fn, batch_fn, tmp):
    """One JAX step (the package's optimizer) from JAX init, saved with
    save_checkpoint; both packages restore the files and take one more
    step on another batch.  Returns, per adv_w in (1, 0): the JAX step's
    states and outputs, the port's, and the parameters before the step."""
    key = hp_fn
    if key in _RESUMED:
        return _RESUMED[key]
    jhp = hp_fn(jax_hparams)
    mg, md, tx_g, tx_d, jg, jd = jax_init(jhp, seed=0)
    jtr = JaxTrainer(mg, md, tx_g, tx_d, JaxConfig.from_hparams(jhp,
                                                                **STEP_KW),
                     *batch_fn()[4:], windows=jhp.windows)
    jg, jd, _, _ = _jax_step(jtr, jg, jd, batch_fn(), 1.0)
    paths = {n: jax_save(s, 1, tmp, n) for n, s in (("Generator", jg),
                                                    ("Discriminator", jd))}
    hp = hp_fn(hparams)
    batch = _second_batch(batch_fn)
    x, y, lengths, R, Y_mean, Y_std = batch
    out = {}
    for adv_w in (1.0, 0.0):
        restored = []
        for name, tx, (params0, opt0) in (
                ("Generator", tx_g, (jg.params, jg.opt_state)),
                ("Discriminator", tx_d, (jd.params, jd.opt_state))):
            params, opt, epoch = jax_load(paths[name],
                                          opt_template=tx.init(params0))
            assert epoch == 1
            restored.append(JaxState(params, opt))
        host = jax.tree_util.tree_map(np.array, [s.params for s in restored])
        rg, rd = restored
        txs = (tx_g, tx_d)
        if adv_w and jhp.optimizer_g == "Adagrad":
            # torch's rule (eps after the square root) from the restored
            # accumulators, so that loss_adv, taken through the updated
            # D, carries no eps gap
            txs = tuple(_torch_adagrad(**p) for p in (
                jhp.optimizer_g_params, jhp.optimizer_d_params))
            states = []
            for s, tx in zip(restored, txs):
                fresh = tx.init(s.params)
                acc = _scale_state(s.opt_state).sum_of_squares
                states.append(JaxState(s.params, (fresh[0], fresh[1], acc,
                                                  fresh[3])))
            rg, rd = states
        jtr2 = JaxTrainer(mg, md, *txs, JaxConfig.from_hparams(jhp,
                                                               **STEP_KW),
                          Y_mean, Y_std, windows=jhp.windows)
        jres = _jax_step(jtr2, rg, rd, batch, adv_w)

        _, _, _, _, tg, td = init_models_and_states(hp, seed=0, device="cpu")
        assert ckpt.restore(tg, paths["Generator"]) == 1
        assert ckpt.restore(td, paths["Discriminator"]) == 1
        tr = GanTrainer(StepConfig.from_hparams(hp, **STEP_KW), Y_mean, Y_std,
                        "cpu", windows=hp.windows)
        before = [{k: v.clone() for k, v in s.model.state_dict().items()}
                  for s in (tg, td)]
        for s, p in zip(before, host):
            for k, v in convert.flax_to_torch(p).items():
                assert torch.equal(s[k], v), k
        tres = tr.step(tg, td, torch.tensor(x), torch.tensor(y),
                       torch.tensor(lengths),
                       None if R is None else torch.tensor(R), adv_w)
        out[adv_w] = (jres, tres, host, int(lengths.sum()))
    _RESUMED[key] = out
    return out


@pytest.mark.parametrize("bundle", ["tts_acoustic", "tts_duration"])
def test_resumed_step_outputs_match_jax(tmp_path, bundle):
    """Losses, counts and metrics of the step after the restore, at rtol
    1e-5 (Adagrad: the JAX side takes torch's rule from the restored
    accumulators; Adam is already torch's rule)."""
    hp_fn, batch_fn = ((_hp, _batch) if bundle == "tts_acoustic"
                       else (_dur_hp, _dur_batch))
    (jg, jd, jout, _), (_, _, out), _, n = _resumed(hp_fn, batch_fn,
                                                    str(tmp_path))[1.0]
    assert float(out["num_frames"]) == n
    _check_outputs(jout, out, n)


def test_resumed_adagrad_update_matches_jax_up_to_eps(tmp_path):
    """The tts_acoustic (Adagrad) parameters after the resumed step, with
    adv_w = 0, against the JAX package's own optimizer, element by element.

    With S the accumulator after the step (restored sum plus g^2), the JAX
    package moves a parameter by lr g / sqrt(S + eps) and torch by lr g /
    (sqrt(S) + eps).  g is read from the JAX package's own step, g = (p0 -
    p) sqrt(S + eps) / lr, so the port must differ from the JAX package by
    the eps-placement gap lr g (1 / sqrt(S + eps) - 1 / (sqrt(S) + eps))
    within 1e-6 plus what a gradient difference at the noise level, 1e-5
    max|g| (tests/test_torch_step.py's), moves either rule: at most lr /
    sqrt(S) per unit of g."""
    (jg, jd, _, _), (tg, td, _), host, _ = _resumed(
        _hp, _batch, str(tmp_path))[0.0]
    lr, eps = 0.01, 1e-10
    n_checked, n_all, largest_gap = 0, 0, 0.0
    for jstate, tstate, p0 in ((jg, tg, host[0]), (jd, td, host[1])):
        ref = convert.flax_to_torch(jstate.params)
        start = convert.flax_to_torch(p0)
        acc = convert.flax_to_torch(
            _scale_state(jstate.opt_state).sum_of_squares)
        for name, p in tstate.model.named_parameters():
            s = acc[name].numpy().astype(np.float64)
            p0n = start[name].numpy().astype(np.float64)
            pj = ref[name].numpy().astype(np.float64)
            g = (p0n - pj) * np.sqrt(s + eps) / lr
            gap = lr * g * (1 / np.sqrt(s + eps) - 1 / (np.sqrt(s) + eps))
            diff = p.detach().numpy().astype(np.float64) - pj
            noise = 1e-5 * np.abs(g).max()
            sel = (np.abs(g) > noise) & (s > 0)
            slope = lr / np.sqrt(np.where(s > 0, s, 1.0))
            bad = np.abs(diff - gap) > 1e-6 + slope * noise
            assert not (bad & sel).any(), (name, np.abs(diff - gap).max())
            n_checked += int(sel.sum())
            n_all += sel.size
            largest_gap = max(largest_gap, float(np.abs(gap[sel]).max()))
    # most elements are checked, and the gap is not small where it shows
    assert n_checked > 0.5 * n_all > 1000
    assert largest_gap > 0.5 * lr


# ---- (d) the command lines on the JAX package's files ----------------------

SPEC = ("nepoch={},batch_size=4,batch_bucket_multiple=16,order=20,"
        "stream_sizes=[60, 3, 1, 3],discriminator_linguistic_condition=False,"
        "generator_params={{'in_dim': None, 'out_dim': None, "
        "'num_hidden': 2, 'hidden_dim': 16, 'bidirectional': False, "
        "'dropout': 0.2, 'use_relu': 1, 'rnn_dropout': 0.2, "
        "'last_sigmoid': False}},"
        "discriminator_params={{'in_dim': None, 'out_dim': 1, "
        "'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.5, "
        "'last_sigmoid': True}}")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """chip_smoke.py's synthetic acoustic corpus, cut to 30 linguistic
    dims, stream sizes [60, 3, 1, 3] and 14 utterances of 80-220 frames
    (tests/test_torch_train.py's)."""
    import chip_smoke

    d = str(tmp_path_factory.mktemp("acoustic"))
    chip_smoke.write_acoustic_corpus(d, num=14, lin_dim=30, mgc_dim=20,
                                     frames=(80, 221))
    return d


def _argv(corpus, ck, nepoch, *extra):
    return [join(corpus, "X_acoustic"), join(corpus, "Y_acoustic"),
            "--hparams_name=tts_acoustic", f"--hparams={SPEC.format(nepoch)}",
            "--w_d=1", f"--checkpoint-dir={ck}", f"--log-event-path={ck}/log",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def jax_files(corpus, tmp_path_factory):
    """The JAX package's checkpoints of the command line's models (its own
    setup, dims inferred from the corpus), one JAX training step in, at
    epoch 1; and the port's .pth of the same state."""
    from gantts_tpu.train.setup import load_arrays, prepare_tts

    ck = str(tmp_path_factory.mktemp("jax_ck"))
    jhp = jax_hparams.tts_acoustic.copy()
    jhp.parse(SPEC.format(1))
    X, Y, lengths = load_arrays(join(corpus, "X_acoustic"),
                                join(corpus, "Y_acoustic"))
    loaders, Y_mean, Y_std = prepare_tts(X, Y, lengths, jhp, corpus)
    mg, md, tx_g, tx_d, jg, jd = jax_init(jhp, seed=7)
    jtr = JaxTrainer(mg, md, tx_g, tx_d,
                     JaxConfig.from_hparams(jhp, **STEP_KW), Y_mean, Y_std,
                     windows=jhp.windows)
    x, y, ln = next(iter(loaders["train"]))
    R = unit_variance_mlpg_matrix(jhp.windows, x.shape[1])
    jg, jd, _, _ = jtr.step_fn(True)(
        jg, jd, None, jnp.asarray(x), jnp.asarray(y), jnp.asarray(ln),
        jnp.asarray(R), None, jnp.float32(1.0), jax.random.PRNGKey(0))
    files = {n: jax_save(s, 1, ck, n) for n, s in (("Generator", jg),
                                                   ("Discriminator", jd))}
    hp = hparams.tts_acoustic.copy().parse(SPEC.format(1))
    hp.generator_params.update(jhp.generator_params)
    hp.discriminator_params.update(jhp.discriminator_params)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, device="cpu")
    for n, s in (("Generator", gstate), ("Discriminator", dstate)):
        ckpt.restore(s, files[n])
        files[f"{n}.pth"] = ckpt.save_checkpoint(s, 1, ck, f"Port{n}")
    return files


def _run_train(argv):
    from gantts_tpu_torch.train.__main__ import main

    return main(argv)


def _rows(ck):
    with open(join(ck, "log", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_resumes_from_jax_files_as_from_pth(corpus, jax_files, tmp_path):
    """The training command line resumes a stage from JAX-written -g / -d
    with a JAX-written --checkpoint-r (the spoofing rate is logged), and
    logs and writes exactly what it does from the port's .pth of the same
    state."""
    runs = {}
    for fmt, suffix in (("jax", ""), ("pth", ".pth")):
        ck = str(tmp_path / fmt)
        g, d = (jax_files[f"{n}{suffix}"] for n in ("Generator",
                                                    "Discriminator"))
        assert _run_train(_argv(corpus, ck, 2, f"--checkpoint-g={g}",
                                f"--checkpoint-d={d}",
                                f"--checkpoint-r={d}")) == 0
        runs[fmt] = ck
    rows = {k: [(r["tag"], r["step"], r["value"]) for r in _rows(ck)
                if "frames_per_sec" not in r["tag"]
                and "epoch_seconds" not in r["tag"]]
            for k, ck in runs.items()}
    assert rows["jax"] == rows["pth"]
    assert {s for _, s, _ in rows["jax"]} == {2}
    assert any(t == "train spoofing rate" for t, _, _ in rows["jax"])
    for name in ("Generator", "Discriminator"):
        a, b = (torch.load(join(ck, f"checkpoint_epoch2_{name}.pth"),
                           weights_only=True) for ck in runs.values())
        for k, v in a["state_dict"].items():
            assert torch.equal(b["state_dict"][k], v), k
        for i, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(b["optimizer"]["state"][i][k], v), (i, k)
        assert a["optimizer"]["param_groups"] == b["optimizer"][
            "param_groups"]


def test_cli_subprocess_reads_jax_files(corpus, jax_files, tmp_path):
    """``python -m gantts_tpu_torch.train`` in its own process on the
    JAX-written files."""
    import subprocess

    ck = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "gantts_tpu_torch.train",
         *_argv(corpus, ck, 2, f"--checkpoint-g={jax_files['Generator']}",
                f"--checkpoint-d={jax_files['Discriminator']}")],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Start training from epoch 1" in proc.stdout
    assert exists(join(ck, "checkpoint_epoch2_Generator.pth"))


def _legacy_pickle(tmp_path):
    path = tmp_path / "checkpoint_epoch1_Discriminator.pth"
    path.write_bytes(pickle.dumps({"state_dict": {}, "global_epoch": 1},
                                  protocol=4))
    return str(path)


def test_cli_refuses_a_pickle_for_g(corpus, tmp_path):
    with pytest.raises(ValueError, match="legacy pickle"):
        _run_train(_argv(corpus, str(tmp_path / "ck"), 1,
                         f"--checkpoint-g={_legacy_pickle(tmp_path)}"))


def test_cli_warns_on_a_pickle_for_checkpoint_r(corpus, tmp_path):
    """As the JAX command line does: a warning, and the stage trains on
    without the reference discriminator."""
    ck = str(tmp_path / "ck")
    with pytest.warns(UserWarning, match="reference discriminator.*legacy"):
        assert _run_train(_argv(corpus, ck, 1, "--checkpoint-r="
                                + _legacy_pickle(tmp_path))) == 0
    assert not any("spoofing" in r["tag"] for r in _rows(ck))
    assert exists(join(ck, "checkpoint_epoch1_Generator.pth"))


def _same_outputs(a, b):
    """Two evaluation output directories hold the same files, bit for
    bit."""
    files = sorted(os.path.relpath(join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert "analysis.json" in files and len(files) > 2
    for f in files:
        with open(join(a, f), "rb") as x, open(join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def test_evaluation_vc_on_jax_file_as_on_pth(tmp_path):
    """evaluation_vc on a JAX-written generator gives the wavs and
    analysis.json it gives on the port's .pth of the same weights."""
    from test_torch_synthesis import _vc_corpus

    from gantts_tpu_torch import preprocessing as P
    from gantts_tpu_torch.evaluation_vc import main as eval_main

    _vc_corpus(str(tmp_path), 12)
    data = tmp_path / "data"
    X = [np.load(data / "X" / f) for f in sorted(os.listdir(data / "X"))]
    mean, var = P.meanvar(X, [len(x) for x in X])
    np.save(data / "data_mean", mean)
    np.save(data / "data_var", var)
    gen = dict(in_dim=36, out_dim=36, num_hidden=1, hidden_dim=16,
               static_dim=12, dropout=0.5)
    spec = (f"order=12,stream_sizes=[36],generator=In2OutRNNHighwayNet,"
            f"generator_params={gen!r}")
    jm = jax_create("In2OutRNNHighwayNet", **gen)
    R = jnp.asarray(unit_variance_mlpg_matrix(jax_hparams.vc.windows, 8))
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 36)), R,
                     jnp.asarray([8], jnp.int32))
    tx = jax_optimizer("Adagrad", dict(lr=0.01, weight_decay=0))
    jax_file = jax_save(JaxState(params, tx.init(params)), 1,
                        str(tmp_path), "Generator")
    pth = tmp_path / "port.pth"
    torch.save({"state_dict": convert.flax_to_torch(params),
                "optimizer": None, "global_epoch": 1}, pth)
    outs = []
    for path in (jax_file, str(pth)):
        out = str(tmp_path / f"out{len(outs)}")
        assert eval_main([path, str(data), str(tmp_path / "wav"), out,
                          f"--hparams={spec}", "--device", "cpu"]) == 0
        outs.append(out)
    _same_outputs(*outs)
    names = os.listdir(join(outs[0], "test"))
    _, y = wavfile.read(join(outs[0], "test", names[0]))
    assert np.abs(y).max() > 100


def test_evaluation_tts_on_jax_files_as_on_pth(tmp_path):
    """evaluation_tts on JAX-written acoustic and duration generators
    gives the wavs and analysis.json it gives on the port's .pth of the
    same weights."""
    from fixtures import make_tts_corpus

    from gantts_tpu_torch.evaluation_tts import main as eval_main
    from gantts_tpu_torch.prepare_features_tts import main as prep_main

    from gantts_tpu_torch import preprocessing as P

    corpus = make_tts_corpus(str(tmp_path / "corpus"), num=7)
    feats = str(tmp_path / "feats")
    assert prep_main([corpus, f"--dst_dir={feats}", "--workers=1"]) == 0
    tiny = dict(num_hidden=1, hidden_dim=8, bidirectional=True,
                dropout=0.0, use_relu=1, rnn_dropout=0.0, last_sigmoid=False)
    spec = f"generator_params={dict(tiny, in_dim=None, out_dim=None)!r}"
    files = {}
    for seed, typ in enumerate(("duration", "acoustic")):
        X = [np.load(join(feats, f"X_{typ}", f))
             for f in sorted(os.listdir(join(feats, f"X_{typ}")))]
        Y = [np.load(join(feats, f"Y_{typ}", f))
             for f in sorted(os.listdir(join(feats, f"Y_{typ}")))]
        # the stats the training command line would save
        stats = dict(zip(("X_{}_data_min", "X_{}_data_max"), P.minmax(X)))
        stats.update(zip(("Y_{}_data_mean", "Y_{}_data_var"), P.meanvar(Y)))
        for stat, value in stats.items():
            np.save(join(feats, stat.format(typ)), value)
        jm = jax_create("SRURNN", **dict(tiny, in_dim=X[0].shape[1],
                                         out_dim=Y[0].shape[1]))
        params = jm.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8, X[0].shape[1]), jnp.float32),
                         jnp.asarray([8], jnp.int32))
        files[typ] = (jax_save(JaxState(params, {}), 1, str(tmp_path), typ),
                      str(tmp_path / f"{typ}.pth"))
        torch.save({"state_dict": convert.flax_to_torch(params),
                    "optimizer": None, "global_epoch": 1}, files[typ][1])
    labels = join(corpus, "label_state_align")
    outs = []
    for i in (0, 1):
        out = str(tmp_path / f"out{i}")
        assert eval_main([files["acoustic"][i], files["duration"][i], feats,
                          labels, out, f"--hparams_acoustic={spec}",
                          f"--hparams_duration={spec}", "--device",
                          "cpu"]) == 0
        outs.append(out)
    _same_outputs(*outs)


# ---- (e) --profile-dir and --debug-nans ------------------------------------

@pytest.mark.parametrize("nepoch,traces", [(2, 1), (1, 0)])
def test_profile_dir_traces_the_second_epoch(corpus, tmp_path, capsys,
                                             nepoch, traces):
    prof = tmp_path / "prof"
    ck = str(tmp_path / "ck")
    assert _run_train(_argv(corpus, ck, nepoch,
                            f"--profile-dir={prof}")) == 0
    said = capsys.readouterr().out
    written = sorted(os.listdir(prof)) if prof.exists() else []
    assert len(written) == traces
    if traces:
        assert written == ["trace_epoch2.json"]
        assert f"written to {prof / written[0]}" in said
        trace = json.loads((prof / written[0]).read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any(n.startswith("aten::") for n in names)
    else:
        assert "No profile written" in said


@pytest.fixture(scope="module")
def nan_corpus(tmp_path_factory):
    """The acoustic corpus with one NaN frame in one utterance's targets."""
    import chip_smoke

    d = str(tmp_path_factory.mktemp("nan"))
    chip_smoke.write_acoustic_corpus(d, num=14, lin_dim=30, mgc_dim=20,
                                     frames=(80, 221))
    ydir = join(d, "Y_acoustic")
    first = join(ydir, sorted(os.listdir(ydir))[0])
    y = np.load(first)
    y[5] = np.nan
    np.save(first, y)
    return d


def test_debug_nans_fails_fast(nan_corpus, tmp_path):
    with pytest.raises(FloatingPointError,
                       match=r"epoch 1, train phase, batch 0: .*not finite"):
        _run_train(_argv(nan_corpus, str(tmp_path / "ck"), 1,
                         "--debug-nans"))


def test_without_debug_nans_the_nan_corpus_trains_on(nan_corpus, tmp_path):
    """As the JAX command line without its flag: the run ends, its logged
    losses are not finite."""
    ck = str(tmp_path / "ck")
    assert _run_train(_argv(nan_corpus, ck, 1)) == 0
    assert exists(join(ck, "checkpoint_epoch1_Generator.pth"))
    assert not all(np.isfinite(r["value"]) for r in _rows(ck)
                   if r["tag"].endswith("loss"))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_clipped_optimizer_steps_through_a_nonfinite_norm(bad):
    """The optimizer never reads the gradient norm on the host: a norm
    that is not finite is kept on the device and the step runs, as
    torch's clip does (only the loop's --debug-nans read stops it)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = create_optimizer("Adagrad", dict(lr=0.01), [p])
    p.grad = torch.tensor([1.0, bad, 0.0])
    opt.step()
    assert not torch.isfinite(opt.grad_norm)
    assert not torch.isfinite(p.detach()).all()


def test_debug_nans_names_the_loss():
    from gantts_tpu_torch.train.loop import _require_finite_losses

    out = {"mse": torch.tensor(1.0), "mge": torch.tensor(float("nan")),
           "num_frames": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="here: the mge loss"):
        _require_finite_losses(out, "here")
    _require_finite_losses({"mse": torch.tensor(2.0)}, "here")


@pytest.mark.parametrize("debug_nans", [False, True])
def test_debug_nans_alone_reads_the_norm(corpus, tmp_path, debug_nans):
    """Only with the flag does the loop read the gradient norms (and the
    losses) on the host, once a step; torch's clip is never asked to read
    the norm itself, so without the flag the step is the one the loop
    always took."""
    from gantts_tpu_torch.train import loop

    seen, reads = [], []
    real = torch.nn.utils.clip_grad_norm_
    real_read = loop._require_finite_losses

    def spy(*args, **kwargs):
        seen.append(kwargs.get("error_if_nonfinite", False))
        return real(*args, **kwargs)

    def read(out, where, norms=()):
        reads.append([name for name, _ in norms])
        return real_read(out, where, norms)
    flags = ["--debug-nans"] * debug_nans
    with mock.patch.object(torch.nn.utils, "clip_grad_norm_", spy), \
            mock.patch.object(loop, "_require_finite_losses", read):
        assert _run_train(_argv(corpus, str(tmp_path), 1, *flags)) == 0
    assert seen and set(seen) == {False}
    assert bool(reads) == debug_nans
    assert not debug_nans or ["discriminator", "generator"] in reads
