"""Checkpoint save and restore with the reference's naming contract
(counterpart of gantts_tpu/train/checkpoint.py).

The GAN curriculum (train_gan.sh) hands state between separate processes
through files named ``checkpoint_epoch{N}_{Generator|Discriminator}.pth``
holding {state_dict, optimizer, global_epoch}.  The port writes them with
``torch.save``: the model's ``state_dict`` (the JAX package's parameter names,
see ``convert.py``) and the torch optimizer's.  A file is written to a
temporary name and renamed, so a crash mid-write never leaves a corrupt
checkpoint for the next stage; under data parallelism rank 0 alone writes.

``load_checkpoint`` reads three formats, told apart by their first bytes,
and executes no code from any file:

  * ``torch.save``'s zip (``PK\\x03\\x04``), read with ``weights_only=True``;
  * the JAX package's flax msgpack (a map), decoded by ``flax_msgpack``:
    its parameter tree becomes the ``state_dict`` bit for bit (after the
    JAX package's ``Dense_0`` migration), and its optax state is carried
    into ``torch.optim``'s by ``optax_to_torch``;
  * the JAX package's legacy pickle (``0x80`` and a protocol number of 5 or
    less), which is refused: unpickling executes code from the file.

Anything else is an error.  ``optax_state_dict`` is the inverse map, for
writing JAX-format files from the port's state (``jax_payload``).
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
import torch
import torch.distributed as dist

from gantts_tpu_torch import convert
from gantts_tpu_torch.train import flax_msgpack

ZIP_MAGIC = b"PK\x03\x04"


def save_checkpoint(state, epoch, checkpoint_dir, name):
    """``state``: a TrainState (model, optimizer); ``name``: Generator or
    Discriminator.  Returns the path written.

    In a ``torch.distributed`` group the state is replicated, so rank 0
    alone writes, and every rank then waits at a barrier: none goes on
    before the file it may read next exists."""
    path = join(checkpoint_dir, f"checkpoint_epoch{epoch}_{name}.pth")
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped or dist.get_rank() == 0:
        payload = {"state_dict": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "global_epoch": int(epoch)}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        print("Saved checkpoint:", path)
    if grouped:
        dist.barrier()
    return path


def _migrate_dense_scope(tree):
    """The JAX package's back-compat rule (gantts_tpu/train/checkpoint.py
    ``_migrate_dense_scope``): a scope holding only ``Dense_0`` with exactly
    {kernel, bias} is flattened, so files written before TorchLinear held
    its parameters directly read the same."""
    if isinstance(tree, list):
        return [_migrate_dense_scope(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"Dense_0"} and isinstance(tree["Dense_0"], dict) \
            and set(tree["Dense_0"]) == {"kernel", "bias"}:
        return dict(tree["Dense_0"])
    return {k: _migrate_dense_scope(v) for k, v in tree.items()}


def _is_legacy_pickle(head):
    # the JAX package's rule: pickle protocol 2+ opens with PROTO (0x80)
    # and its number; 0x80 alone is also msgpack's empty map
    return len(head) >= 2 and head[0] == 0x80 and head[1] <= 5


def _is_msgpack_map(head):
    return len(head) >= 1 and (0x80 <= head[0] <= 0x8F
                               or head[0] in (0xDE, 0xDF))


def load_checkpoint(path):
    """Returns (state_dict, optimizer, global_epoch), tensors on the CPU;
    ``load_state_dict`` moves them to the model's device.  ``optimizer`` is
    None, a torch optimizer ``state_dict`` (``torch.save`` files) or the
    JAX package's optax state tree (flax files; ``restore`` maps it)."""
    print(f"Load checkpoint from: {path}")
    with open(path, "rb") as f:
        head = f.read(4)
        if head == ZIP_MAGIC:
            payload = torch.load(path, map_location="cpu", weights_only=True)
            return (payload["state_dict"], payload.get("optimizer"),
                    int(payload["global_epoch"]))
        if _is_legacy_pickle(head):
            raise ValueError(
                f"{path} is a legacy pickle checkpoint of the JAX package; "
                "this program never executes code from a file, and "
                "unpickling would.  Load it with the JAX package and save "
                "it again, which writes flax msgpack")
        if not _is_msgpack_map(head):
            raise ValueError(
                f"{path} is neither a torch.save checkpoint nor a flax "
                f"msgpack one (it starts with {head.hex() or 'nothing'})")
        blob = head + f.read()
    try:
        payload = flax_msgpack.unpackb(blob)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    missing = {"state_dict", "global_epoch"} - set(payload)
    if missing:
        raise ValueError(f"{path} holds no {sorted(missing)}: not a "
                         f"checkpoint")
    opt = payload.get("optimizer")
    state_dict = _migrate_dense_scope(payload["state_dict"])
    return (convert.flax_to_torch(state_dict),
            None if opt is None else _migrate_dense_scope(opt),
            int(payload["global_epoch"]))


def restore(state, path, reset_optimizer=False):
    """Load a checkpoint into ``state`` in place: the model's parameters
    and, unless ``reset_optimizer`` or the file has none, the optimizer's
    state.  Returns the checkpoint's global epoch."""
    state_dict, opt, epoch = load_checkpoint(path)
    state.model.load_state_dict(state_dict, strict=True)
    if opt and not reset_optimizer:  # None, or a file's empty optimizer
        if "inner_state" in opt:
            opt = optax_to_torch(opt, state.optimizer, state.model)
        state.optimizer.load_state_dict(opt)
    return epoch


# ---- optax state <-> torch.optim state --------------------------------------
#
# The JAX package's optimizer is inject_hyperparams(chain(clip,
# [add_decayed_weights], scale_by_*, scale)) (gantts_tpu/train/optim.py),
# which flax's to_state_dict flattens to
#   {count, hyperparams: {learning_rate, ...}, hyperparams_states: {},
#    inner_state: {"0": {}, ["1": {}], "k": <scale_by_* state>, ...: {}}}
# with each per-parameter entry a {"params": ...} tree.  The scale_by_*
# entry moves with weight_decay, so it is found by its keys.

_SCALE_KEYS = {"Adagrad": ("sum_of_squares",), "Adam": ("count", "mu", "nu"),
               "SGD with momentum": ("trace",)}
# the factories' numeric arguments after learning_rate, with their defaults:
# inject_hyperparams keeps those the bundle does not pass in the state
_FACTORY_ARGS = {"Adagrad": (("weight_decay", 0.0),),
                 "Adam": (("b1", 0.9), ("b2", 0.999), ("weight_decay", 0.0)),
                 "SGD": (("momentum", 0.0), ("weight_decay", 0.0))}


def _torch_kind(optimizer):
    inner = getattr(optimizer, "inner", optimizer)
    kind = type(inner).__name__
    if kind == "SGD" and inner.param_groups[0]["momentum"]:
        kind = "SGD with momentum"
    if kind not in _SCALE_KEYS and kind != "SGD":
        raise ValueError(f"no optax counterpart for torch.optim.{kind}")
    return kind


def _scale_entry(opt_tree):
    """(kind, entry) of the chain's scale_by_* state; ("SGD", None) for a
    chain without one."""
    found = [(kind, entry) for entry in opt_tree["inner_state"].values()
             for kind, keys in _SCALE_KEYS.items()
             if isinstance(entry, dict) and set(entry) == set(keys)]
    if len(found) > 1:
        raise ValueError("the optimizer state holds more than one "
                         "scale_by_* entry")
    return found[0] if found else ("SGD", None)


def _named_indices(optimizer, model):
    """[(index in the optimizer's state_dict, parameter name)], in the
    optimizer's param_groups order."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return [(i, names[id(p)]) for i, p in enumerate(params)]


def _per_name(tree, names, what):
    values = convert.flax_to_torch(tree)
    if set(values) != set(names):
        raise ValueError(
            f"{what}: parameters {sorted(set(names) - set(values))} missing "
            f"and {sorted(set(values) - set(names))} unknown")
    return values


def _scalar_step(value):
    return torch.tensor(float(np.asarray(value)), dtype=torch.float32)


def optax_to_torch(opt_tree, optimizer, model):
    """The JAX package's optax state (flax ``to_state_dict`` layout) as a
    ``state_dict`` for ``optimizer``, which updates ``model``'s parameters.
    Matched by parameter name: Adagrad's ``sum_of_squares`` -> ``sum`` and
    the chain's ``count`` -> ``step``; Adam's ``mu`` / ``nu`` / ``count``
    -> ``exp_avg`` / ``exp_avg_sq`` / ``step``; SGD's ``trace`` ->
    ``momentum_buffer``; ``hyperparams.learning_rate`` -> every group's
    ``lr`` (the JAX command line resumes with the stored rate)."""
    kind, entry = _scale_entry(opt_tree)
    want = _torch_kind(optimizer)
    if kind != want:
        raise ValueError(
            f"the checkpoint's optimizer state is {kind}'s "
            f"(inner_state {sorted(opt_tree['inner_state'])}) but this "
            f"model's optimizer is {want}")
    indexed = _named_indices(optimizer, model)
    names = [n for _, n in indexed]
    if kind == "Adagrad":
        sums = _per_name(entry["sum_of_squares"], names, "sum_of_squares")
        state = {i: {"step": _scalar_step(opt_tree["count"]), "sum": sums[n]}
                 for i, n in indexed}
    elif kind == "Adam":
        mu = _per_name(entry["mu"], names, "mu")
        nu = _per_name(entry["nu"], names, "nu")
        state = {i: {"step": _scalar_step(entry["count"]), "exp_avg": mu[n],
                     "exp_avg_sq": nu[n]} for i, n in indexed}
    elif kind == "SGD with momentum":
        trace = _per_name(entry["trace"], names, "trace")
        state = {i: {"momentum_buffer": trace[n]} for i, n in indexed}
    else:
        state = {}
    lr = float(np.asarray(opt_tree["hyperparams"]["learning_rate"]))
    groups = [dict(g, lr=lr) for g in optimizer.state_dict()["param_groups"]]
    return {"state": state, "param_groups": groups}


def _f32(x):
    return np.asarray(x, np.float32)


def optax_state_dict(opt_state, params, name, params_dict):
    """Inverse of ``optax_to_torch``: a torch optimizer ``state_dict``
    (``opt_state``) as the JAX package's ``to_state_dict(opt_state)`` for
    the optimizer its ``create_optimizer(name, params_dict)`` builds.
    ``params``: the parameters by name, in the optimizer's index order; a
    parameter without state (an optimizer not yet stepped) gets optax's
    initial zeros.  torch's SGD keeps no step count, so SGD's ``count`` is
    written as 0."""
    kind = "SGD" if name == "Sgd" else name
    kwargs = dict(params_dict)
    if "betas" in kwargs:
        kwargs["b1"], kwargs["b2"] = kwargs.pop("betas")
    states = [opt_state["state"].get(i, {}) for i in range(len(params))]

    def tree(key):
        return convert.torch_to_flax(
            {n: s[key] if key in s else torch.zeros_like(p)
             for (n, p), s in zip(params.items(), states)})

    def count(key):
        return np.asarray(int(states[0].get(key, 0)) if states else 0,
                          np.int32)

    if kind == "Adagrad":
        scale, outer = {"sum_of_squares": tree("sum")}, count("step")
    elif kind == "Adam":
        scale = {"count": count("step"), "mu": tree("exp_avg"),
                 "nu": tree("exp_avg_sq")}
        outer = scale["count"]
    elif kind == "SGD":
        scale = ({"trace": tree("momentum_buffer")}
                 if kwargs.get("momentum") else None)
        outer = np.asarray(0, np.int32)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    chain = [{}] + ([{}] if kwargs.get("weight_decay") else []) + \
        ([scale] if scale is not None else []) + [{}]
    # 0-d arrays, as jax arrays are written (np.float32 would be npscalars)
    hyper = {"learning_rate": _f32(opt_state["param_groups"][0]["lr"])}
    hyper.update({k: _f32(default) for k, default in _FACTORY_ARGS[kind]
                  if k not in kwargs})
    return {"count": outer, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": {str(i): s for i, s in enumerate(chain)}}


def jax_payload(payload, name, params_dict):
    """A ``torch.save`` checkpoint's payload as the JAX package's
    ``save_checkpoint`` lays it out, for ``flax_msgpack.packb``.  The
    ``state_dict`` holds parameters only (the port's models have no
    buffers), in the optimizer's index order."""
    state_dict = payload["state_dict"]
    out = {"state_dict": convert.torch_to_flax(state_dict),
           "global_epoch": int(payload["global_epoch"])}
    if payload.get("optimizer") is not None:
        out["optimizer"] = optax_state_dict(
            payload["optimizer"], state_dict, name, params_dict)
    return out
