"""Carry parameters between the JAX package and the port.

The port's modules use the JAX package's scope and parameter names and
layouts (``TorchLinear`` keeps the (in, out) ``kernel``; SRU layers keep
``w`` (D, kH), ``bf`` and ``br`` under ``gru/l{i}_{fwd,bwd}``; LSTM layers
keep ``w_ih`` (D, 4H), ``w_hh`` (H, 4H), ``b_ih`` and ``b_hh`` under
``lstm/l{i}_{fwd,bwd}``, or ``gru/...`` for GRURNN), so a flax
parameter tree and a torch ``state_dict`` differ only in nesting:
``{"params": {"gru": {"l0_fwd": {"w": ...}}}}`` <-> ``"gru.l0_fwd.w"``.
Both directions copy the values bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def flax_to_torch(params_tree):
    """Flax variables (``{"params": tree}``) or a bare parameter tree ->
    ``state_dict`` of CPU tensors.  Leaves are NumPy arrays, or torch
    tensors (``flax_msgpack`` reads bfloat16 into them)."""
    if isinstance(params_tree, Mapping) and set(params_tree) == {"params"}:
        params_tree = params_tree["params"]
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            elif torch.is_tensor(value):  # bfloat16, which NumPy lacks
                out[name] = value.detach().clone()
            else:
                out[name] = torch.from_numpy(np.array(value, copy=True))
    walk(params_tree, "")
    return out


def torch_to_flax(state_dict):
    """``state_dict`` -> flax variables ``{"params": tree}`` of numpy
    arrays."""
    tree = {}
    for name, value in state_dict.items():
        *scopes, leaf = name.split(".")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return {"params": tree}
