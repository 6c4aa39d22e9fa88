"""The comparison that decides ``correct``: the program's first three
training steps, as the window's own call drove them in its epoch 1, against
the plain reference (``perfbench/reference``) started from the same
weights, the same batches and the same dropout stream.

Up to three numbers, each against the limit in the configuration's file
(the third where the third step ends a dispatch, so that the parameters
after it can be read; inside a graph replay they cannot):

  ``loss_gap``    the widest |program - reference| / |reference| of the
                  discriminator's and the generator's loss over the three
                  steps;
  ``grad_gap``    the first gradient as each optimizer got it (clipped,
                  with weight decay), read from the program's Adagrad
                  accumulator after one step (its square root): by the
                  worst leaf, the gap between the program's and the
                  reference's norm of the leaf over the larger of the
                  reference's norm of that leaf and of the median leaf;
  ``change_gap``  the same of each leaf's change over the three steps,
                  leaving out the leaves whose first reference gradient is
                  under a thousandth of the median leaf's (nought to
                  rounding: they move by round-off alone).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench.reference import gan

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
REQUIRED = ("loss_gap", "grad_gap")
LOSSES = ("discriminator", "generator")
NEGLIGIBLE = 1e-3


def norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gap(program, reference, keep=None):
    """max over leaves |p - r| / max(r, the median leaf's r)."""
    keys = [k for k in reference if keep is None or k in keep]
    med = statistics.median(reference[k] for k in keys)
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
               for k in keys)


def loss_gap(program, reference):
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
               for p, r in zip(program, reference) for k in LOSSES)


def readings(program, reference):
    """The numbers from two records, each of ``losses`` (a dict a step),
    ``grad`` (leaf -> norm of the first gradient) and ``change`` (leaf ->
    norm of the change over the three steps, None where it was not read).
    """
    out = {"loss_gap": loss_gap(program["losses"], reference["losses"]),
           "grad_gap": leaf_gap(program["grad"], reference["grad"])}
    if program["change"] is not None:
        med = statistics.median(reference["grad"].values())
        keep = {k for k, v in reference["grad"].items()
                if v >= NEGLIGIBLE * med}
        out["change_gap"] = leaf_gap(program["change"], reference["change"],
                                     keep)
    return out


def detail(program, reference, top=5):
    """What lies behind the readings: each step's losses on both sides,
    and the leaves with the widest gaps of the first gradient and of the
    change, with their norms (program, reference)."""
    def worst(key):
        if program[key] is None:
            return None
        med = statistics.median(reference[key].values())
        gaps = sorted(((abs(program[key][k] - reference[key][k])
                        / max(reference[key][k], med, 1e-30), k)
                       for k in reference[key]), reverse=True)
        return [[k, g, program[key][k], reference[key][k]]
                for g, k in gaps[:top]] + [["median", med]]
    return {"losses": [[p, r] for p, r in zip(program["losses"],
                                              reference["losses"])],
            "grad": worst("grad"), "change": worst("change")}


def verdict(values, limits):
    """(correct, the compared numbers beside their limits)."""
    compared = {k: {"value": values.get(k), "limit": limits[k]}
                for k in NUMBERS if k in REQUIRED or k in values}
    ok = all(v["value"] is not None and np.isfinite(v["value"])
             and v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


def reference_record(family, hp, run, raw, weights, loop_seed, device,
                     tf32=False, half_batch=False, dtype=torch.float32,
                     update=True):
    """The plain reference's three steps from the raw corpus: its own split,
    statistics, normalization and batch order (the first three batches of
    the first shuffled epoch), the weights given (name -> tensor, ``G.`` and
    ``D.`` prefixed), the dropout stream of ``loop_seed`` on ``device``.
    ``tf32``: the products in TF32 (the control); ``half_batch``: each
    batch's first half of rows alone, ``update`` False: the state left
    unchanged (faults); ``dtype`` float64: the look at what rounding alone
    does to the numbers."""
    L, X, Y = raw
    tr, _ = gan.split(len(L))
    Xtr, Ytr = [X[i] for i in tr], [Y[i] for i in tr]
    st = gan.stats(Xtr, Ytr, "vc" if hp["name"] == "vc" else "tts")
    B = hp["batch_size"]
    old = gan.set_precision(tf32)
    try:
        G = {k[2:]: v.to(dtype, copy=True) for k, v in weights.items()
             if k[:2] == "G."}
        D = {k[2:]: v.to(dtype, copy=True) for k, v in weights.items()
             if k[:2] == "D."}
        step = gan.GanStep(family.generator, G, D, hp, run, device, dtype,
                           update)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(loop_seed))
        losses, first = [], None
        for j, idx in enumerate(gan.batch_indices(len(tr), B, 0)[:3]):
            items = [gan.normalize(Xtr[i], Ytr[i], st) for i in idx]
            x, y, lengths = gan.make_batch(items, B, hp["batch_bucket_multiple"])
            if half_batch:
                h = B // 2
                x, y, lengths = x[:h], y[:h], lengths[:h]
            # the first epoch's adversarial weight: w_d E(mge) / E(adv)
            # with both expectations at their start, 1
            out, used_g, used_d = step(x, y, lengths, gen, run["w_d"])
            losses.append(out)
            if j == 0:
                first = {**{"G." + k: v for k, v in used_g.items()},
                         **{"D." + k: v for k, v in used_d.items()}}
        after = {**{"G." + k: v for k, v in step.G.items()},
                 **{"D." + k: v for k, v in step.D.items()}}
        change = {k: after[k] - weights[k].to(dtype) for k in weights}
        return {"losses": losses, "grad": norms(first),
                "change": norms(change)}
    finally:
        gan.restore_precision(old)

