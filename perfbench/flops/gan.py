"""Operations of the parts of the GAN step that every generator family
shares: the MLP discriminator and the dense MLPG product.

Counts are of matrix products only, 2 * m * k * n each, and of what the
step needs: the discriminator's update takes its forward on [real | fake]
(2 rows a frame) and its weight gradients, and input gradients of every
layer but the first; the generator's adversarial loss takes the frozen
discriminator's forward on the fake and input gradients of every layer, no
weight gradient.  A test step runs the three forwards and nothing else.
"""

from __future__ import annotations


def mlp_dims(hp):
    dp = hp["discriminator_params"]
    dims = [dp["in_dim"]] + [dp["hidden_dim"]] * dp["num_hidden"] + \
        [dp["out_dim"]]
    return list(zip(dims[:-1], dims[1:]))


def discriminator(hp, rows, train):
    """Operations of the discriminator in one step over ``rows`` frames."""
    layers = mlp_dims(hp)
    fwd = sum(2 * i * o for i, o in layers)
    total = 3 * rows * fwd                     # [real | fake], then the fake
    if train:
        dx_after_first = sum(2 * i * o for i, o in layers[1:])
        total += 2 * rows * (fwd + dx_after_first)  # D update: dW, dx
        total += rows * fwd                         # G's loss: dx only
    return total


def mlpg(hp, lengths, T, train):
    """Operations of the dense MLPG product R (T, K T) @ m (K T, S) for each
    dynamic stream, per row at padded length ``T``, or at each row's own
    length when ``T`` is None; doubled for the gradient to m in a
    training step (R takes none)."""
    K = len(hp["windows"])
    S = sum(s // K for s, d in zip(hp["stream_sizes"],
                                   hp["has_dynamic_features"]) if d)
    rows = [T] * len(lengths) if T is not None else [int(n) for n in lengths]
    total = sum(2 * t * K * t * S for t in rows)
    return 2 * total if train else total
