"""Plain forward passes of the VAE family's dense stacks, over a dict of
weights named as the published models' ``state_dict`` (each Linear's
weight (out, in))."""

from __future__ import annotations

import torch

from benchmark.reference.mcem import Decoder
from benchmark.reference.precision import Precision


def linear_params(prefix: str, fan_in: int, fan_out: int) -> list:
    """(name, shape, init) of one Linear: Xavier-normal weight, zero bias."""
    return [(f"{prefix}.weight", (fan_out, fan_in), "xavier"), (f"{prefix}.bias", (fan_out,), "zero")]


def stack_params(prefix: str, dims) -> list:
    """The Linear layers ``{prefix}.{i}`` through ``dims``."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += linear_params(f"{prefix}.{i}", a, b)
    return out


def encoder_params(prefix: str, x_dim: int, h_dim, z_dim: int) -> list:
    h = tuple(h_dim)
    last = h[-1] if h else x_dim
    return (stack_params(f"{prefix}.hidden", (x_dim, *h))
            + linear_params(f"{prefix}.sample.mu", last, z_dim)
            + linear_params(f"{prefix}.sample.log_var", last, z_dim))


def decoder_params(prefix: str, in_dim: int, h_dim, x_dim: int) -> list:
    h = tuple(reversed(tuple(h_dim)))
    return (stack_params(f"{prefix}.hidden", (in_dim, *h))
            + linear_params(f"{prefix}.reconstruction", h[-1] if h else in_dim, x_dim))


def classifier_params(prefix: str, in_dim: int, h_dim, y_dim: int) -> list:
    h = tuple(h_dim)
    return (stack_params(f"{prefix}.hidden", (in_dim, *h))
            + linear_params(f"{prefix}.output_layer", h[-1] if h else in_dim, y_dim))


def _layer(w, prefix, x, prec: Precision):
    return prec.matmul(x, w[f"{prefix}.weight"].t()) + w[f"{prefix}.bias"]


def encoder_mean(w: dict, prefix: str, depth: int, x, prec: Precision):
    """The posterior mean: tanh layers, then the ``mu`` head."""
    for i in range(depth):
        x = torch.tanh(_layer(w, f"{prefix}.hidden.{i}", x, prec))
    return _layer(w, f"{prefix}.sample.mu", x, prec)


def classify(w: dict, prefix: str, depth: int, x, prec: Precision):
    """relu layers, then the Linear head and a sigmoid."""
    for i in range(depth):
        x = torch.relu(_layer(w, f"{prefix}.hidden.{i}", x, prec))
    return torch.sigmoid(_layer(w, f"{prefix}.output_layer", x, prec))


def decoder(w: dict, prefix: str, depth: int, z_dim: int) -> Decoder:
    """The decoder's weights as (in, out) matrices, its first layer split
    after the ``z_dim`` latent rows."""
    w1 = w[f"{prefix}.hidden.0.weight"].t().float()
    hidden = tuple((w[f"{prefix}.hidden.{i}.weight"].t().float(),
                    w[f"{prefix}.hidden.{i}.bias"].float()) for i in range(1, depth))
    return Decoder(w1[:z_dim].contiguous(), w1[z_dim:].contiguous() if w1.shape[0] > z_dim
                   else None, w[f"{prefix}.hidden.0.bias"].float(), hidden,
                   w[f"{prefix}.reconstruction.weight"].t().float().contiguous(),
                   w[f"{prefix}.reconstruction.bias"].float())
