"""A configuration's weights, made on the device from the seed: every
Xavier-normal matrix from one ``randn`` call of a card-side generator,
biases zero, in float32 (the type the models are served in)."""

from __future__ import annotations

import math

import torch


def make(params, seed: int, device) -> dict:
    """``{name: tensor}`` for ``params`` ((name, shape, "xavier" | "zero"),
    each weight (out, in)), drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    sizes = [math.prod(shape) for _, shape, kind in params if kind == "xavier"]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in params:
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out
