"""A configuration's weights, made on the device from the seed: every
Xavier-normal kernel from one ``randn`` call and every uniform one from
one ``rand`` call of a card-side generator, biases zero, in float32 (the
type the models are served in).

Each network draws from a stream of its own: stream 0 (the prior) is the
seed itself, so a second network leaves the prior's draw as it was."""

from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """The generator seed of ``stream``: ``seed`` itself for stream 0,
    else a 63-bit word of ``SeedSequence([seed, stream])``."""
    seed = int(seed) & (2**63 - 1)
    if stream == 0:
        return seed
    word = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0]
    return int(word) & (2**63 - 1)


def xavier_std(shape) -> float:
    """Xavier-normal's std of a kernel (out, in, *receptive field): both
    fans multiplied by the receptive field, as ``nn.init.xavier_normal_``."""
    field = math.prod(shape[2:])
    return math.sqrt(2.0 / ((shape[0] + shape[1]) * field))


def make(params, seed: int, device, stream: int = 0) -> dict:
    """``{name: tensor}`` for ``params``, each ``(name, shape, "xavier" |
    "zero")`` or ``(name, shape, "uniform", bound)`` (U(-bound, bound), as
    torch's LSTM init draws with bound 1/sqrt(hidden)), each kernel (out,
    in, ...), drawn from ``stream`` of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    sizes = {kind: sum(math.prod(shape) for _, shape, k, *_ in params if k == kind)
             for kind in ("xavier", "uniform")}
    flat = {"xavier": torch.randn((sizes["xavier"],), generator=gen, device=device)}
    if sizes["uniform"]:
        flat["uniform"] = torch.rand((sizes["uniform"],), generator=gen, device=device)
    out, at = {}, {"xavier": 0, "uniform": 0}
    for name, shape, kind, *arg in params:
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        if kind not in at:
            raise ValueError(f"bad init {kind!r} of {name}")
        n, a = math.prod(shape), at[kind]
        block = flat[kind][a:a + n]
        if kind == "xavier":
            out[name] = (block * xavier_std(shape)).reshape(shape)
        else:
            out[name] = ((block * 2 - 1) * arg[0]).reshape(shape)
        at[kind] = a + n
    return out
