"""Building blocks of the VAE family as ``nn.Module``s (port of
``dvae_tpu.models.blocks``).

Parameter names are the reference's ``state_dict`` names: hidden layers sit
in a ``ModuleList`` (``hidden.0``, ``hidden.1``, ...), the Gaussian heads are
``sample.mu`` / ``sample.log_var``, the decoder output is
``reconstruction`` and a classifier's head is ``output_layer``. Encoder and
decoder MLPs use tanh, classifiers relu; the decoder ends in ``exp`` (a
variance spectrogram); every Linear is Xavier-normal with zero bias.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


def init_xavier_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Xavier-normal weights and zero biases for every Linear in ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.xavier_normal_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
    return module


class MLP(nn.ModuleList):
    """Stack of Linear layers with tanh after every layer."""

    def __init__(self, in_features: int, hidden: Sequence[int]):
        dims = [in_features, *hidden]
        super().__init__(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self:
            x = torch.tanh(layer(x))
        return x


class GaussianSample(nn.Module):
    """mu / log-variance heads + reparametrized sample. The standard normal
    ``eps`` is drawn from ``generator`` unless it is given."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.mu = nn.Linear(in_features, out_features)
        self.log_var = nn.Linear(in_features, out_features)

    def forward(self, h, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        mu = self.mu(h)
        log_var = self.log_var(h)
        if sample:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                                  dtype=mu.dtype)
            z = mu + torch.exp(0.5 * log_var) * eps
        else:
            z = mu
        return z, mu, log_var


class Encoder(nn.Module):
    """tanh MLP -> GaussianSample. Returns (z, mu, log_var)."""

    def __init__(self, x_dim: int, hidden: Sequence[int], z_dim: int):
        super().__init__()
        self.hidden = MLP(x_dim, hidden)
        self.sample = GaussianSample(hidden[-1] if hidden else x_dim, z_dim)

    def forward(self, x, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        return self.sample(self.hidden(x), sample=sample, generator=generator, eps=eps)


class Decoder(nn.Module):
    """tanh MLP -> Linear -> exp. Output is a variance spectrogram."""

    def __init__(self, z_dim: int, hidden: Sequence[int], x_dim: int):
        super().__init__()
        self.hidden = MLP(z_dim, hidden)
        self.reconstruction = nn.Linear(hidden[-1] if hidden else z_dim, x_dim)

    def forward(self, z):
        return torch.exp(self.reconstruction(self.hidden(z)))


class _ReluMLP(nn.Module):
    """``hidden.{i}`` Linear layers with relu after each, then the Linear
    head ``output_layer``: the classifiers' shared body."""

    def __init__(self, in_features: int, hidden: Sequence[int], out_features: int):
        super().__init__()
        dims = [in_features, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.output_layer = nn.Linear(dims[-1], out_features)

    def logits(self, x):
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.output_layer(x)


class Classifier(_ReluMLP):
    """relu MLP -> Linear -> sigmoid (per-label Bernoulli probabilities).

    ``batch_norm=True`` (the reference's interleaved BatchNorm1d blocks) is
    not ported: no trainer enables it, and ``convert.state_dict_from_jax``
    cannot name BatchNorm leaves."""

    def __init__(self, in_features: int, hidden: Sequence[int], y_dim: int,
                 batch_norm: bool = False):
        if batch_norm:
            raise NotImplementedError(
                "Classifier(batch_norm=True) is not served by this port yet "
                "(a later PR, ROADMAP queue A16)")
        super().__init__(in_features, hidden, y_dim)

    def forward(self, x):
        return torch.sigmoid(self.logits(x))


class Classifier2Classes(_ReluMLP):
    """relu MLP -> Linear(2 * y_dim) -> softmax over a 2-class axis.
    Returns shape (..., 2, y_dim)."""

    def __init__(self, in_features: int, hidden: Sequence[int], y_dim: int):
        super().__init__(in_features, hidden, 2 * y_dim)
        self.y_dim = y_dim

    def forward(self, x):
        logits = self.logits(x)
        return torch.softmax(logits.reshape(*logits.shape[:-1], 2, self.y_dim), dim=-2)
