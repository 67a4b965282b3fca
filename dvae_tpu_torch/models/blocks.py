"""Building blocks of the VAE family as ``nn.Module``s (port of
``dvae_tpu.models.blocks``).

Parameter names are the reference's ``state_dict`` names: hidden layers sit
in a ``ModuleList`` (``hidden.0``, ``hidden.1``, ...), the Gaussian heads are
``sample.mu`` / ``sample.log_var`` and the decoder output is
``reconstruction``. Hidden MLPs use tanh; the decoder ends in ``exp`` (a
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
