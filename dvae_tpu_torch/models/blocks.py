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


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the last axis, in plain PyTorch.

    ``train=True`` normalizes with the batch's statistics over every axis
    but the last (mean, and the biased variance as ``E[x^2] - E[x]^2``
    floored at 0) and moves the running statistics toward them with
    momentum 0.99; ``train=False`` normalizes with the running statistics.
    Unlike ``torch.nn.BatchNorm1d``: the momentum weighs the old average,
    the running variance takes the biased batch variance, and a (B, T, H)
    input needs no transpose. Names follow torch's: ``weight`` (Flax's
    ``scale``), ``bias``, ``running_mean``, ``running_var``."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


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

    ``batch_norm=True`` makes each block ``relu(BN(relu(W x)))``, with the
    :class:`BatchNorm` ``bn.{i}`` beside ``hidden.{i}``, as the JAX
    package's ``Classifier`` (and the reference's interleaved
    ``[Linear, BatchNorm1d]`` list) computes it. ``train`` is Flax's flag:
    batch statistics (and updated running statistics) when True, running
    statistics when False; ``nn.Module.training`` is not read."""

    def __init__(self, in_features: int, hidden: Sequence[int], y_dim: int,
                 batch_norm: bool = False):
        super().__init__(in_features, hidden, y_dim)
        self.bn = nn.ModuleList(BatchNorm(h) for h in hidden) if batch_norm else None

    def forward(self, x, train: bool = False):
        if self.bn is None:
            return torch.sigmoid(self.logits(x))
        for layer, bn in zip(self.hidden, self.bn):
            x = torch.relu(bn(torch.relu(layer(x)), train))
        return torch.sigmoid(self.output_layer(x))


class Classifier2Classes(_ReluMLP):
    """relu MLP -> Linear(2 * y_dim) -> softmax over a 2-class axis.
    Returns shape (..., 2, y_dim)."""

    def __init__(self, in_features: int, hidden: Sequence[int], y_dim: int):
        super().__init__(in_features, hidden, 2 * y_dim)
        self.y_dim = y_dim

    def forward(self, x):
        logits = self.logits(x)
        return torch.softmax(logits.reshape(*logits.shape[:-1], 2, self.y_dim), dim=-2)
