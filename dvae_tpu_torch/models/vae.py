"""M1: plain VAE over power-spectrogram frames (port of
``dvae_tpu.models.vae``). The decoder's hidden widths are the encoder's in
reverse order."""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from dvae_tpu_torch.models.blocks import Decoder, Encoder, init_xavier_


class VAE(nn.Module):
    def __init__(self, x_dim: int = 513, z_dim: int = 16, h_dim: Sequence[int] = (128, 128)):
        super().__init__()
        self.x_dim, self.z_dim, self.h_dim = x_dim, z_dim, tuple(h_dim)
        self.encoder = Encoder(x_dim, self.h_dim, z_dim)
        self.decoder = Decoder(z_dim, tuple(reversed(self.h_dim)), x_dim)
        init_xavier_(self)

    def forward(self, x, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        z, mu, log_var = self.encoder(x, sample=sample, generator=generator, eps=eps)
        return self.decoder(z), mu, log_var

    def encode(self, x, sample: bool = True, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        return self.encoder(x, sample=sample, generator=generator, eps=eps)

    def decode(self, z):
        return self.decoder(z)
