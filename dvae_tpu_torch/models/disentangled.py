"""M2-info: the disentangled conditional VAE (port of
``dvae_tpu.models.disentangled``).

A :class:`~dvae_tpu_torch.models.cvae.CVAE_v3` (encoder, label-conditioned
decoder, x -> y classifier) under ``enc_dec_clf``, plus a z -> y
``auxiliary`` classifier, trained adversarially against the encoder. The
``state_dict`` names are ``enc_dec_clf.*`` and ``auxiliary.*``, the
reference's ``DeepGenerativeModel_v5``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from dvae_tpu_torch.models.blocks import Classifier, init_xavier_
from dvae_tpu_torch.models.cvae import CVAE_v3


class DisentangledVAE(nn.Module):
    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__()
        self.x_dim, self.y_dim, self.z_dim, self.h_dim = x_dim, y_dim, z_dim, tuple(h_dim)
        self.enc_dec_clf = CVAE_v3(x_dim, y_dim, z_dim, self.h_dim)
        self.auxiliary = init_xavier_(Classifier(z_dim, self.h_dim, y_dim))

    def forward(self, x, y, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        z, mu, log_var = self.encode(x, sample, generator, eps)
        return self.decode(torch.cat([z, y], -1)), z, mu, log_var

    def encode(self, x, sample: bool = True, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        return self.enc_dec_clf.encode(x, sample, generator, eps)

    def decode(self, zy):
        return self.enc_dec_clf.decode(zy)

    def classify_from_x(self, x):
        return self.enc_dec_clf.classify(x)

    def classify_from_z(self, z):
        return self.auxiliary(z)
