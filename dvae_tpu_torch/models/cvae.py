"""M2: the conditional-VAE family (port of ``dvae_tpu.models.cvae``).

* :class:`CVAE`     encoder([x; y]), decoder([z; y])
* :class:`CVAE_v2`  encoder(x),      decoder([z; y])
* :class:`CVAE_v3`  v2 + an x -> y classifier
* :class:`CVAE_v4`  v3 + a z -> y auxiliary classifier
* :class:`EncoderClassifier`  encoder + x -> y classifier, no decoder

Every model keeps the JAX package's methods (``encode``, ``decode``,
``classify`` / ``classify_from_x`` / ``classify_from_z``) and its
``forward`` returns. The decoder's hidden widths are the encoder's in
reverse order. ``encode`` draws its sample from ``generator`` unless
``eps`` is given, as :class:`~dvae_tpu_torch.models.VAE` does.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from dvae_tpu_torch.models.blocks import Classifier, Decoder, Encoder, init_xavier_


class _Conditional(nn.Module):
    """Encoder over ``x_dim + enc_y`` inputs and a ``[z; y]`` decoder."""

    def __init__(self, x_dim: int, y_dim: int, z_dim: int, h_dim: Sequence[int],
                 enc_y: int):
        super().__init__()
        self.x_dim, self.y_dim, self.z_dim, self.h_dim = x_dim, y_dim, z_dim, tuple(h_dim)
        self.encoder = Encoder(x_dim + enc_y, self.h_dim, z_dim)
        self.decoder = Decoder(z_dim + y_dim, tuple(reversed(self.h_dim)), x_dim)

    def encode(self, x, sample: bool = True, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        return self.encoder(x, sample=sample, generator=generator, eps=eps)

    def decode(self, zy):
        return self.decoder(zy)


class CVAE(_Conditional):
    """M2: encoder and decoder both conditioned on the label y. ``encode``
    takes the concatenated ``[x; y]``."""

    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__(x_dim, y_dim, z_dim, h_dim, enc_y=y_dim)
        init_xavier_(self)

    def forward(self, x, y, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        z, mu, log_var = self.encode(torch.cat([x, y], -1), sample, generator, eps)
        return self.decode(torch.cat([z, y], -1)), mu, log_var


class CVAE_v2(_Conditional):
    """Label-free encoder, label-conditioned decoder."""

    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__(x_dim, y_dim, z_dim, h_dim, enc_y=0)
        init_xavier_(self)

    def forward(self, x, y, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        z, mu, log_var = self.encode(x, sample, generator, eps)
        return self.decode(torch.cat([z, y], -1)), mu, log_var


class CVAE_v3(CVAE_v2):
    """v2 + an x -> y classifier (self-soft labels)."""

    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__(x_dim, y_dim, z_dim, h_dim)
        self.classifier = init_xavier_(Classifier(x_dim, self.h_dim, y_dim))

    def classify(self, x):
        return self.classifier(x)


class CVAE_v4(CVAE_v2):
    """v3 + a z -> y auxiliary classifier; ``forward`` also returns the
    sampled z."""

    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__(x_dim, y_dim, z_dim, h_dim)
        self.classifier = init_xavier_(Classifier(x_dim, self.h_dim, y_dim))
        self.auxiliary = init_xavier_(Classifier(z_dim, self.h_dim, y_dim))

    def forward(self, x, y, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        z, mu, log_var = self.encode(x, sample, generator, eps)
        return self.decode(torch.cat([z, y], -1)), z, mu, log_var

    def classify_from_x(self, x):
        return self.classifier(x)

    def classify_from_z(self, z):
        return self.auxiliary(z)


class EncoderClassifier(nn.Module):
    """Encoder + x -> y classifier, no decoder. ``forward`` is the
    encoder's (z, mu, log_var)."""

    def __init__(self, x_dim: int = 513, y_dim: int = 1, z_dim: int = 16,
                 h_dim: Sequence[int] = (128, 128)):
        super().__init__()
        self.x_dim, self.y_dim, self.z_dim, self.h_dim = x_dim, y_dim, z_dim, tuple(h_dim)
        self.encoder = Encoder(x_dim, self.h_dim, z_dim)
        self.classifier = Classifier(x_dim, self.h_dim, y_dim)
        init_xavier_(self)

    def forward(self, x, sample: bool = True, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        return self.encoder(x, sample=sample, generator=generator, eps=eps)

    def classify(self, x):
        return self.classifier(x)
