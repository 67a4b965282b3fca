"""Semi-supervised variational inference objectives (port of
``dvae_tpu.models.variational``).

* :class:`DeterministicWarmup`: a linear ramp of the KL weight, rising or
  falling;
* :class:`ImportanceWeightedSampler`: mc x iw replication and the
  importance-weighted bound;
* :func:`labelled_loss` and :func:`svi_loss`: Kingma's M2 objective. A
  labelled batch costs ``-L(x, y) + alpha * BCE``; an unlabelled one
  enumerates the binary labels, weighs ``L(x, y)`` by ``q(y|x)`` and adds
  the entropy of ``q``.
"""

from __future__ import annotations

import math

import torch

from dvae_tpu_torch.models import losses


class DeterministicWarmup:
    """Linear ramp from ``t_init`` to ``t_max`` over ``n`` steps; iterate to
    get the next beta."""

    def __init__(self, n: int = 100, t_max: float = 1.0, t_init: float = 0.0):
        self.t = t_init
        self.t_max = t_max
        self.inc = (t_max - t_init) / n

    def __iter__(self):
        return self

    def __next__(self):
        # clamp toward t_max from the side the ramp approaches it from: min()
        # alone would drop a falling ramp to its end on the first step
        clamp = min if self.inc >= 0 else max
        self.t = clamp(self.t + self.inc, self.t_max)
        return self.t


class ImportanceWeightedSampler:
    """mc x iw replication and aggregation for importance-weighted bounds."""

    def __init__(self, mc: int = 1, iw: int = 1):
        self.mc = mc
        self.iw = iw

    def resample(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat(self.mc * self.iw, *([1] * (x.ndim - 1)))

    def __call__(self, elbo: torch.Tensor) -> torch.Tensor:
        """elbo: (mc * iw * B,) log-weights -> (B,) importance-weighted bound."""
        elbo = elbo.reshape(self.mc, self.iw, -1)
        elbo = losses.log_sum_exp(elbo.transpose(1, 2), axis=-1) - math.log(float(self.iw))
        return torch.mean(elbo, dim=0).reshape(-1)


def labelled_loss(x, r, mu, log_var, y, eps: float = 1e-8, beta: float = 1.0):
    """-log p(x|y,z) + beta * KL + log p(y) per sample (the L(x, y) bound).
    ``beta`` weighs the KL term only, as a warm-up does."""
    recon = losses.itakura_saito_divergence(r, x, eps)
    kl = losses.kl_gaussian_standard(mu, log_var)
    prior_y = losses.log_standard_categorical(y, eps)
    return recon + beta * kl + prior_y


def svi_loss(model, x, y, alpha: float = 0.1, beta: float = 1.0, eps: float = 1e-8,
             generator: torch.Generator | None = None, sample_eps=None):
    """The semi-supervised objective of a batch ``x`` with labels ``y``, or
    ``y=None`` for an unlabelled batch, whose binary labels are enumerated
    (0, then 1). The reparameterization noise is ``sample_eps`` when given
    (a tensor for a labelled batch, a pair for the two enumerated labels),
    else drawn from ``generator``. Returns (loss, metrics)."""
    if y is not None:
        r, mu, log_var = model(x, y, generator=generator, eps=sample_eps)
        L = labelled_loss(x, r, mu, log_var, y, eps, beta)
        ce = losses.binary_cross_entropy(model.classify(x), y, eps)
        loss = torch.mean(L) + alpha * ce
        return loss, {"L": torch.mean(L), "classification": ce}

    y_hat = model.classify(x)  # (B, 1) = q(y=1|x)
    noise = (None, None) if sample_eps is None else sample_eps
    Ls = []
    for label, e in zip((0.0, 1.0), noise):
        y_l = torch.full((x.shape[0], 1), label, dtype=x.dtype, device=x.device)
        r, mu, log_var = model(x, y_l, generator=generator, eps=e)
        Ls.append(labelled_loss(x, r, mu, log_var, y_l, eps, beta))
    L0, L1 = Ls
    q1 = y_hat[:, 0]
    expected = (1 - q1) * L0 + q1 * L1
    # clip inside the logs only: a saturated classifier would give 0 * log(0)
    qc = torch.clamp(q1, eps, 1.0 - max(eps, losses._SAT))
    H = -(q1 * torch.log(qc) + (1 - q1) * torch.log(1 - qc))
    U = torch.mean(expected - H)
    return U, {"U": U, "entropy": torch.mean(H)}
