"""Loss library (port of ``dvae_tpu.models.losses``): Itakura-Saito ELBO,
BCE family, semi-supervised L/U losses, mask regression losses, F1
statistics and log-density helpers.

Reductions follow the reference: sum over the feature axis, mean over the
batch.
"""

from __future__ import annotations

import math

import torch

# float32 cannot represent 1 - 1e-8 (the ulp at 1.0 is ~6e-8): a clip upper
# bound that rounds back to 1.0 would leave log(1 - r) = -inf, which
# 0-weighted loss terms then turn into 0 * inf = nan.
_SAT = 1.2e-7


def binary_cross_entropy(r, x, eps: float = 1e-8):
    """-mean_B sum_F [x log(r) + (1-x) log(1-r)], r clipped into
    [eps, 1 - max(eps, ulp)]."""
    r = torch.clamp(r, eps, 1.0 - max(eps, _SAT))
    return -torch.mean(torch.sum(x * torch.log(r) + (1 - x) * torch.log(1 - r), dim=-1))


def binary_cross_entropy_v2(r, eps: float = 1e-8):
    """Cross-entropy against a uniform 0.5 target."""
    r = torch.clamp(r, eps, 1.0 - max(eps, _SAT))
    return -torch.mean(torch.sum(0.5 * torch.log(r) + 0.5 * torch.log(1 - r), dim=-1))


def binary_cross_entropy_v3(r, eps: float = 1e-8):
    """Negative entropy of the prediction itself."""
    rc = torch.clamp(r, eps, 1.0 - max(eps, _SAT))
    return -torch.mean(torch.sum(r * torch.log(rc) + (1 - r) * torch.log(1 - rc), dim=-1))


def binary_cross_entropy_2classes(r1, r2, x, eps: float = 1e-8):
    """Two-head variant: r1 is p(y=1), r2 is p(y=0)."""
    r1 = torch.clamp(r1, eps, 1.0)
    r2 = torch.clamp(r2, eps, 1.0)
    return -torch.mean(torch.sum(x * torch.log(r1) + (1 - x) * torch.log(r2), dim=-1))


def itakura_saito_divergence(r, x, eps: float = 1e-8):
    """Per-sample IS divergence summed over frequency."""
    return torch.sum(x / r - torch.log(x + eps) + torch.log(r) - 1.0, dim=-1)


# reference spelling kept as an alias
ikatura_saito_divergence = itakura_saito_divergence


def kl_gaussian_standard(mu, log_var):
    """Per-sample KL(q(z|x) || N(0, I)) summed over latent dims."""
    return -0.5 * torch.sum(log_var - mu**2 - torch.exp(log_var), dim=-1)


def elbo(x, r, mu, log_var, eps: float = 1e-8):
    """(total, recon, KL), each the batch mean of per-frame sums: the
    (negative, minimized) training loss of every VAE family."""
    recon = torch.mean(itakura_saito_divergence(r, x, eps))
    kl = torch.mean(kl_gaussian_standard(mu, log_var))
    return recon + kl, recon, kl


def L_loss(x, r, mu, log_var, eps: float = 1e-8):
    """Per-frame labelled loss (no batch mean) -> (L, recon, KL)."""
    recon = itakura_saito_divergence(r, x, eps)
    kl = kl_gaussian_standard(mu, log_var)
    return recon + kl, recon, kl


def U_loss(x, r, mu, log_var, y_hat_soft, eps: float = 1e-8):
    """Unlabelled semi-supervised objective: the per-frame ELBO marginalized
    over the soft label posterior plus its entropy -> (U, L, recon, KL)
    batch means."""
    recon = itakura_saito_divergence(r, x, eps)
    kl = kl_gaussian_standard(mu, log_var)
    L = (recon + kl)[..., None]
    L_soft = torch.sum(y_hat_soft * L + (1 - y_hat_soft) * L, dim=-1)
    # clip inside the logs only: a saturated y_hat would give 0 * log(0)
    yc = torch.clamp(y_hat_soft, eps, 1.0 - max(eps, _SAT))
    H = -torch.sum(y_hat_soft * torch.log(yc) + (1 - y_hat_soft) * torch.log(1 - yc), dim=-1)
    U = torch.mean(L_soft + H)
    return U, torch.mean(L), torch.mean(recon), torch.mean(kl)


def mean_square_error_signal(x, y, y_hat):
    return torch.mean(torch.sum(torch.square((y - y_hat) * x), dim=-1))


def mean_square_error_mask(y, y_hat):
    return torch.mean(torch.sum(torch.square(y - y_hat), dim=-1))


def magnitude_spectrum_approximation_loss(x, s, y_hat):
    d = s - y_hat * x
    return torch.mean(torch.sum(torch.real(d * torch.conj(d)), dim=-1))


def f1_loss(y_hat_hard, y, eps: float = 1e-8, mask=None):
    """(accuracy, precision, recall, F1) of hard binary predictions.

    ``mask`` (same shape, optional) excludes positions from all four
    counts, so the padded frames of a sequence batch do not score as true
    negatives."""
    y_pred = y_hat_hard.reshape(-1)
    y_true = y.reshape(-1)
    m = torch.ones_like(y_true) if mask is None else mask.reshape(-1)
    tp = torch.sum(m * y_true * y_pred)
    tn = torch.sum(m * (1 - y_true) * (1 - y_pred))
    fp = torch.sum(m * (1 - y_true) * y_pred)
    fn = torch.sum(m * y_true * (1 - y_pred))
    return f1_from_counts(tp, tn, fp, fn, eps)


def f1_from_counts(tp, tn, fp, fn, eps: float = 1e-8):
    """(accuracy, precision, recall, F1) from the four counts, as
    :func:`f1_loss` computes them (counts summed over processes give the
    global batch's statistics)."""
    accuracy = (tp + tn) / (tp + tn + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return accuracy, precision, recall, f1


_LOG_2PI = math.log(2.0 * math.pi)


def log_standard_gaussian(x):
    """sum_F log N(x | 0, I)."""
    return torch.sum(-0.5 * _LOG_2PI - x**2 / 2.0, dim=-1)


def log_gaussian(x, mu, log_var):
    """sum_F log N(x | mu, exp(log_var))."""
    log_pdf = -0.5 * _LOG_2PI - log_var / 2.0 - (x - mu) ** 2 / (2.0 * torch.exp(log_var))
    return torch.sum(log_pdf, dim=-1)


def prior_categorical(batch_size: int, y_dim: int):
    """Uniform categorical prior."""
    return torch.full((batch_size, y_dim), 1.0 / y_dim)


def log_standard_categorical(p, eps: float = 1e-8):
    """Binary cross-entropy of p against a fixed 0.5 prior."""
    prior = 0.5
    return -torch.sum(p * math.log(prior + eps) + (1 - p) * math.log(1 - prior + eps), dim=-1)


def log_sum_exp(x, axis: int = -1):
    """Numerically stable log-sum-exp with the reference's +1e-8 guard."""
    m = torch.amax(x, dim=axis, keepdim=True)
    return torch.log(torch.sum(torch.exp(x - m), dim=axis, keepdim=True) + 1e-8) + m


def onehot(label: int, k: int):
    """1-of-k encoding."""
    return (torch.arange(k) == label).to(torch.float32)


def enumerate_discrete(batch_size: int, y_dim: int):
    """All one-hot labels tiled over a batch -> (y_dim * batch, y_dim)."""
    eye = torch.eye(y_dim, dtype=torch.float32)
    return torch.repeat_interleave(eye, batch_size, dim=0)
