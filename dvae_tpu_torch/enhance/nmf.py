"""Masked multiplicative NMF updates for the MCEM noise model (port of
``dvae_tpu.enhance.nmf``).

Layouts are frames-major: X2 (B, N, F); W (B, F, K); H (B, N, K); g (B, N);
per-latent-sample speech variances Vs (R, B, N, F). The frame mask (B, N)
excludes padded frames from every reduction over N.

Update order: W (with Vx refresh), H (with Vx refresh), joint W/H column
renormalization with an eps-floored norm, then the gain g.
"""

from __future__ import annotations

import torch

# Absolute floor on the mixture variance Vx = g*Vs + Vb: guards digitally
# silent frames, where multiplicative updates drive g and H to exactly 0.
VX_FLOOR = 1e-10


def init_nmf(generator: torch.Generator, batch: int, n_frames: int, n_freq: int,
             rank: int, eps: float, device=None):
    """Random-uniform W/H (floored at eps) and unit gains."""
    w = torch.rand((batch, n_freq, rank), generator=generator, device=device).clamp_min(eps)
    h = torch.rand((batch, n_frames, rank), generator=generator, device=device).clamp_min(eps)
    g = torch.ones((batch, n_frames), device=device)
    return w, h, g


def compute_vb(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Noise variance Vb = W @ H in frames-major layout -> (B, N, F)."""
    return torch.einsum("bnk,bfk->bnf", h, w)


def nmf_m_step(x2, vs, w, h, g, mask, eps: float = 1e-8):
    """One multiplicative M-step given latent-sample speech variances.

    Args:
        x2: (B, N, F) mixture power; vs: (R, B, N, F) speech variances,
            float32, or bfloat16 when the engine runs ``fast_stats``.
        w, h, g: current NMF parameters and gains; mask: (B, N) float.
    Returns:
        updated ``(w, h, g, vb)``, with ``vb = W @ H`` the final noise
        variance (g does not enter it).

    The arithmetic is f32 whatever ``vs``'s dtype: each expression that
    reads ``vs`` promotes it element by element, so no f32 copy of the
    samples is made. The R-sums ``a1``, ``a2`` are rounded to ``vs``'s
    dtype, as the JAX package stores them.
    """
    m = mask[:, :, None]
    ad = vs.dtype

    def vx(vb):
        return (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)

    def r_sums(r1):
        """The paired reductions over R, at ``vs``'s dtype."""
        return r1.sum(0).to(ad), (r1 * r1).sum(0).to(ad)

    vb = compute_vb(w, h)
    # W: reduces over frames, so masked
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bnk->bfk", x2 * a2 * m, h)
    den = torch.einsum("bnf,bnk->bfk", a1 * m, h)
    w = w * torch.sqrt(num / den.clamp_min(eps))

    vb = compute_vb(w, h)
    # H: per frame, padded rows are harmless
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bfk->bnk", x2 * a2, w)
    den = torch.einsum("bnf,bfk->bnk", a1.float(), w)
    h = h * torch.sqrt(num / den.clamp_min(eps))

    # renormalize W's columns into H (W @ H unchanged); the norm is floored
    # at eps so a silent utterance (W's columns collapse to 0) stays finite
    norm = w.abs().sum(1).clamp_min(eps)  # (B, K)
    w = w / norm[:, None, :]
    h = h * norm[:, None, :]

    vb = compute_vb(w, h)
    r1 = 1.0 / vx(vb)
    # g: reduces over samples and frequency
    num = (x2[None] * vs * (r1 * r1)).sum((0, 3))
    den = (vs * r1).sum((0, 3))
    g = g * torch.sqrt(num / den.clamp_min(eps))
    return w, h, g, vb
