"""Batched Monte-Carlo EM speech enhancement (port of the kernel path of
``dvae_tpu.enhance.mcem.run_mcem``).

Per EM iteration: one E-step chain segment (burn-in + samples) through
:func:`~dvae_tpu_torch.enhance.mh_chain.run_mh_chain` over the flattened
(B*N) frame rows, then the masked NMF M-step, then the masked cost. At the
end, one WF-mode chain segment gives the Monte-Carlo Wiener masks.

Randomness comes from three ``torch.Generator`` streams derived from one
integer seed, as the JAX package splits its key three ways: NMF init, EM
iterations, WF expectation. So runs sharing a seed share their NMF init.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch.enhance.mh_chain import fold_conditioning, make_chain_noise, run_mh_chain
from dvae_tpu_torch.enhance.nmf import VX_FLOOR, compute_vb, init_nmf, nmf_m_step


@dataclasses.dataclass(frozen=True)
class McemConfig:
    """Budgets mirror the reference's nominal defaults (E-step 10 samples +
    30 burn-in, WF 25 + 75).

    Reference quirk (M1 only): the reference's M1 passes its budgets into
    the wrong argument slots, so it effectively runs E-step 30/30 and WF
    75/30; :meth:`m1_reference_effective` builds that budget set.

    ``fast_decoder`` selects the chain decoder's precision, on the kernel
    and on the plain path alike: True (the default) rounds both operands of
    its three products to bf16 and sums in f32, as the JAX package's
    ``make_mlp_decoder(fast=True)`` does (the kernel's tensor-core body);
    False keeps them f32. The sample planes stay f32 either way:
    ``fast_stats`` is carried so a config means the same in both packages,
    and is ignored here.
    """

    niter: int = 100
    nsamples_e_step: int = 10
    burnin_e_step: int = 30
    nsamples_wf: int = 25
    burnin_wf: int = 75
    var_rw: float = 0.01
    nmf_rank: int = 10
    eps: float = 1e-8
    fast_decoder: bool = True
    fast_stats: bool = True
    peem_steps: int = 4
    peem_lr: float = 1e-2
    pmcem_chains: int = 10
    pmcem_steps: int = 4
    pmcem_wf_burn: int = 8

    @classmethod
    def m1_reference_effective(cls, niter: int = 100, **kw) -> "McemConfig":
        """Budgets the reference's M1 actually runs: E-step 30/30, WF 75/30."""
        return cls(niter=niter, nsamples_e_step=30, burnin_e_step=30,
                   nsamples_wf=75, burnin_wf=30, **kw)


class McemResult(NamedTuple):
    wfs: torch.Tensor   # (B, N, F) speech Wiener mask  E[g*Vs / Vx]
    wfn: torch.Tensor   # (B, N, F) noise  Wiener mask  E[Vb / Vx]
    cost: torch.Tensor  # (niter,) masked E[-log lik] trajectory
    z: torch.Tensor     # (B, N, L) last latent draw
    w: torch.Tensor     # (B, F, K) NMF dictionary
    h: torch.Tensor     # (B, N, K) NMF activations
    g: torch.Tensor     # (B, N) gains


def fold_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived deterministically from ``seed`` and ``path``
    (the counterpart of ``jax.random.fold_in``)."""
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_generators(seed: int, device) -> tuple[torch.Generator, ...]:
    """The three streams of one MCEM run: NMF init, EM, WF."""
    return tuple(torch.Generator(device=device).manual_seed(fold_seed(seed, i))
                 for i in range(3))


def run_mcem(mats, x2: torch.Tensor, z_init: torch.Tensor, mask: torch.Tensor,
             seed: int = 0, cfg: McemConfig = McemConfig(), y=None,
             nmf_init=None) -> McemResult:
    """Run MCEM over a padded utterance batch.

    Args:
        mats: decoder weights (``mh_chain.extract_decoder_mlp``).
        x2: (B, N, F) mixture power spectrogram.
        z_init: (B, N, L) initial latents (the encoder posterior mean).
        mask: (B, N) 1.0 for valid frames.
        seed: integer seed of the three random streams.
        y: optional (B, N, Y) conditioning labels, folded into the
            decoder's first-layer row bias once for the run.
        nmf_init: optional (W, H, g) replacing the random NMF init.
    The device is that of ``x2``: CUDA runs the chain kernel, CPU the plain
    chain.
    """
    if mats is None:
        raise NotImplementedError(
            "run_mcem needs a two-hidden-layer MLP decoder; other decoders "
            "need the tensor engine of a later PR (ROADMAP queue A10)")
    b, n, f = x2.shape
    l = z_init.shape[-1]
    dev = x2.device
    x2 = x2.to(torch.float32).contiguous()
    mask = mask.to(torch.float32)
    g_nmf, g_em, g_wf = make_generators(seed, dev)
    if nmf_init is None:
        w, h, g = init_nmf(g_nmf, b, n, f, cfg.nmf_rank, cfg.eps, device=dev)
    else:
        w, h, g = (t.to(dev, torch.float32) for t in nmf_init)
    x2_r = x2.reshape(b * n, f)
    mats = fold_conditioning(mats, None if y is None else y.reshape(b * n, -1),
                             cfg.fast_decoder)
    denom = torch.clamp(mask.sum() * f, min=1.0)

    def chain(z, w, h, g, gen, wf_mode):
        n_burn = cfg.burnin_wf if wf_mode else cfg.burnin_e_step
        n_samp = cfg.nsamples_wf if wf_mode else cfg.nsamples_e_step
        vb = compute_vb(w, h)
        noise = make_chain_noise(n_burn + n_samp, b * n, l, gen, dev)
        return run_mh_chain(
            mats, x2_r, vb.reshape(b * n, f).contiguous(),
            g.reshape(b * n).contiguous(), z.reshape(b * n, l).contiguous(),
            None, noise, n_burn, n_samp, cfg.var_rw, wf_mode=wf_mode,
            fast_decoder=cfg.fast_decoder)

    z = z_init.to(torch.float32)
    costs = []
    for _ in range(cfg.niter):
        zf, vs_samples = chain(z, w, h, g, g_em, False)
        z = zf.reshape(b, n, l)
        vs_samples = vs_samples.reshape(cfg.nsamples_e_step, b, n, f)
        w, h, g, vb = nmf_m_step(x2, vs_samples, w, h, g, mask, cfg.eps)
        vx = (g[None, :, :, None] * vs_samples + vb[None]).clamp_min(VX_FLOOR)
        per = torch.log(vx) + x2[None] / vx
        costs.append((per.mean(0) * mask[:, :, None]).sum() / denom)

    zf, wfs_sum, wfn_sum = chain(z, w, h, g, g_wf, True)
    m3 = mask[:, :, None]
    wfs = wfs_sum.reshape(b, n, f) / cfg.nsamples_wf * m3
    wfn = wfn_sum.reshape(b, n, f) / cfg.nsamples_wf * m3
    cost = torch.stack(costs) if costs else x2.new_zeros((0,))
    return McemResult(wfs, wfn, cost, zf.reshape(b, n, l), w, h, g)
