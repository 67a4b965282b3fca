"""Batched EM speech enhancement: the E-step engines of
``dvae_tpu.enhance.mcem`` (port).

* :func:`run_mcem`, Monte-Carlo EM: per EM iteration one E-step chain
  segment (burn-in + samples) through
  :func:`~dvae_tpu_torch.enhance.mh_chain.run_mh_chain` over the flattened
  (B*N) frame rows, then the masked NMF M-step and the masked cost; at the
  end one WF-mode segment gives the Monte-Carlo Wiener masks
  (:func:`_wf_expectation`).
* :func:`run_pmcem`, parallel-chain MCEM: R chains advanced together as
  the R*B*N rows of one chain segment per EM iteration.
* :func:`run_peem`, point-estimate EM: Adam steps on the latent per EM
  iteration instead of a chain; deterministic, no chain launch.
* :func:`run_peem_wf`: PEEM's EM loop, then run_mcem's Wiener tail from
  PEEM's latent.
* :func:`run_em_fixed_z`: EM with the latent pinned (the reference's
  ``clean_z_nomcem`` ablation); deterministic, no chain launch.

Every engine takes the same arguments and starts from the same preamble
(:func:`_prep_em`). Randomness comes from three ``torch.Generator`` streams
derived from one integer seed, as the JAX package splits its key three
ways: NMF init, EM iterations, WF expectation. So runs sharing a seed share
their NMF init, whatever their engine. The device is that of ``x2``: on
CUDA every MH step runs in the chain kernel, on the CPU in the plain chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch import tracing
from dvae_tpu_torch.enhance.mh_chain import (
    decoder_reference,
    fold_conditioning,
    make_chain_noise,
    run_mh_chain,
)
from dvae_tpu_torch.enhance.nmf import VX_FLOOR, compute_vb, init_nmf, nmf_m_step


@dataclasses.dataclass(frozen=True)
class McemConfig:
    """Budgets mirror the reference's nominal defaults (E-step 10 samples +
    30 burn-in, WF 25 + 75).

    Reference quirk (M1 only): the reference's M1 passes its budgets into
    the wrong argument slots, so it effectively runs E-step 30/30 and WF
    75/30; :meth:`m1_reference_effective` builds that budget set.

    ``fast_decoder`` selects the decoder's precision, in the chain kernel,
    the plain chain and PEEM's gradient alike: True (the default) rounds
    both operands of its products to bf16 and sums in f32, as the JAX
    package's ``make_mlp_decoder(fast=True)`` does (the kernel's
    tensor-core body); False keeps them f32. It holds for decoders of two
    hidden layers only: at any other depth the engines run in f32 whatever
    it says, as the JAX package does (it swaps in its bf16 decoder only
    where ``extract_decoder_mlp`` found two hidden layers).

    ``fast_stats`` (default True) keeps the chain's planes in bf16, as the
    JAX package's scan engine does, with all arithmetic in f32: the chain's
    energy reads |X|^2 rounded to bf16 once per run and Vb rounded once per
    EM iteration; the E-step emits its Vs samples as bf16; the M-step reads
    them and stores its R-sums at their dtype; the cost is taken on them.
    The Wiener masks sum over the f32 Vb and the chain's f32 Vs, so WFs +
    WFn = 1 stays exact. It acts on run_mcem, run_pmcem and run_peem_wf's
    Wiener tail; run_peem and run_em_fixed_z run no chain and ignore it, as
    in JAX. False is all f32.

    ``peem_steps`` / ``peem_lr``: Adam steps on the latent per EM iteration
    and their learning rate (run_peem, run_peem_wf). ``pmcem_chains`` /
    ``pmcem_steps`` / ``pmcem_wf_burn``: run_pmcem's R chains, MH steps per
    EM iteration, and its Wiener tail's burn-in.
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
    z: torch.Tensor     # (B, N, L) last latent (draw or point estimate)
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


def draw_nmf_init(seed: int, b: int, n: int, f: int, cfg: McemConfig, device):
    """The NMF init (W, H, g) that a run with ``seed`` draws for a (b, n,
    f) batch, from the first of its three streams."""
    return init_nmf(make_generators(seed, device)[0], b, n, f, cfg.nmf_rank, cfg.eps,
                    device=device)


def _prep_em(mats, x2, mask, cfg: McemConfig, y, seed: int, nmf_init):
    """The preamble every engine shares: the precision rule of
    :class:`McemConfig` (``cfg.fast_decoder`` cleared unless the decoder
    has two hidden layers); f32 inputs; the three streams of ``seed``, with
    the NMF init drawn from the first; the labels ``y`` folded into the
    decoder's first-layer row bias once for the run, at that precision.
    Returns ``(x2, mask, (w, h, g), folded mats, (em stream, wf stream),
    cfg)``."""
    if mats is None:
        raise ValueError("the engines need a model with a decoder")
    if cfg.fast_decoder and len(mats.widths) != 2:
        cfg = dataclasses.replace(cfg, fast_decoder=False)
    b, n, f = x2.shape
    dev = x2.device
    x2 = x2.to(torch.float32).contiguous()
    mask = mask.to(torch.float32)
    _, g_em, g_wf = make_generators(seed, dev)
    if nmf_init is None:
        nmf_init = draw_nmf_init(seed, b, n, f, cfg, dev)
    else:
        nmf_init = tuple(t.to(dev, torch.float32) for t in nmf_init)
    mats = fold_conditioning(mats, None if y is None else y.reshape(b * n, -1),
                             cfg.fast_decoder)
    return x2, mask, nmf_init, mats, (g_em, g_wf), cfg


def _stats(t: torch.Tensor, cfg: McemConfig) -> torch.Tensor:
    """``t`` as the chain stores its planes: rounded to bf16 under
    ``cfg.fast_stats``, else as it is (f32)."""
    return t.to(torch.bfloat16) if cfg.fast_stats else t


def _segment(mats, x2_r, vb, g, z, gen, n_burn: int, n_samples: int, cfg: McemConfig,
             wf_mode: bool):
    """One chain segment over the rows of the (rows, F) plane ``x2_r``;
    ``vb``, ``g`` and ``z`` are flattened to those rows, and the segment's
    noise is drawn from ``gen``. The planes come at the chain's dtypes
    (``mh_chain.plane_dtypes``): ``x2_r`` and an E-step's ``vb`` through
    :func:`_stats`, a WF segment's ``vb`` in f32."""
    rows, f = x2_r.shape
    l = z.shape[-1]
    noise = make_chain_noise(n_burn + n_samples, rows, l, gen, x2_r.device)
    return run_mh_chain(
        mats, x2_r, vb.reshape(rows, f).contiguous(), g.reshape(rows).contiguous(),
        z.reshape(rows, l).contiguous(), None, noise, n_burn, n_samples, cfg.var_rw,
        wf_mode=wf_mode, fast_decoder=cfg.fast_decoder, fast_stats=cfg.fast_stats)


def _masked_cost(x2, vs, vb, g, mask):
    """E[-log lik] over the valid cells: the mean over the samples ``vs``
    (R, B, N, F; f32, or bf16 under ``fast_stats``, read in f32), summed
    over valid frames and bins, over their count."""
    vx = (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)
    per = torch.log(vx) + x2[None] / vx
    return (per.mean(0) * mask[:, :, None]).sum() / torch.clamp(mask.sum() * x2.shape[-1],
                                                                min=1.0)


def _stack(costs, like):
    return torch.stack(costs) if costs else like.new_zeros((0,))


def _wf_expectation(mats, x2_r, mask, z, w, h, g, gen, cfg: McemConfig):
    """The Monte-Carlo Wiener masks (run_mcem's tail, shared with
    run_peem_wf): one WF-mode segment from ``z`` on the (B*N, F) plane
    ``x2_r`` (at the chain's dtype), ``burnin_wf`` steps, then the masks
    summed over ``nsamples_wf`` draws, averaged and masked. The same f32 Vb
    is in numerator and denominator, so WFs + WFn = 1 on valid frames.
    Returns ``(wfs, wfn, z)``."""
    (b, n), f = mask.shape, x2_r.shape[-1]
    with tracing.span("mcem.wiener"):
        zf, wfs, wfn = _segment(mats, x2_r, compute_vb(w, h), g, z, gen,
                                cfg.burnin_wf, cfg.nsamples_wf, cfg, True)
        m3 = mask[:, :, None]
        return (wfs.reshape(b, n, f) / cfg.nsamples_wf * m3,
                wfn.reshape(b, n, f) / cfg.nsamples_wf * m3, zf.reshape(b, n, -1))


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
    The other engines take the same arguments.
    """
    x2, mask, (w, h, g), mats, (g_em, g_wf), cfg = _prep_em(mats, x2, mask, cfg, y, seed,
                                                             nmf_init)
    b, n, f = x2.shape
    x2_r = _stats(x2.reshape(b * n, f), cfg)  # the chain's plane, rounded once per run
    z = z_init.to(torch.float32)
    costs = []
    for it in range(cfg.niter):
        with tracing.span("mcem.estep", it=it):
            zf, vs = _segment(mats, x2_r, _stats(compute_vb(w, h), cfg), g, z, g_em,
                              cfg.burnin_e_step, cfg.nsamples_e_step, cfg, False)
            z = zf.reshape(b, n, -1)
            vs = vs.reshape(cfg.nsamples_e_step, b, n, f)
        with tracing.span("mcem.mstep", it=it):
            w, h, g, vb = nmf_m_step(x2, vs, w, h, g, mask, cfg.eps)
        with tracing.span("mcem.cost", it=it):
            costs.append(_masked_cost(x2, vs, vb, g, mask))
    wfs, wfn, z = _wf_expectation(mats, x2_r, mask, z, w, h, g, g_wf, cfg)
    return McemResult(wfs, wfn, _stack(costs, x2), z, w, h, g)


def run_pmcem(mats, x2: torch.Tensor, z_init: torch.Tensor, mask: torch.Tensor,
              seed: int = 0, cfg: McemConfig = McemConfig(), y=None,
              nmf_init=None) -> McemResult:
    """Parallel-chain MCEM: ``cfg.pmcem_chains`` (R) chains carried across
    EM iterations and advanced together.

    The chains are the R*B*N rows of one chain segment, chain-major (row
    ``r * B*N + bn``), so one reshape gives (R, B, N, ...). Chain 0 starts
    at ``z_init``, the others at ``z_init`` perturbed by ``sqrt(var_rw)``
    (a draw from the EM stream, before its first segment). Per EM
    iteration one E-step segment of ``pmcem_steps - 1`` burn-in steps and
    one sample: that sample of every chain is the M-step's R-sample set,
    and the cost is averaged over R. The Wiener tail is one WF segment of
    ``pmcem_wf_burn`` burn-in steps and ``ceil(nsamples_wf / R)`` samples
    over all chains, averaged over every (sample, chain). Returns chain 0's
    latent.

    The chain kernel reads x2, Vb, g and a row bias per row, so each chain
    gets its own copy of them: x2 once per run, Vb and g once per EM
    iteration, the folded labels' row bias once per run (folded once, then
    repeated). Under ``fast_stats`` x2 and the E-step's Vb are rounded
    before they are repeated, so the R copies are bf16.
    """
    x2, mask, (w, h, g), mats, (g_em, g_wf), cfg = _prep_em(mats, x2, mask, cfg, y, seed,
                                                             nmf_init)
    b, n, f = x2.shape
    r, bn, l = cfg.pmcem_chains, b * n, z_init.shape[-1]
    x2_r = _stats(x2.reshape(bn, f), cfg).repeat(r, 1)
    if mats.b1.dim() == 2:  # the labels' row bias (B*N, H1), or (B*N, F) at depth 0
        mats = mats._replace(b1=mats.b1.repeat(r, 1))

    def planes(w, h, g, wf_mode=False):
        vb = compute_vb(w, h).reshape(bn, f)
        return (vb if wf_mode else _stats(vb, cfg)).repeat(r, 1), g.reshape(bn).repeat(r)

    eps = torch.randn((r, b, n, l), generator=g_em, device=x2.device)
    eps[0] = 0.0
    z = z_init.to(torch.float32)[None] + math.sqrt(cfg.var_rw) * eps
    costs = []
    for it in range(cfg.niter):
        with tracing.span("mcem.estep", it=it):
            z, vs = _segment(mats, x2_r, *planes(w, h, g), z, g_em, cfg.pmcem_steps - 1, 1,
                             cfg, False)
            vs = vs.reshape(r, b, n, f)
        with tracing.span("mcem.mstep", it=it):
            w, h, g, vb = nmf_m_step(x2, vs, w, h, g, mask, cfg.eps)
        with tracing.span("mcem.cost", it=it):
            costs.append(_masked_cost(x2, vs, vb, g, mask))

    n_collect = -(-cfg.nsamples_wf // r)
    with tracing.span("mcem.wiener"):
        z, wfs, wfn = _segment(mats, x2_r, *planes(w, h, g, True), z, g_wf, cfg.pmcem_wf_burn,
                               n_collect, cfg, True)
    n_avg, m3 = n_collect * r, mask[:, :, None]
    return McemResult(wfs.reshape(r, b, n, f).sum(0) / n_avg * m3,
                      wfn.reshape(r, b, n, f).sum(0) / n_avg * m3,
                      _stack(costs, x2), z.reshape(r, b, n, l)[0], w, h, g)


def run_peem(mats, x2: torch.Tensor, z_init: torch.Tensor, mask: torch.Tensor,
             seed: int = 0, cfg: McemConfig = McemConfig(), y=None,
             nmf_init=None) -> McemResult:
    """Point-estimate EM: the E-step's expectation over p(z|x) replaced by
    its MAP point estimate, reached by ``cfg.peem_steps`` Adam steps per EM
    iteration on the energy the chain targets,

        E(z) = sum_f [log Vx + |X|^2/Vx] + 0.5*||z||^2,   Vx = g*Vs(z) + Vb,

    warm-started from the last iteration's estimate, with the Adam moments
    carried across EM iterations and bias-corrected by the global step.
    Then the M-step and the cost on ``Vs(z)``, and Wiener masks evaluated at
    the final estimate. Deterministic; runs no chain.

    The gradient is autograd's through :func:`decoder_reference`, whose
    bf16 casts (``fast_decoder``) round the cotangents to bf16 where the
    transpose of the JAX package's casts rounds them. ``Enhancer._core``
    runs under inference mode, where no gradient can be taken and inference
    tensors cannot be saved for backward, so the loop leaves it and works
    on copies of its inputs. With ``peem_steps=0`` the latent stays at
    ``z_init`` and this is :func:`run_em_fixed_z`.
    """
    x2, mask, (w, h, g), mats, _, cfg = _prep_em(mats, x2, mask, cfg, y, seed, nmf_init)
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    with torch.inference_mode(False), torch.enable_grad():
        x2, mask, w, h, g, z = (t.clone() for t in (x2, mask, w, h, g,
                                                     z_init.to(torch.float32)))
        mats = mats.map(torch.clone)
        by = mats.b1 if mats.b1.dim() == 1 else mats.b1.reshape(*z.shape[:2], -1)
        dec = decoder_reference(mats, by, cfg.fast_decoder)

        def energy_grad(z, vb, g):
            zg = z.detach().requires_grad_(True)
            vx = (g[:, :, None] * dec(zg) + vb).clamp_min(VX_FLOOR)
            e = (torch.log(vx) + x2 / vx).sum() + 0.5 * (zg * zg).sum()
            return torch.autograd.grad(e, zg)[0]

        m, v, t = torch.zeros_like(z), torch.zeros_like(z), 0
        vs = dec(z)
        costs = []
        for _ in range(cfg.niter):
            if cfg.peem_steps:
                vb = compute_vb(w, h)
                for _ in range(cfg.peem_steps):
                    gz = energy_grad(z, vb, g)
                    t += 1
                    m = b1 * m + (1.0 - b1) * gz
                    v = b2 * v + (1.0 - b2) * gz * gz
                    m_hat = m / (1.0 - b1 ** t)
                    v_hat = v / (1.0 - b2 ** t)
                    z = z - cfg.peem_lr * m_hat / (torch.sqrt(v_hat) + eps_adam)
                vs = dec(z)
            w, h, g, vb = nmf_m_step(x2, vs[None], w, h, g, mask, cfg.eps)
            costs.append(_masked_cost(x2, vs[None], vb, g, mask))

        vb = compute_vb(w, h)
        vs_scaled = g[:, :, None] * vs
        vx = (vs_scaled + vb).clamp_min(VX_FLOOR)
        m3 = mask[:, :, None]
        return McemResult(vs_scaled / vx * m3, vb / vx * m3, _stack(costs, x2), z, w, h, g)


def run_em_fixed_z(mats, x2: torch.Tensor, z_fixed: torch.Tensor, mask: torch.Tensor,
                   seed: int = 0, cfg: McemConfig = McemConfig(), y=None,
                   nmf_init=None) -> McemResult:
    """EM with the latent pinned at ``z_fixed``: the reference's
    ``clean_z_nomcem`` ablation (its golden ``*_clean_z_nomcem_*`` wavs),
    with ``z_fixed`` the clean spectrogram's encoding. ``Vs = dec(z_fixed)``
    is computed once, EM fits only the NMF noise model and the gains
    against it (``niter`` M-steps and the masked cost), and the Wiener
    masks are deterministic. It is :func:`run_peem` with ``peem_steps=0``,
    and runs no chain; ``seed`` only seeds the NMF init."""
    return run_peem(mats, x2, z_fixed, mask, seed, dataclasses.replace(cfg, peem_steps=0), y,
                    nmf_init)


def run_peem_wf(mats, x2: torch.Tensor, z_init: torch.Tensor, mask: torch.Tensor,
                seed: int = 0, cfg: McemConfig = McemConfig(), y=None,
                nmf_init=None) -> McemResult:
    """PEEM's EM loop, then MCEM's Monte-Carlo Wiener masks: one WF chain
    segment from PEEM's latent (``burnin_wf`` + ``nsamples_wf`` steps, as
    run_mcem's tail), on the WF stream. Same NMF init as the other engines
    of this seed; stochastic through the WF segment only."""
    x2, mask, nmf_init, mats, (_, g_wf), cfg = _prep_em(mats, x2, mask, cfg, y, seed, nmf_init)
    res = run_peem(mats, x2, z_init, mask, seed, cfg, None, nmf_init)
    b, n, f = x2.shape
    wfs, wfn, z = _wf_expectation(mats, _stats(x2.reshape(b * n, f), cfg), mask, res.z,
                                  res.w, res.h, res.g, g_wf, cfg)
    return McemResult(wfs, wfn, res.cost, z, res.w, res.h, res.g)
