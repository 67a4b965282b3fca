"""Plain MCEM stages: the decoder, one Metropolis-Hastings chain segment,
the masked NMF M-step and the Wiener masks, as the configuration states
them (``McemConfig``: bf16 decoder products and planes under
``fast_decoder`` / ``fast_stats``, f32 elsewhere).

Each function takes a stage's inputs and returns its outputs, so the
benchmark can hand it the inputs the program's stage was given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.precision import Precision, round_bits

VX_FLOOR = 1e-10


class Decoder(NamedTuple):
    """A tanh MLP decoder ending in exp, each weight (in, out): the first
    layer split into its latent rows ``w1z`` and label rows ``w1y``."""

    w1z: torch.Tensor
    w1y: torch.Tensor | None
    b1: torch.Tensor
    hidden: tuple
    w_out: torch.Tensor
    b_out: torch.Tensor


def row_bias(dec: Decoder, y, fast: bool, prec: Precision) -> torch.Tensor:
    """The first layer's bias per row: ``b1 + y @ w1y`` (operands at the
    decoder's precision), or ``b1`` without labels."""
    if y is None:
        return dec.b1
    bits = prec.half if fast else prec.mm
    return dec.b1 + round_bits(y, bits) @ round_bits(dec.w1y, bits)


def decode(dec: Decoder, z, by, fast: bool, prec: Precision) -> torch.Tensor:
    """Vs = exp(decoder(z)) with first-layer bias ``by``: under ``fast``
    each product rounds both operands to the half precision and sums in
    f32; else both are f32 (TF32 in the control)."""
    bits = prec.half if fast else prec.mm

    def mm(a, w):
        return round_bits(a, bits) @ round_bits(w, bits)

    h = torch.tanh(mm(z, dec.w1z) + by)
    for w, b in dec.hidden:
        h = torch.tanh(mm(h, w) + b)
    return torch.exp(mm(h, dec.w_out) + dec.b_out)


def segment(dec: Decoder, by, x2, vb, g, z, noise, n_burn: int, n_samples: int,
            var_rw: float, wf: bool, fast: bool, fast_stats: bool, prec: Precision):
    """One chain segment over independent rows. ``x2``, ``vb`` (rows, F)
    are the planes as stored (an E-step's bf16 under ``fast_stats``, a WF
    segment's Vb f32); the energy reads them at the half precision under
    ``fast_stats``. Per step: z' = z + sqrt(var_rw) eps; accept iff log u <
    E(z) - E(z'), E = sum_f [log Vx + x2 / Vx] + |z|^2 / 2, Vx = max(g Vs +
    Vb, floor). Returns (z, samples (n_samples, rows, F) rounded to the
    half precision under ``fast_stats``) or, in WF mode, (z, sums of
    g Vs / Vx, sums of Vb / Vx) with the f32 Vb."""
    l = z.shape[-1]
    bits = prec.half if fast_stats else prec.mm
    x2e, vbe = round_bits(x2, bits), round_bits(vb, bits)
    gg = g[:, None]
    vb32 = vb.float()

    def energy(z, vs):
        vx = (gg * vs + vbe).clamp_min(VX_FLOOR)
        return (torch.log(vx) + x2e / vx).sum(-1) + 0.5 * (z * z).sum(-1)

    z = z.float()
    vs = decode(dec, z, by, fast, prec)
    e = energy(z, vs)
    step = math.sqrt(var_rw)
    samples, wfs, wfn = [], torch.zeros_like(vb32), torch.zeros_like(vb32)
    for k in range(n_burn + n_samples):
        zp = z + step * noise[k, :, :l]
        vsp = decode(dec, zp, by, fast, prec)
        ep = energy(zp, vsp)
        acc = noise[k, :, l] < e - ep
        z = torch.where(acc[:, None], zp, z)
        vs = torch.where(acc[:, None], vsp, vs)
        e = torch.where(acc, ep, e)
        if k >= n_burn:
            if wf:
                vsc = gg * vs
                vx = (vsc + vb32).clamp_min(VX_FLOOR)
                wfs, wfn = wfs + vsc / vx, wfn + vb32 / vx
            else:
                samples.append(round_bits(vs, bits))
    if wf:
        return z, wfs, wfn
    return z, torch.stack(samples)


def m_step(x2, vs, w, h, g, mask, eps: float, fast_stats: bool, prec: Precision):
    """One masked multiplicative M-step (W with its Vx refresh, H, the
    column renormalization, then g) from samples ``vs`` (R, B, N, F); the
    R-sums are stored at the half precision under ``fast_stats``.
    Returns (w, h, g, vb)."""
    m = mask[:, :, None].float()
    x2, vs = x2.float(), vs.float()
    bits = prec.half if fast_stats else prec.mm

    def vbf(w, h):
        return prec.einsum("bnk,bfk->bnf", h, w)

    def r_sums(vb):
        r1 = 1.0 / (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)
        return round_bits(r1.sum(0), bits), round_bits((r1 * r1).sum(0), bits)

    a1, a2 = r_sums(vbf(w, h))
    num = prec.einsum("bnf,bnk->bfk", x2 * a2 * m, h)
    den = prec.einsum("bnf,bnk->bfk", a1 * m, h)
    w = w * torch.sqrt(num / den.clamp_min(eps))
    a1, a2 = r_sums(vbf(w, h))
    num = prec.einsum("bnf,bfk->bnk", x2 * a2, w)
    den = prec.einsum("bnf,bfk->bnk", a1, w)
    h = h * torch.sqrt(num / den.clamp_min(eps))
    norm = w.abs().sum(1).clamp_min(eps)
    w, h = w / norm[:, None, :], h * norm[:, None, :]
    vb = vbf(w, h)
    r1 = 1.0 / (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)
    num = (x2[None] * vs * (r1 * r1)).sum((0, 3))
    den = (vs * r1).sum((0, 3))
    return w, h, g * torch.sqrt(num / den.clamp_min(eps)), vb
