"""The yardstick's work counts and the H100's published peaks.

Frozen copies of the counts the port's smoke run used (``chain_work``,
``chain_bound_ms``, ``stft_power_work``, ``bound_ms``), ``m_step_work``
with each input byte counted once (the smoke run's counts its three
stages' reads), plus :func:`enhance_flops`, the model FLOPs one enhanced
utterance needs.
They live here so that a change to the program cannot move them.
"""

from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on CUDA cores, bf16 on
# tensor cores, HBM3 bandwidth. They assume the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def chain_work(rows, f, l, widths, n_burn, n_samples, wf, fast_stats=False):
    """(product flops, elementwise flops, special functions, bytes) one
    MH-chain segment needs with a decoder of hidden ``widths``: every step
    decodes all rows (plus the initial decode); each input is read once and
    each output written once, at its dtype: 4 bytes, except under
    ``fast_stats`` 2 for x2, for an E-step's Vb and for its emitted samples.
    The special functions are the exp, log and divide per (row, step, bin),
    and WF mode's two divides per emitted (row, bin)."""
    steps = n_burn + n_samples + 1
    dims = (l, *widths, f)
    layer_macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    macs = rows * steps * layer_macs
    # per (row, step, bin): exp, g*Vs+Vb, max, log, divide, add
    elem = rows * steps * f * 6 + (rows * n_samples * f * 5 if wf else 0)
    sfu = rows * steps * f * 3 + (rows * n_samples * f * 2 if wf else 0)
    weights = layer_macs + sum(widths) + f
    half = 2 if fast_stats else 4
    x2_vb = rows * f * (half + (4 if wf else half))
    reads = 4 * (rows + rows * l + (steps - 1) * rows * (l + 1) + weights) + x2_vb
    writes = 4 * rows * l + (4 * 2 * rows * f if wf else half * n_samples * rows * f)
    return 2 * macs, elem, sfu, reads + writes


def bound_ms(flops, nbytes):
    """The least time of ``flops`` f32 operations and ``nbytes`` bytes, and
    which of the two sets it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chain_bound_ms(work, fast):
    """The least time of a chain segment and what sets it: the products at
    the bf16 tensor-core peak (``fast``) or, with the elementwise work, at
    the f32 peak; the elementwise work at the f32 peak; the bytes at the
    HBM rate."""
    mma, elem, _, nbytes = work
    if not fast:
        return bound_ms(mma + elem, nbytes)
    t_ops = max(mma / PEAK_BF16_FLOPS, elem / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def m_step_work(r, b, n, f, vs_bytes):
    """(flops, bytes) the least one NMF M-step needs with R = ``r`` samples
    of (B, N, F) = (``b``, ``n``, ``f``) stored at ``vs_bytes`` a value:
    the samples and x2 (f32) read once, whatever an implementation reads
    again (one utterance's samples fit in L2), and the f32 Vb written once
    (W, H and g are 2% of that at rank 10, and left out); per sample
    element the W and H stages take g Vs + Vb, the floor, 1/Vx, its square
    and two sums (7 operations each), the g stage those and x2 Vs, two
    products and two sums (9). At the configurations' sizes the bytes set
    the bound."""
    elems = r * b * n * f
    return 23 * elems, elems * vs_bytes + 8 * b * n * f


def stft_power_work(rows, t_total, nfft, n_bins, log_out):
    """(flops, bytes) the least a power spectrogram needs: per frame the
    window and one nfft-point FFT (5 nfft log2 nfft operations, the
    customary radix-2 count), then re^2 + im^2 (+ log) per bin; each
    waveform sample read once, each output written once."""
    flops = rows * (nfft + 5 * nfft * math.log2(nfft)) + rows * n_bins * (4 if log_out else 3)
    return flops, 4 * (t_total + rows * n_bins)


def mlp_flops(dims) -> int:
    """2 x the multiply-adds of a dense stack through ``dims``."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def enhance_flops(frames: int, mcem: dict, f: int, l: int, widths, nfft: int,
                  y_dim: int = 0, classifier_widths=None) -> float:
    """Model FLOPs that enhancing ``frames`` valid frames needs at the MCEM
    budget ``mcem`` (the ``McemConfig`` fields), whatever implements them:

    - the decoder's products at every chain step: (burn-in + samples + 1)
      per E-step segment, ``niter`` segments, and the WF segment's
      (burn-in + samples + 1); the labels enter as a row bias, folded once
      per frame (``y_dim`` x the first hidden width);
    - the encoder once (its mean and log-variance heads);
    - the classifier once where the labels are the model's own;
    - 23 operations per sample element per M-step (``m_step_work``);
    - 5 nfft log2 nfft per frame for the STFT and again for the ISTFT.
    """
    widths = tuple(widths)
    dec = mlp_flops((l, *widths, f))
    steps = (mcem["niter"] * (mcem["burnin_e_step"] + mcem["nsamples_e_step"] + 1)
             + mcem["burnin_wf"] + mcem["nsamples_wf"] + 1)
    enc_hidden = tuple(reversed(widths))
    enc = mlp_flops((f, *enc_hidden)) + 2 * mlp_flops((enc_hidden[-1] if enc_hidden else f, l))
    fold = 2 * y_dim * (widths[0] if widths else f)
    clf = 0 if classifier_widths is None else mlp_flops((f, *classifier_widths, y_dim))
    mstep = 23 * mcem["nsamples_e_step"] * f * mcem["niter"]
    fft = 2 * 5 * nfft * math.log2(nfft)
    return float(frames * (steps * dec + enc + fold + clf + mstep + fft))


def video_vad_flops(frames: int, hidden: int, layers: int, emb_dim: int, conv_features,
                    side: int = 67) -> float:
    """Model FLOPs of the video VAD network (``VideoVad``) over ``frames``
    lip crops: each 3x3 stride-2 conv's multiply-adds at its SAME output
    size, the projection, every LSTM layer's input and recurrent products
    (4 gates) and the head; the gates' elementwise work is left out."""
    flops, chans = 0, (1, *conv_features)
    for c_in, c_out in zip(chans[:-1], chans[1:]):
        side = -(-side // 2)
        flops += 2 * side * side * c_out * c_in * 9
    flops += 2 * side * side * chans[-1] * emb_dim
    for k in range(layers):
        flops += 2 * 4 * hidden * ((emb_dim if k == 0 else hidden) + hidden)
    return float(frames * (flops + 2 * hidden))
