#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit, then the MH-chain
   kernel built from ``dvae_tpu_torch/csrc/mh_chain.cu``;
2. both bodies of the MH-chain kernel, the bf16 tensor-core body
   (``fast_decoder=True``) and the f32 body, each against the plain
   PyTorch chain of its precision on the card at full width (F 513, L 16,
   H 128/128): frozen chain, live E-step and WF segments fed the same
   noise, a (128, 64) hidden stack, a conditioned row bias and the
   mismatch raise; the bf16 body also against the f32 plain chain,
   printed without a limit;
3. the M1 ``Enhancer`` end to end on B = 32 synthetic ~5.1 s utterances at
   the full ``McemConfig()`` budget: the bf16 body's launch count must rise
   by exactly niter + 1, outputs must be finite; the same with
   ``fast_decoder=False`` through the f32 body; then, in each precision,
   the frozen-chain config runs once through the kernel and once through
   the plain chain, and masks and waveforms must agree, with the Wiener
   partition s + n = x;
4. times (CUDA events, warm): each body and its plain chain per E-step and
   WF segment at main-path shape, the NMF M-step, and the whole
   ``enhance_batch`` (default config, so the bf16 body), each with the
   card's name and power limit;
5. the STFT power kernel against its plain version on the card: power and
   log epilogues, ``center`` off and on, frame counts off any block's
   frames, the end-pad quirk, a short centered signal, a silent row (exactly
   0, or log(eps) as the plain version gives it) beside a full-scale one, and
   the fewest frames a signal gives;
6. M1 training at full width (``VAE(513, 16, (128, 128))``, batch 128,
   Adam 1e-4): synthetic clean utterances become the frame set through the
   STFT power kernel (one launch per frame set), ``fit_vae`` runs a few
   epochs (finite ELBOs, validation ELBO falling, one ``.pt`` per epoch),
   and the best ``.pt`` loads into the ``Enhancer``, which enhances the
   phase-3 batch; again with ``std_norm`` and ``EnhancerConfig(norm=...)``;
7. audio-VAD training at full width (``LSTMVad(513, 1024, 2)``, batch 16)
   on synthetic noisy utterances held in memory, their log power taken by
   the kernel's log epilogue (one launch per batch): finite BCE, falling;
8. the STFT power kernel held against its plain version, and timed (CUDA
   events, warm: through the wrapper, the call the path makes, with the
   wrapper's host time per call; and its C launch alone, back to back)
   against the plain version, ``torch.stft`` and the bound, on each path's
   own launch: phase 6's train frame set (power) and a phase-7 batch
   (log); then the M1 train step host-fed and on device-resident data, the
   LSTM train step, and the frame-set build, each with the card's name and
   power limit;
9. the conditional families at full width on the phase-3 batch and the full
   budget, weights random from the seed: M2-info (``DisentangledVAE(513, 1,
   16, (128, 128))``, ``dec_only``) with self-soft labels from its own
   classifier, whose spectrogram is one STFT power launch, and niter + 1
   bf16-body chain launches with the labels folded into a row bias; M2
   (``CVAE(513, 513, 16, (128, 128))``, ``enc_dec``) with IBM labels of the
   clean parts (the port's ``clean_speech_ibm``), niter + 1 launches;
   outputs finite. Then, for both models
   and in both bodies, the frozen-chain config through the kernel and the
   plain chain, with phase 3's limits and the Wiener partition; then times:
   both ``enhance_batch`` walls beside phase 4's M1, the labeling, the
   conditioned E-step segment with its bound, the y_dim 513 fold, and the
   STFT power kernel at the labeling launch (as in phase 8), each with the
   card's name and power limit;
10. every E-step engine and ablation beside mcem on the phase-3 M1 model and
   batch at the full budget: ``pmcem`` (its R chains the R x 10,240 rows of
   one segment: niter E-step and one WF launch at those rows), ``peem`` (no
   launch), ``peem-wf`` (one WF launch), the ``clean_z`` ablation (niter +
   1) and ``clean_z_nomcem`` (none), each with its launches and segment rows
   asserted, finite outputs and the Wiener partition; M2-info ``pmcem`` with
   self-soft labels; frozen ``pmcem`` and ``peem-wf`` through the kernel and
   the plain chain with phase 3's limits; then times: each engine's
   ``enhance_batch`` beside phase 4's mcem, PEEM's Adam loop, and the
   pmcem E-step / WF and peem-wf WF segments (CUDA events) with their
   bounds; last, the NTCD sweep CLIs on a synthetic tree of 16 clean
   utterances (32 mixtures) under ``build/``: ``evaluate_ntcd_m1`` writes
   the reference layout and resumes by skipping, ``--ablation
   clean-z-nomcem`` writes the golden names, ``--shard 0/2`` and ``1/2``
   cover the list once, and ``evaluate_ntcd_m2_info_vad --y-source
   self-soft --engine pmcem`` runs one STFT power launch per utterance;
   the short ``run_peem`` under ``torch.profiler`` runs last in the script
   (after phase 11), since host timings taken after it ran slower;
11. the HTTP enhancement server on the phase-3 M1 model (a copy) at the
   full budget: ``EnhanceService`` (batch 8, window 25 ms, 6 s chunks)
   behind ``make_server`` on a loopback port, warmed on the 320-frame
   bucket; 16 concurrent ``POST /enhance?return=stereo`` of the phase-3
   mixtures (all 200, at most 3 batches, exactly batches x (niter + 1)
   bf16-body chain launches, the Wiener partition), with requests/s, the
   latency quantiles and busy_seconds over the wall; one 30 s mixture
   through ``?stream=1`` (exact length, partition, first and last body
   bytes); ``/reload`` of perturbed weights under ``build/``; ``/healthz``
   (platform gpu, ready) and ``/metrics``; then, in each decoder
   precision, a frozen served batch of 8 against the same batch through
   ``enhance_batch`` with the plain chain, with phase 3's limits; an
   M2-info service with self-soft labels (one STFT power launch and niter
   + 1 conditioned chain launches per batch); times: a served batch's
   ``dispatch`` and ``collect``, a batch of 1 request and 7 fillers, the
   E-step segment at the served 2,560 rows and the STFT power kernel at
   the self-soft batch; ``python -m dvae_tpu_torch.cli.serve`` as a
   subprocess (ready, one request, SIGTERM exits 0); and
   ``enhance_wav --chunk-seconds 4`` on a 30 s wav (the partition, one
   chain run per dispatch of 4 chunks);
12. training the conditional families at full width, after phase 11 (and
   before phase 10's profiler run): phase 6's utterances, gated so that a
   VAD finds silence, become a VAD and an IBM labelled frame set (39,721 +
   4,981 frames) through one STFT power launch per frame set, the labels
   held against the plain path on the card (VAD exactly; IBM on all but
   1e-4 of the bins, each within 1e-3 dB of its threshold); five models
   train 3 epochs each at batch 128, Adam 1e-4 (``CVAE`` on VAD and on IBM
   with ``fit_vae(conditional=True)``, ``DisentangledVAE`` and ``CVAE_v4``
   (``hardlabel``) with ``fit_adversarial`` at the published alpha 0, beta
   10, gamma 1, ``CVAE_v3`` with ``fit_semisup(uloss, alpha=10)``): finite
   metrics, one ``.pt`` per epoch, the ELBO falling; the best M2-info
   ``.pt`` (self-soft labels, one STFT power launch) and M2 IBM ``.pt``
   enhance the phase-3 batch through niter + 1 bf16-body chain launches
   each; then each train step's time at batch 128 (host clock over an
   epoch, CUDA events over 50 warm steps) beside M1's, the chain's E-step
   segment at the trained M2-info's fold and the STFT power kernel at the
   labelled frame set, each with the card's name and power limit.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Weights are random from a seed; the repo
ships no checkpoint. Training writes its checkpoints under ``build/``.
Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
B, SECONDS, FS = 32, 5.1, 16000
M1_TRAIN_UTTS, M1_VALID_UTTS, M1_EPOCHS = 128, 16, 3
VAD_TRAIN_UTTS, VAD_VALID_UTTS, VAD_EPOCHS, VAD_BATCH = 256, 32, 4, 16
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, dense bf16 on
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the bf16 body against the plain chain of its precision: both round the
# same operands to bf16 and sum in f32 in another order, so a tanh output
# within rounding of a bf16 rounding boundary can round the other way and
# move its row's Vs by up to ~1e-3 relative (a few rows in a thousand)
BF16_MAX_REL, BF16_REL, BF16_SHARE = 5e-3, 1e-5, 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def synthetic_parts(rng: np.random.Generator, count: int, gated: bool = False):
    """(clean, noise) pairs: harmonic 'speech' with a drifting pitch, and
    babble-like noise. ``gated`` switches the speech on and off in 0.2-0.8 s
    segments, so that frames without speech exist."""
    out = []
    for i in range(count):
        n = int(SECONDS * FS) - int(rng.integers(0, 3000))
        t = np.arange(n) / FS
        f0 = 110 + 60 * rng.random() + 20 * np.sin(2 * np.pi * 0.5 * t)
        phase = 2 * np.pi * np.cumsum(f0) / FS
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (1.5 + rng.random()) * t) ** 2
        speech = env * sum(np.sin(k * phase) / k for k in range(1, 12))
        noise = rng.standard_normal(n) * (0.1 + 0.2 * rng.random())
        if gated:
            edges = np.cumsum(rng.uniform(0.2, 0.8, 16) * FS).astype(int)
            speech = speech * (np.searchsorted(edges, np.arange(n), side="right") % 2)
        out.append((0.2 * speech, noise))
    return out


def synthetic_wavs(rng: np.random.Generator) -> list[np.ndarray]:
    """Mixtures of :func:`synthetic_parts`."""
    return [(s + n).astype(np.float32) for s, n in synthetic_parts(rng, B)]


def vad_labels(clean: np.ndarray, n_frames: int, hop: int, half: int) -> np.ndarray:
    """Per-frame labels from the clean part's energy around each frame's
    centre (centred STFT framing): 1 where it exceeds 1e-3 of the peak."""
    e = np.convolve(clean.astype(np.float64) ** 2, np.ones(2 * half), mode="same")
    centres = np.minimum(np.arange(n_frames) * hop, len(clean) - 1)
    return (e[centres] > 1e-3 * e.max()).astype(np.float32)


def chain_work(rows, f, l, h1, h2, n_burn, n_samples, wf):
    """(product flops, elementwise flops, special functions, bytes) one
    chain segment needs: every step decodes all rows (plus the initial
    decode); each input is read once and each output written once. The
    special functions are the exp, log and divide per (row, step, bin),
    and WF mode's two divides per emitted (row, bin)."""
    steps = n_burn + n_samples + 1
    macs = rows * steps * (l * h1 + h1 * h2 + h2 * f)
    # per (row, step, bin): exp, g*Vs+Vb, max, log, divide, add
    elem = rows * steps * f * 6 + (rows * n_samples * f * 5 if wf else 0)
    sfu = rows * steps * f * 3 + (rows * n_samples * f * 2 if wf else 0)
    weights = l * h1 + h1 * h2 + h2 * f + h1 + h2 + f
    reads = 2 * rows * f + rows + rows * l + (steps - 1) * rows * (l + 1) + weights
    writes = rows * l + (2 * rows * f if wf else n_samples * rows * f)
    return 2 * macs, elem, sfu, 4 * (reads + writes)


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


def stft_power_work(rows, t_total, nfft, n_bins, log_out):
    """(flops, bytes) the least a power spectrogram needs: per frame the
    window and one nfft-point FFT (5 nfft log2 nfft operations, the
    customary radix-2 count), then re^2 + im^2 (+ log) per bin; each
    waveform sample read once, each output written once."""
    flops = rows * (nfft + 5 * nfft * math.log2(nfft)) + rows * n_bins * (4 if log_out else 3)
    return flops, 4 * (t_total + rows * n_bins)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def limit_ratio(got, p):
    """Largest |got - p| over the power limit, rtol 1e-4 above a floor of
    1e-6 of the batch's peak power (<= 1 passes)."""
    return float(((got - p).abs() / (1e-4 * p.abs() + 1e-6 * p.amax())).max())


def log_err(got, p):
    """Largest |got - log(p + 1e-12)| on the bins above 1e-6 of the batch's
    peak power (limit 1e-3)."""
    big = p > 1e-6 * p.amax()
    return float((got[big] - (p[big] + 1e-12).log()).abs().max())


def frozen_agreement(rk, rp, mask):
    """A frozen run through the kernel (``rk``) against the plain chain
    (``rp``): the largest mask difference, the largest relative cost
    difference and the largest |WFs + WFn - 1| on valid frames (phase 3's
    limits: 1e-3, 1e-4, 1e-5)."""
    mask_err = max(float((rk.wfs - rp.wfs).abs().max()), float((rk.wfn - rp.wfn).abs().max()))
    cost_err = float(((rk.cost - rp.cost).abs() / rp.cost.abs().clamp_min(1e-30)).max())
    part = float(((rk.wfs + rk.wfn - 1.0).abs() * mask[:, :, None]).max())
    return mask_err, cost_err, part


def host_call_ms(fn, reps=200):
    """Host wall time per call of ``fn``, with no synchronize between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def time_stft(xp, log_out, label, launches, cuda_ms, tag, phase=8):
    """B2 against its plain version at one path's launch (the padded
    waveform ``xp`` the wrapper hands the kernel), then times; returns the
    path's entry of the kernels line."""
    import torch

    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, get_window

    dev, sync = xp.device, torch.cuda.synchronize
    framing = StftConfig(center=False, pad_at_end=False)  # frames of a padded waveform
    nfft, hop, n_bins = framing.nfft, framing.hop, framing.n_bins
    rows = xp.shape[0] * (1 + (xp.shape[1] - nfft) // hop)
    eps = 1e-12 if log_out else None
    win = torch.from_numpy(get_window(framing.window, nfft).astype(np.float32)).to(dev)

    def library():
        p = torch.stft(xp, nfft, hop, window=win, center=False, return_complex=True)
        p = p.abs().square()
        return torch.log(p + 1e-12) if log_out else p

    got = stft_power._launch(xp, framing, eps)
    power = stft_power.stft_power_reference(xp, framing)
    plain = torch.log(power + 1e-12) if log_out else power
    lib = library().transpose(-1, -2)
    sync()
    err = float((got - plain).abs().max())
    if log_out:  # on the bins above 1e-6 of the peak power, as in phase 5
        within, lib_within = log_err(got, power), log_err(lib, power)
        check(within < 1e-3, f"log epilogue at the {label}: {within}")
    else:
        within, lib_within = limit_ratio(got, power), limit_ratio(lib, power)
        check(within <= 1.0, f"power epilogue at the {label}: {within}")

    def wrapper():
        return stft_power._launch(xp, framing, eps)

    # ms is the call the path makes, through the wrapper, as for mh_chain;
    # device_ms is the kernel alone, its C launch back to back, without
    # the wrapper's host time (more than a VAD batch's device time)
    win_t, tw, tw_split = stft_power._fft_tables(nfft, framing.window, dev)
    out = torch.empty_like(got)
    raw = (xp.data_ptr(), win_t.data_ptr(), tw.data_ptr(), tw_split.data_ptr(),
           out.data_ptr(), *xp.shape, got.shape[1], nfft, hop, int(log_out),
           eps or 0.0, torch.cuda.current_stream().cuda_stream)
    launch = stft_power.build_library().stft_power_launch
    check(launch(*raw) == 0, "stft_power raw launch")
    sync()
    check(torch.equal(out, got), "raw launch differs from the wrapper's")
    w_ms, host_ms = cuda_ms(wrapper, reps=50, warm=3), host_call_ms(wrapper)
    d_ms = cuda_ms(lambda: launch(*raw), reps=200, warm=5)
    p_ms = cuda_ms(lambda: stft_power.stft_power_reference(xp, framing, eps), reps=10, warm=2)
    l_ms = cuda_ms(library, reps=50, warm=3)
    flops, nbytes = stft_power_work(rows, xp.numel(), nfft, n_bins, log_out)
    b_ms, b_by = bound_ms(flops, nbytes)
    limit = ("max abs err {:.3e} on bins above 1e-6 x peak (limit 1e-3)" if log_out
             else "at {:.3f} of the power limit")
    log(f"phase {phase}: stft_power at the {label} ({tuple(xp.shape)} padded, {rows} frames, "
        f"{'log' if log_out else 'power'}, {launches} launches on the path): kernel vs "
        f"plain {limit.format(within)}, max abs err {err:.3e}; through the wrapper "
        f"{w_ms:.4f} ms (its host time {host_ms:.4f} ms per call), plain {p_ms:.4f} ms, "
        f"torch.stft {l_ms:.4f} ms (wrapper / torch.stft = {w_ms / l_ms:.3f}, both calls "
        f"as the host issues them; torch.stft vs plain {limit.format(lib_within)}); the "
        f"kernel alone (C launch) {d_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({flops / 1e9:.3f} GFLOP as an FFT, {nbytes / 1e6:.1f} MB): the kernel alone "
        f"at {100 * b_ms / d_ms:.2f}% of it, through the wrapper {100 * b_ms / w_ms:.2f}%; "
        f"the kernel alone ran the FFT at {flops / d_ms / 1e9:.3f} TFLOP/s and "
        f"{nbytes / d_ms / 1e9:.3f} TB/s {tag}")
    return {"name": f"stft_power ({label})", "route": "cuda",
            "source": "dvae_tpu_torch/csrc/stft_power.cu",
            "replaces": "dvae_tpu/ops/pallas_stft.py:80", "launches": launches,
            "max_abs_err": err, "ms": w_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}



def training_phases(work: str, mix_wavs, cuda_ms, tag: str) -> dict:
    """Phases 5-8 on the card; returns the stft_power entries of the kernels
    line, one per path. ``mix_wavs`` is the phase-3 batch, ``work`` a
    scratch directory."""
    import itertools

    import torch

    from dvae_tpu_torch.data.builders import build_frames, padded_batch
    from dvae_tpu_torch.data.datasets import FrameDataset
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE, LSTMVad
    from dvae_tpu_torch.ops import log_power_spectrogram, power_spectrogram, stft_power
    from dvae_tpu_torch.ops.stft import (
        StftConfig,
        n_stft_frames_clamped,
        pad_signal,
        padded_length,
    )
    from dvae_tpu_torch.train import checkpoint as ckpt
    from dvae_tpu_torch.train import loop
    from dvae_tpu_torch.train.loop import LoopConfig, fit_vae
    from dvae_tpu_torch.train.sequence import (
        batch_utterances,
        fit_sequence,
        make_lstm_vad_eval,
        make_lstm_vad_step,
        pad_utterances,
    )
    from dvae_tpu_torch.train.steps import adam, make_train_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def tone_batch(batch, length):
        t = torch.arange(length, device=dev) / FS
        return (0.3 * torch.sin(2 * torch.pi * 220 * t)
                + 0.2 * torch.randn((batch, length), generator=gen, device=dev))

    # ---- 5. the STFT power kernel against its plain version
    quirk = next(n for n in range(256 * 40, 256 * 120, 256)
                 if padded_length(n, StftConfig()) != n)
    worst_pow, worst_log, n_cases = 0.0, 0.0, 0
    for center in (False, True):
        cfg = StftConfig(center=center)
        cases = [(1, 20480), (3, 12345), (2, quirk), (4, int(SECONDS * FS))]
        cases += [(2, 300)] if center else []
        # the FFT's edges: a silent row beside a full-scale one, and the
        # fewest frames a signal gives (one uncentred, two centred)
        cases += [("edges", 20480), (1, 200 if center else 769)]
        for batch, length in cases:
            x = tone_batch(3 if batch == "edges" else batch, length)
            if batch == "edges":
                x[1] = 0.0
                x[2] = torch.where(x[2] > 0, 1.0, -1.0)
            for log_out in (False, True):
                before = stft_power.launches
                got = (log_power_spectrogram if log_out else power_spectrogram)(x, cfg)
                sync()
                check(stft_power.launches == before + 1, "stft_power launch count")
                p = stft_power.stft_power_reference(x, cfg)
                sync()
                check(stft_power.launches == before + 1, "the plain run launched the kernel")
                check(got.shape == p.shape, f"stft_power shape {tuple(got.shape)}")
                if batch == "edges":
                    silent = torch.log(p[1] + 1e-12) if log_out else p[1]
                    check(not p[1].any() and torch.equal(got[1], silent),
                          f"silent row center={center} log={log_out}: not exactly "
                          f"{'log(eps)' if log_out else '0'}")
                if length == (200 if center else 769):
                    check(got.shape[-2] == (2 if center else 1), "fewest frames")
                if log_out:
                    err = log_err(got, p)
                    check(err < 1e-3, f"log epilogue center={center} {batch}x{length}: {err}")
                    worst_log = max(worst_log, err)
                else:
                    ratio = limit_ratio(got, p)
                    check(ratio <= 1.0, f"power epilogue center={center} {batch}x{length}")
                    worst_pow = max(worst_pow, ratio)
                n_cases += 1
    log(f"phase 5: stft_power kernel vs plain, {n_cases} cases: power error at "
        f"{worst_pow:.3f} of its limit (rtol 1e-4, floor 1e-6 x peak); log max abs "
        f"err {worst_log:.3e} on bins above 1e-6 x peak (limit 1e-3); silent rows "
        f"exactly 0 / log(eps) as in the plain version; the plain runs launched nothing")

    # ---- 6. M1 training at full width, then serving the trained prior
    rng = np.random.default_rng(SEED + 1)
    clean_train = [c.astype(np.float32) for c, _ in synthetic_parts(rng, M1_TRAIN_UTTS)]
    clean_valid = [c.astype(np.float32) for c, _ in synthetic_parts(rng, M1_VALID_UTTS)]
    stft_power.launches = 0
    t0 = time.perf_counter()
    tr = build_frames(clean_train)
    va = build_frames(clean_valid)
    t_build = time.perf_counter() - t0
    m1_launches = stft_power.launches
    check(m1_launches == 2, f"{m1_launches} stft_power launches for 2 frame sets")
    check(np.isfinite(tr.x).all() and np.isfinite(va.x).all() and (tr.std > 0).all(),
          "frame set finite")
    log(f"phase 6: frame sets {tr.x.shape} train / {va.x.shape} valid from "
        f"{M1_TRAIN_UTTS} + {M1_VALID_UTTS} utterances in {t_build:.3f} s, "
        f"{m1_launches} stft_power launches (one per frame set)")
    train_ds = FrameDataset.from_arrays(tr.x, None, tr.mean, tr.std)
    valid_ds = FrameDataset.from_arrays(va.x)

    for std_norm in (False, True):
        model_dir = os.path.join(work, "m1_norm" if std_norm else "m1")
        cfg = LoopConfig(batch_size=128, learning_rate=1e-4, end_epoch=M1_EPOCHS + 1,
                         seed=SEED, std_norm=std_norm)
        t0 = time.perf_counter()
        _, hist = fit_vae(VAE(513, 16, (128, 128)), train_ds, valid_ds, model_dir, "M1", cfg=cfg)
        wall = time.perf_counter() - t0
        elbos = [(h["train"]["elbo"], h["valid"]["elbo"]) for h in hist]
        check(all(np.isfinite(e).all() for e in elbos), f"M1 ELBO not finite: {elbos}")
        check(elbos[-1][1] < elbos[0][1], f"M1 validation ELBO did not fall: {elbos}")
        pts = ckpt.checkpoints(model_dir, "M1_epoch_*.pt")
        check(len(pts) == M1_EPOCHS, f"{len(pts)} .pt files for {M1_EPOCHS} epochs")
        steps = M1_EPOCHS * -(-len(train_ds) // 128)
        log(f"phase 6: fit_vae std_norm={std_norm}: {steps} steps in {wall:.3f} s; "
            f"(train, valid) ELBO per epoch {[(round(a, 3), round(b, 3)) for a, b in elbos]}; "
            f"{len(pts)} .pt files")
        best = ckpt.best_checkpoint(model_dir, "M1")
        enh = Enhancer(VAE(513, 16, (128, 128)),
                       EnhancerConfig(norm=(tr.mean, tr.std) if std_norm else None))
        enh.reload(torch.load(best, map_location="cpu", weights_only=True))
        mh_chain.launches = 0
        out = enh.enhance_batch(mix_wavs, seed=SEED)
        want = enh.cfg.mcem.niter + 1
        check(mh_chain.launches == want, f"{mh_chain.launches} mh_chain launches, expected {want}")
        check(len(out) == len(mix_wavs)
              and all(np.isfinite(a).all() and np.isfinite(b).all() for a, b in out),
              "trained-model enhancement outputs finite")
        log(f"phase 6: {best.name} (std_norm={std_norm}) enhanced the phase-3 batch "
            f"through {mh_chain.launches} mh_chain launches; outputs finite, cost "
            f"{enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}")

    # ---- 7. audio-VAD training at full width on in-memory utterances
    stft_cfg = StftConfig(center=True)
    rng = np.random.default_rng(SEED + 2)

    def vad_utterances(count):
        out = []
        for clean, noise in synthetic_parts(rng, count, gated=True):
            mix = clean + noise
            mix = (mix / np.abs(mix).max()).astype(np.float32)  # peak-normalized, as loaded
            frames = n_stft_frames_clamped(len(mix), stft_cfg)
            out.append((mix, vad_labels(clean, frames, stft_cfg.hop, stft_cfg.nfft // 2)))
        return out

    vtrain, vvalid = vad_utterances(VAD_TRAIN_UTTS), vad_utterances(VAD_VALID_UTTS)

    def batcher(ds, idx):
        return batch_utterances(ds, idx, stft_cfg)

    # the train statistics of the noisy log power over valid frames
    # (the reference's std_norm default for this net)
    s1 = s2 = cnt = 0.0
    for s0 in range(0, len(vtrain), VAD_BATCH):
        x, _, m = batcher(vtrain, range(s0, min(s0 + VAD_BATCH, len(vtrain))))
        w = m[..., None].double()
        s1, s2, cnt = s1 + (x * w).sum((0, 1)), s2 + (x.double() ** 2 * w).sum((0, 1)), cnt + w.sum()
    mean = s1 / cnt
    norm = (mean.float().cpu().numpy()[:, None],
            torch.sqrt(s2 / cnt - mean ** 2).float().cpu().numpy()[:, None])
    speech = float(np.mean(np.concatenate([y for _, y in vtrain])))

    vad = LSTMVad(513, 1024, 2, generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt = adam(vad.parameters(), 1e-4)
    stft_power.launches = 0
    t0 = time.perf_counter()
    hist = fit_sequence(vad, opt, make_lstm_vad_step(vad, opt, norm=norm),
                        make_lstm_vad_eval(vad, norm=norm), vtrain, vvalid, batcher,
                        os.path.join(work, "vad"), prefix="VAD", seed=SEED,
                        end_epoch=VAD_EPOCHS + 1, batch_size=VAD_BATCH, log=log)
    sync()
    wall = time.perf_counter() - t0
    vad_launches = stft_power.launches
    per_epoch = -(-VAD_TRAIN_UTTS // VAD_BATCH) + -(-VAD_VALID_UTTS // VAD_BATCH)
    check(vad_launches == VAD_EPOCHS * per_epoch,
          f"{vad_launches} stft_power launches, expected one per batch ({VAD_EPOCHS * per_epoch})")
    bces = [(h["train"]["bce"], h["valid"]["bce"]) for h in hist]
    check(all(np.isfinite(b).all() for b in bces), f"VAD BCE not finite: {bces}")
    check(bces[-1][0] < bces[0][0], f"VAD train BCE did not fall: {bces}")
    log(f"phase 7: fit_sequence LSTMVad(513, 1024, 2) on {VAD_TRAIN_UTTS} utterances "
        f"({100 * speech:.1f}% speech frames), {VAD_EPOCHS} epochs in {wall:.3f} s, "
        f"{vad_launches} stft_power launches (one per batch); (train, valid) BCE per "
        f"epoch {[(round(a, 4), round(b, 4)) for a, b in bces]}; valid F1 "
        f"{hist[-1]['valid']['f1']:.4f}")

    # ---- 8. the kernel at each path's own launch, then times
    entries = [
        time_stft(padded_batch(clean_train)[0].to(dev), False, "train frame set",
                  m1_launches, cuda_ms, tag),
        time_stft(pad_signal(torch.from_numpy(pad_utterances(
            vtrain, range(VAD_BATCH), stft_cfg)[0]).to(dev), stft_cfg).contiguous(),
                  True, "VAD batch", vad_launches, cuda_ms, tag)]

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        build_frames(clean_train[:B])
        walls.append(time.perf_counter() - t0)
    log(f"phase 8: frame-set build of {B} utterances (~{SECONDS} s each, one launch, "
        f"copy back included): {', '.join(f'{w:.4f}' for w in walls)} s {tag}")

    # fit_vae's own per-batch path: its batch source, then the train step
    model = VAE(513, 16, (128, 128)).to(dev)
    step = make_train_step(model, adam(model.parameters(), 1e-4))
    g = torch.Generator(device=dev).manual_seed(SEED)
    order = np.random.default_rng(SEED)
    for name, rows in (("host-fed", loop._host_rows(train_ds, dev)),
                       ("device_data", loop._device_rows(train_ds, dev))):
        def run(n):
            count = 0
            for x, _ in itertools.islice(rows(128, order, True), n):
                step(x, generator=g)
                count += 1
            return count

        run(20)
        sync()
        t0 = time.perf_counter()
        n_steps = run(300)
        sync()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        log(f"phase 8: M1 train step batch 128 {name}: {ms:.4f} ms, {1e3 / ms:.1f} steps/s, "
            f"{128e3 / ms:.0f} frames/s {tag}")

    xv = torch.randn((VAD_BATCH, 320, 513), generator=gen, device=dev)
    yv = (torch.rand((VAD_BATCH, 320), generator=gen, device=dev) > 0.5).float()
    mv = torch.ones((VAD_BATCH, 320), device=dev)
    vstep = make_lstm_vad_step(vad, adam(vad.parameters(), 1e-4))
    l_ms = cuda_ms(lambda: vstep(xv, yv, mv), reps=10, warm=2)
    log(f"phase 8: LSTMVad(513, 1024, 2) train step at ({VAD_BATCH}, 320, 513): "
        f"{l_ms:.4f} ms {tag}")

    return entries


def ibm_labels(clean: np.ndarray, n_frames: int) -> np.ndarray:
    """Binary IBM labels (n_frames, 513) of the clean part: the port's
    ``clean_speech_ibm`` of its magnitude spectrogram (plain, on the CPU)."""
    import torch

    from dvae_tpu_torch.ops.stft import power_spectrogram
    from dvae_tpu_torch.ops.targets import clean_speech_ibm

    p = power_spectrogram(torch.from_numpy(clean.astype(np.float32)))
    return clean_speech_ibm(torch.sqrt(p)).numpy()[:n_frames]


def cond_batch_inputs(enh, wavs, ys):
    """A batch as a conditioned ``Enhancer``'s chain sees it, on the card:
    (x2, z0, mask, y), the labels ``ys`` padded as ``_prepare`` pads them."""
    import torch

    from dvae_tpu_torch.ops.stft import StftConfig, stft_realimag

    dev = torch.device("cuda")
    xw, x_scale, _, _, mask, y, n_pad, _ = enh._prepare(wavs, ys, None)
    with torch.inference_mode():
        x = xw.to(dev).float() * x_scale.to(dev)[:, None]
        re, im = stft_realimag(x, StftConfig())
        x2 = (re * re + im * im)[:, :n_pad].contiguous()
        y = y.to(dev)
        enc_in = torch.cat([x2, y], -1) if enh.cfg.y_mode == "enc_dec" else x2
        z0 = enh.model.encode(enc_in, sample=False)[1]
    return x2, z0, mask.to(dev), y


def conditioned_segment(mats, inputs, mc, cuda_ms, agree) -> dict:
    """B1's bf16 body on one E-step segment at a batch's shape (``inputs``
    from :func:`cond_batch_inputs`), the labels folded into a row bias:
    kernel and plain times, the bound, and a frozen segment held against
    the plain chain."""
    import torch

    from dvae_tpu_torch.enhance.mh_chain import (
        fold_conditioning,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf

    dev, f, l = torch.device("cuda"), 513, 16
    x2b, z0b, maskb, yb = inputs
    b, n_pad = maskb.shape
    rows = b * n_pad
    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), b, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    vb_r = compute_vb(w_, h_).reshape(rows, f).contiguous()
    g_r, x2_r, z_r = g_.reshape(rows).contiguous(), x2b.reshape(rows, f), z0b.reshape(rows, l)
    cm = fold_conditioning(mats, yb.reshape(rows, -1), True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n_burn, n_samp = mc.burnin_e_step, mc.nsamples_e_step
    noise = make_chain_noise(n_burn + n_samp, rows, l, gen, dev)
    args = (cm, x2_r, vb_r, g_r, z_r.contiguous(), None, noise, n_burn, n_samp, mc.var_rw,
            False, True)
    k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
    p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
    h1, h2 = cm[0].shape[1], cm[3].shape[1]
    work = chain_work(rows, f, l, h1, h2, n_burn, n_samp, False)
    work = (*work[:3], work[3] + 4 * rows * h1)  # plus the row bias, read once
    b_ms, b_by = chain_bound_ms(work, True)
    fargs = (*args[:9], 0.0, False, True)
    _, sk = run_mh_chain(*fargs)
    _, sr = mh_chain_reference(*fargs)
    torch.cuda.synchronize()
    return {"k_ms": k_ms, "p_ms": p_ms, "b_ms": b_ms, "b_by": b_by, "bytes": work[3],
            "max_abs": float((sk - sr).abs().max()), "rows": rows, "h1": h1,
            "steps": f"{n_burn}+{n_samp}",
            "said": agree(sk, sr, True, 1e-5, "conditioned frozen segment at main-path shape")}


def chain_entry(name: str, launches: int, seg: dict) -> dict:
    """B1's entry of the kernels line from a :func:`conditioned_segment`."""
    return {"name": name, "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
            "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": launches,
            "max_abs_err": seg["max_abs"], "ms": seg["k_ms"], "plain_ms": seg["p_ms"],
            "bound_ms": seg["b_ms"], "bound_by": seg["b_by"], "library_ms": None}


def conditioned_phase(wavs, cleans, cuda_ms, plain_chain, agree, tag: str,
                      m1_wall: float) -> list:
    """Phase 9 on the card: the conditional families at full width on the
    phase-3 batch (``wavs``, mixtures of the clean parts ``cleans``);
    returns the kernels-line entries of this path."""
    import torch

    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.labeling import self_soft_labels
    from dvae_tpu_torch.enhance.mcem import McemConfig, run_mcem
    from dvae_tpu_torch.enhance.mh_chain import fold_conditioning
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, DisentangledVAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped, pad_signal

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    stft_cfg, mc = StftConfig(), McemConfig()
    want = mc.niter + 1

    def finite(out):
        return len(out) == len(wavs) and all(
            len(s) == len(x) == len(n) and np.isfinite(s).all() and np.isfinite(n).all()
            for (s, n), x in zip(out, wavs))

    # ---- 9a. M2-info (v5), dec_only, self-soft labels: counts from 0 just
    # before the path and read just after
    v5 = init_xavier_(DisentangledVAE(513, 1, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    enh_v5 = Enhancer(v5, EnhancerConfig(y_mode="dec_only"))

    def label_v5():
        return self_soft_labels(enh_v5.model, wavs, stft_cfg, 1, "classify_from_x")

    mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
    t0 = time.perf_counter()
    ys_v5 = label_v5()
    out = enh_v5.enhance_batch(wavs, ys_v5, seed=SEED)
    t_first = time.perf_counter() - t0
    n_v5, n_v5_mma, n_stft = mh_chain.launches, mh_chain.launches_mma, stft_power.launches
    soft = np.concatenate(ys_v5)
    log(f"phase 9: M2-info DisentangledVAE(513, 1, 16, (128, 128)) dec_only, self-soft "
        f"labels: {n_stft} stft_power launch (expected 1), {n_v5_mma} launches of the bf16 "
        f"body, {n_v5} mh_chain launches in all (expected {want}), first call with labeling "
        f"{t_first:.3f} s; labels {soft.shape}, mean {soft.mean():.4f}, range "
        f"[{soft.min():.4f}, {soft.max():.4f}]; cost {enh_v5.last_cost[0]:.5f} -> "
        f"{enh_v5.last_cost[-1]:.5f}")
    check(n_stft == 1, f"{n_stft} stft_power launches for one self-soft batch")
    check(n_v5_mma == n_v5 == want, f"{n_v5_mma} bf16 body launches of {n_v5}, expected {want}")
    check(finite(out) and np.isfinite(enh_v5.last_cost).all(), "M2-info outputs finite")
    check(all(len(y) == n_stft_frames_clamped(len(x), stft_cfg) for y, x in zip(ys_v5, wavs))
          and np.isfinite(soft).all() and soft.min() >= 0 and soft.max() <= 1,
          "self-soft labels: one in [0, 1] per frame")

    # ---- 9b. M2 (CVAE) at y_dim 513, enc_dec, IBM labels of the clean parts
    cvae = init_xavier_(CVAE(513, 513, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    enh_ibm = Enhancer(cvae, EnhancerConfig(y_mode="enc_dec"))
    ys_ibm = [ibm_labels(c, n_stft_frames_clamped(len(c), stft_cfg)) for c in cleans]
    mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
    out = enh_ibm.enhance_batch(wavs, ys_ibm, seed=SEED)
    n_ibm, n_ibm_mma = mh_chain.launches, mh_chain.launches_mma
    log(f"phase 9: M2 CVAE(513, 513, 16, (128, 128)) enc_dec, IBM labels ("
        f"{100 * np.concatenate(ys_ibm).mean():.1f}% of bins on): {n_ibm_mma} launches of the "
        f"bf16 body, {n_ibm} in all (expected {want}), {stft_power.launches} stft_power; cost "
        f"{enh_ibm.last_cost[0]:.5f} -> {enh_ibm.last_cost[-1]:.5f}")
    check(n_ibm_mma == n_ibm == want, f"IBM: {n_ibm_mma} bf16 body launches of {n_ibm}")
    check(finite(out) and np.isfinite(enh_ibm.last_cost).all(), "M2 IBM outputs finite")

    # ---- 9c. frozen chain, kernel vs plain, both bodies, both models
    models = {"M2-info self-soft": (enh_v5, ys_v5), "M2 IBM": (enh_ibm, ys_ibm)}
    inputs = {name: cond_batch_inputs(enh, wavs, ys) for name, (enh, ys) in models.items()}
    nfft, hop = stft_cfg.nfft, stft_cfg.hop
    frames = [n_stft_frames_clamped(len(x), stft_cfg) for x in wavs]
    for name, (enh, ys) in models.items():
        x2b, z0b, maskb, yb = inputs[name]
        for fast in (True, False):
            body = "bf16" if fast else "f32"
            frozen = McemConfig(var_rw=0.0, fast_decoder=fast)
            with torch.inference_mode():
                rk = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen, y=yb)
                with plain_chain():
                    rp = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen, y=yb)
            sync()
            mask_err, cost_err, part = frozen_agreement(rk, rp, maskb)
            check(mask_err < 1e-3 and cost_err < 1e-4 and part < 1e-5,
                  f"{name} {body} frozen run_mcem: kernel vs plain")
            fcfg = EnhancerConfig(mcem=frozen, y_mode=enh.cfg.y_mode,
                                  noise_from_partition=False, wire_dtype="float32")
            enh_k = Enhancer(enh.model, fcfg)
            out_k = enh_k.enhance_batch(wavs, ys, seed=SEED)
            with plain_chain():
                out_p = enh_k.enhance_batch(wavs, ys, seed=SEED)
            wave_err, part_err = 0.0, 0.0
            for (sk_, nk_), (sp_, _), xx, fr in zip(out_k, out_p, wavs, frames):
                peak = float(np.abs(xx).max())
                core = slice(nfft, min(len(xx), (fr - 1) * hop + nfft) - nfft)
                wave_err = max(wave_err, float(np.abs(sk_ - sp_)[core].max()) / peak)
                part_err = max(part_err, float(np.abs(sk_ + nk_ - xx)[core].max()) / peak)
            log(f"phase 9: {name}, {body} frozen chain, kernel vs plain: run_mcem max mask "
                f"diff {mask_err:.3e} (limit 1e-3), max cost rel diff {cost_err:.3e} (limit "
                f"1e-4), |WFs + WFn - 1| <= {part:.3e} (limit 1e-5); enhance_batch max |s_k - "
                f"s_p| / peak {wave_err:.3e} (limit 1e-3), Wiener partition max |s + n - x| / "
                f"peak {part_err:.3e} (limit 1e-4)")
            check(wave_err < 1e-3 and part_err < 1e-4,
                  f"{name} {body} frozen enhance_batch: kernel vs plain, partition")

    # ---- 9d. times
    def walls(fn, n=3):
        out = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return out

    for name, (enh, ys) in models.items():
        w = walls(lambda: enh.enhance_batch(wavs, ys, seed=SEED))
        med = float(np.median(w))
        # host work that labels add: _prepare pads them into the wire
        # array beside the waveforms and masks, and the array is uploaded
        prep = walls(lambda: enh._prepare(wavs, ys, None)[5].to(dev), 5)
        log(f"phase 9: enhance_batch B={B} {name} (labels given) wall "
            f"{', '.join(f'{t:.4f}' for t in w)} s (median {med:.4f} s, {B / med:.2f} utt/s; "
            f"M1 in phase 4 {m1_wall:.4f} s, ratio {med / m1_wall:.4f}); host _prepare of the "
            f"batch with its labels and the labels' upload {1e3 * float(np.median(prep)):.3f} "
            f"ms (median of 5) {tag}")
    w = walls(label_v5, 5)
    log(f"phase 9: self-soft labeling of the batch (B2 launch, classifier on "
        f"{sum(frames)} frames, copy back) wall {', '.join(f'{1e3 * t:.3f}' for t in w)} ms "
        f"(median {1e3 * float(np.median(w)):.3f} ms) {tag}")

    seg = conditioned_segment(enh_v5.mats, inputs["M2-info self-soft"], mc, cuda_ms, agree)
    ibm_y = inputs["M2 IBM"][3]
    fold_ms = cuda_ms(lambda: fold_conditioning(enh_ibm.mats, ibm_y.reshape(seg["rows"], -1),
                                                True), reps=20, warm=2)
    log(f"phase 9: mh_chain bf16 body, conditioned E-step segment (row bias (rows, "
        f"{seg['h1']})) rows={seg['rows']} steps={seg['steps']}: kernel {seg['k_ms']:.4f} ms, "
        f"plain {seg['p_ms']:.4f} ms, bound {seg['b_ms']:.4f} ms by {seg['b_by']} "
        f"({seg['bytes'] / 1e6:.1f} MB with the row bias), kernel at "
        f"{100 * seg['b_ms'] / seg['k_ms']:.2f}% of bound; frozen segment kernel vs plain: max "
        f"abs err {seg['max_abs']:.3e}, {seg['said']}; the IBM fold (y_dim 513, once per batch) "
        f"{fold_ms:.4f} ms {tag}")

    t_max = max(len(x) for x in wavs)
    batch = np.stack([np.pad(x, (0, t_max - len(x))) for x in wavs]).astype(np.float32)
    xp = pad_signal(torch.from_numpy(batch).to(dev), stft_cfg).contiguous()
    stft_entry = time_stft(xp, False, "self-soft labels", n_stft, cuda_ms, tag, phase=9)
    return [chain_entry("mh_chain (conditioned)", n_v5_mma, seg), stft_entry]


def sweep_tree(root: str, count: int, seed: int):
    """A processed NTCD-TIMIT tree of ``count`` synthetic clean utterances
    (1-6 s) under ``<root>/data/subset/processed/ntcd_timit``: clean wavs
    and zero-byte label-h5 markers (the catalog only globs their names) in
    ``Clean/test/<spk>/``, and their mixtures on the subset grid (Babble and
    LR at -5 dB) in ``Noisy/``. Returns the noisy utterances' relative
    paths."""
    from dvae_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(seed)
    proc = os.path.join(root, "data", "subset", "processed")
    noisy = []
    for i in range(count):
        spk, utt = f"spk{i % 4:02d}", f"sx{i:03d}"
        n = int(rng.uniform(1.0, 6.0) * FS)
        t = np.arange(n) / FS
        phase = 2 * np.pi * np.cumsum(110 + 60 * rng.random() + 20 * np.sin(np.pi * t)) / FS
        clean = 0.2 * sum(np.sin(k * phase) / k for k in range(1, 12)) * (0.5 + 0.5 * np.sin(
            2 * np.pi * 2 * t) ** 2)
        d = os.path.join(proc, "ntcd_timit", "Clean", "test", spk)
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, f"{utt}.wav"), clean, FS)
        open(os.path.join(d, f"{utt}_vad_labels_upsampled.h5"), "wb").close()
        for noise in ("Babble", "LR"):
            rel = os.path.join("ntcd_timit", "Noisy", noise, "-5", "test", spk, f"{utt}.wav")
            os.makedirs(os.path.dirname(os.path.join(proc, rel)), exist_ok=True)
            write_wav(os.path.join(proc, rel), clean + rng.standard_normal(n) * 0.1, FS)
            noisy.append(rel)
    return sorted(noisy)


def engines_phase(model, wavs, cleans, mc, batch, cuda_ms, plain_chain, agree, tag: str,
                  m1_wall: float, work: str) -> list:
    """Phase 10 on the card: every E-step engine and ablation beside mcem at
    full width on the phase-3 batch (``wavs``, mixtures of ``cleans``) and
    the budget ``mc``; ``batch`` is the phase-3 batch as the engines see it
    (x2, z0, mask). Returns the kernels-line entries of these paths."""
    import torch

    from dvae_tpu_torch.cli import evaluate_ntcd_m1, evaluate_ntcd_m2_info_vad
    from dvae_tpu_torch.enhance import mcem, mh_chain
    from dvae_tpu_torch.enhance.labeling import self_soft_labels
    from dvae_tpu_torch.enhance.mcem import run_peem, run_peem_wf, run_pmcem
    from dvae_tpu_torch.enhance.mh_chain import (
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import DisentangledVAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    x2b, z0b, maskb = batch
    b, n_pad, f = x2b.shape
    l = z0b.shape[-1]
    rows, r = b * n_pad, mc.pmcem_chains
    stft_cfg = StftConfig()
    nfft, hop = stft_cfg.nfft, stft_cfg.hop
    frames = [n_stft_frames_clamped(len(x), stft_cfg) for x in wavs]
    mats = extract_decoder_mlp(model, l)

    @contextlib.contextmanager
    def chain_calls():
        """The (rows, WF mode) of every chain segment the engines run: the
        launches themselves are counted by the wrapper."""
        seen, real = [], mcem.run_mh_chain

        def spy(mats, x2, *args, **kw):
            seen.append((x2.shape[0], kw["wf_mode"]))
            return real(mats, x2, *args, **kw)

        mcem.run_mh_chain = spy
        try:
            yield seen
        finally:
            mcem.run_mh_chain = real

    # (EnhancerConfig fields, the chain segments the run must make)
    runs = {
        "pmcem": (dict(engine="pmcem"), [(r * rows, False)] * mc.niter + [(r * rows, True)]),
        "peem": (dict(engine="peem"), []),
        "peem-wf": (dict(engine="peem-wf"), [(rows, True)]),
        "clean-z": (dict(ablation="clean_z"), [(rows, False)] * mc.niter + [(rows, True)]),
        "clean-z-nomcem": (dict(ablation="clean_z_nomcem"), []),
    }

    def partition_err(out):
        worst = 0.0
        for (s, n_), x, fr in zip(out, wavs, frames):
            core = slice(nfft, min(len(x), (fr - 1) * hop + nfft) - nfft)
            worst = max(worst, float(np.abs(s + n_ - x)[core].max()) / float(np.abs(x).max()))
        return worst

    # ---- 10a. each engine and ablation once, counts from 0 around the path
    pmcem_launches = 0
    for name, (fields, want) in runs.items():
        enh = Enhancer(model, EnhancerConfig(mcem=mc, wire_dtype="float32",
                                             noise_from_partition=False, **fields))
        mh_chain.launches = mh_chain.launches_mma = 0
        with chain_calls() as seen:
            out = enh.enhance_batch(wavs, seed=SEED, clean_wavs=cleans)
        n_all, n_mma = mh_chain.launches, mh_chain.launches_mma
        part = partition_err(out)
        finite = all(np.isfinite(s).all() and np.isfinite(n_).all() and len(s) == len(x)
                     for (s, n_), x in zip(out, wavs)) and np.isfinite(enh.last_cost).all()
        log(f"phase 10: {name}: {n_all} mh_chain launches ({n_mma} of the bf16 body; "
            f"expected {len(want)}), segments at {sorted(set(seen))} rows / WF mode; cost "
            f"{enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}; outputs finite: {finite}; "
            f"Wiener partition max |s + n - x| / peak {part:.3e} (limit 1e-4)")
        check(n_all == n_mma == len(want) and seen == want, f"{name}: chain launches")
        check(finite and part < 1e-4, f"{name}: outputs finite, Wiener partition")
        if name == "pmcem":
            pmcem_launches = sum(not wf for _, wf in seen)

    v5 = init_xavier_(DisentangledVAE(513, 1, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    enh_v5 = Enhancer(v5, EnhancerConfig(mcem=mc, y_mode="dec_only", engine="pmcem"))
    mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
    with chain_calls() as seen:
        ys = self_soft_labels(enh_v5.model, wavs, stft_cfg, 1, "classify_from_x")
        out = enh_v5.enhance_batch(wavs, ys, seed=SEED)
    log(f"phase 10: M2-info pmcem, self-soft labels: {stft_power.launches} stft_power launch, "
        f"{mh_chain.launches} mh_chain launches ({mh_chain.launches_mma} bf16), segments at "
        f"{sorted(set(seen))}; cost {enh_v5.last_cost[0]:.5f} -> {enh_v5.last_cost[-1]:.5f}")
    check(stft_power.launches == 1 and mh_chain.launches == mc.niter + 1
          and seen == runs["pmcem"][1], "M2-info pmcem launches")
    check(all(np.isfinite(s).all() and np.isfinite(n_).all() for s, n_ in out)
          and np.isfinite(enh_v5.last_cost).all(), "M2-info pmcem outputs finite")

    # ---- 10b. frozen chains, kernel vs plain, at the main path's rows
    frozen = dataclasses.replace(mc, var_rw=0.0, niter=5)
    for name, fn in (("pmcem", run_pmcem), ("peem-wf", run_peem_wf)):
        with torch.inference_mode():
            rk = fn(mats, x2b, z0b, maskb, SEED, frozen)
            with plain_chain():
                rp = fn(mats, x2b, z0b, maskb, SEED, frozen)
        sync()
        mask_err, cost_err, part = frozen_agreement(rk, rp, maskb)
        log(f"phase 10: {name} frozen, niter {frozen.niter}, kernel vs plain: max mask diff "
            f"{mask_err:.3e} (limit 1e-3), max cost rel diff {cost_err:.3e} (limit 1e-4), "
            f"|WFs + WFn - 1| <= {part:.3e} on valid frames (limit 1e-5)")
        check(mask_err < 1e-3 and cost_err < 1e-4 and part < 1e-5,
              f"{name} frozen: kernel vs plain")

    # ---- 10c. times
    def walls(fn, n=3):
        out = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append(time.perf_counter() - t0)
        return out

    medians = {}
    for name, (fields, _) in runs.items():
        enh = Enhancer(model, EnhancerConfig(mcem=mc, **fields))
        w = walls(lambda: enh.enhance_batch(wavs, seed=SEED, clean_wavs=cleans))
        medians[name] = med = float(np.median(w))
        log(f"phase 10: enhance_batch B={B} {name} wall {', '.join(f'{t:.4f}' for t in w)} s "
            f"(median {med:.4f} s, {B / med:.2f} utt/s; mcem in phase 4 {m1_wall:.4f} s, "
            f"ratio {med / m1_wall:.4f}) {tag}")
    with torch.inference_mode():
        loop = [float(np.median(walls(lambda: run_peem(mats, x2b, z0b, maskb, SEED,
                                                       dataclasses.replace(mc, peem_steps=k)))))
                for k in (mc.peem_steps, 0)]
    log(f"phase 10: run_peem at the full budget {loop[0]:.4f} s, with peem_steps=0 "
        f"{loop[1]:.4f} s: the Adam loop takes {loop[0] - loop[1]:.4f} s, "
        f"{100 * (loop[0] - loop[1]) / medians['peem']:.1f}% of peem's enhance_batch {tag}")

    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), b, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    vb_r = compute_vb(w_, h_).reshape(rows, f)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    h1, h2 = mats[0].shape[1], mats[3].shape[1]

    def segment(rep, z, n_burn, n_samp, wf):
        """A main-path segment at ``rep`` copies of the batch's rows: times,
        bound and the frozen segment's kernel-vs-plain error."""
        planes = (x2b.reshape(rows, f).repeat(rep, 1), vb_r.repeat(rep, 1),
                  g_.reshape(rows).repeat(rep))
        rr = rep * rows
        noise = make_chain_noise(n_burn + n_samp, rr, l, gen, dev)
        args = (mats, *planes, z.reshape(rr, l).contiguous(), None, noise, n_burn, n_samp,
                mc.var_rw, wf, True)
        k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
        p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
        b_ms, b_by = chain_bound_ms(chain_work(rr, f, l, h1, h2, n_burn, n_samp, wf), True)
        fargs = (*args[:9], 0.0, wf, True)
        got, ref = run_mh_chain(*fargs)[1], mh_chain_reference(*fargs)[1]
        sync()
        said = agree(got, ref, True, 1e-5, f"frozen segment at {rr} rows, WF {wf}")
        return k_ms, p_ms, b_ms, b_by, float((got - ref).abs().max()), said

    z_r = z0b[None] + math.sqrt(mc.var_rw) * torch.randn((r, b, n_pad, l), generator=gen,
                                                         device=dev)
    entries = []
    for name, rep, z, n_burn, n_samp, wf, n in (
            (f"pmcem E-step, {r * rows:,} rows", r, z_r, mc.pmcem_steps - 1, 1, False,
             pmcem_launches),
            (f"pmcem WF, {r * rows:,} rows", r, z_r, mc.pmcem_wf_burn, -(-mc.nsamples_wf // r),
             True, 1),
            ("peem-wf WF", 1, run_peem(mats, x2b, z0b, maskb, SEED, mc).z, mc.burnin_wf,
             mc.nsamples_wf, True, 1)):
        k_ms, p_ms, b_ms, b_by, err, said = segment(rep, z, n_burn, n_samp, wf)
        log(f"phase 10: mh_chain bf16 body, {name} segment steps={n_burn}+{n_samp}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, kernel at "
            f"{100 * b_ms / k_ms:.2f}% of bound; frozen segment kernel vs plain: max abs err "
            f"{err:.3e}, {said} {tag}")
        if not name.startswith("pmcem WF"):
            entries.append({"name": f"mh_chain ({name})", "route": "cuda",
                            "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                            "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n,
                            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None})

    # ---- 10d. the NTCD sweep CLIs end to end on a synthetic tree
    noisy = sweep_tree(work, 16, SEED + 11)
    for name, m in (("m1", model), ("v5", v5)):
        torch.save(m.state_dict(), os.path.join(work, f"{name}.pt"))
    base = ["--data-root", os.path.join(work, "data"), "--snr", "all", "--batch-size", "16",
            "--niter", str(mc.niter)]
    want = sorted(f"{os.path.splitext(p)[0]}{k}.wav" for p in noisy for k in ("_s_est", "_n_est"))

    def cli(main, ckpt, out, *extra):
        mh_chain.launches = stft_power.launches = 0
        t0 = time.perf_counter()
        n_done = main([*base, "--checkpoint", os.path.join(work, ckpt),
                       "--output-dir", os.path.join(work, out), *extra])
        wall = time.perf_counter() - t0
        files = sorted(os.path.relpath(os.path.join(d, x), os.path.join(work, out))
                       for d, _, xs in os.walk(os.path.join(work, out)) for x in xs)
        return n_done, files, mh_chain.launches, stft_power.launches, wall

    batches = -(-len(noisy) // 16)
    n_done, files, n_chain, _, wall = cli(evaluate_ntcd_m1.main, "m1.pt", "m1")
    log(f"phase 10: evaluate_ntcd_m1 over {len(noisy)} utterances: {n_done} enhanced, "
        f"{len(files)} files, {n_chain} mh_chain launches, {wall:.2f} s")
    check(n_done == len(noisy) and files == want and n_chain == batches * (mc.niter + 1),
          "evaluate_ntcd_m1: reference layout and launches")
    n_again = cli(evaluate_ntcd_m1.main, "m1.pt", "m1")[0]
    check(n_again == 0, f"resume-by-skip enhanced {n_again}")
    n_done, files, n_chain, _, _ = cli(evaluate_ntcd_m1.main, "m1.pt", "nomcem",
                                       "--ablation", "clean-z-nomcem")
    check(n_done == len(noisy) and n_chain == 0
          and files == sorted(p.replace("_s_est", "_clean_z_nomcem_s_est")
                              .replace("_n_est", "_clean_z_nomcem_n_est") for p in want),
          "clean-z-nomcem golden names")
    parts = [cli(evaluate_ntcd_m1.main, "m1.pt", f"shard{k}", "--shard", f"{k}/2",
                 "--engine", "peem") for k in range(2)]
    check(sorted(parts[0][1] + parts[1][1]) == want and not set(parts[0][1]) & set(parts[1][1]),
          "two shards cover the list once")
    n_done, files, n_chain, n_stft, wall = cli(
        evaluate_ntcd_m2_info_vad.main, "v5.pt", "v5", "--y-source", "self-soft",
        "--engine", "pmcem")
    log(f"phase 10: evaluate_ntcd_m2_info_vad --y-source self-soft --engine pmcem: {n_done} "
        f"enhanced, {n_stft} stft_power launches (one per utterance), {n_chain} mh_chain "
        f"launches, {wall:.2f} s; evaluate_ntcd_m1 resume enhanced 0, clean-z-nomcem wrote "
        f"the golden names with 0 chain launches, shards 0/2 + 1/2 wrote "
        f"{len(parts[0][1])} + {len(parts[1][1])} files")
    check(n_done == len(noisy) and n_stft == len(noisy) and n_chain == batches * (mc.niter + 1)
          and files == sorted(p.replace(".wav", "_y_hat_soft.wav") for p in want),
          "evaluate_ntcd_m2_info_vad self-soft pmcem")

    return entries


def peem_profile(mats, batch, mc, tag: str) -> None:
    """Phase 10's last step, run last in the script (host timings taken
    after the profiler ran slower): PEEM's device time against its wall
    time, under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvae_tpu_torch.enhance.mcem import run_peem

    sync = torch.cuda.synchronize
    x2b, z0b, maskb = batch
    short = dataclasses.replace(mc, niter=10)
    with torch.inference_mode():
        run_peem(mats, x2b, z0b, maskb, SEED, short)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_peem(mats, x2b, z0b, maskb, SEED, short)
            sync()
            wall = time.perf_counter() - t0
    # the kernels' own events (a CPU op's device time counts the same kernels)
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    device_s = sum(k[0] for k in kernels) / 1e6
    if device_s > 0:
        top = "; ".join(f"{k} x{c} {us / 1e3:.3f} ms" for us, c, k in sorted(kernels)[::-1][:6])
        log(f"phase 10: run_peem niter {short.niter} under the profiler: wall {wall:.4f} s, "
            f"device busy {device_s:.4f} s, idle share {100 * (1 - device_s / wall):.1f}%; "
            f"largest: {top} {tag}")
    else:
        log("phase 10: run_peem under the profiler: no device time in the trace, idle share "
            "not measured")


def serving_phase(model, wavs, cuda_ms, plain_chain, agree, tag: str, work: str) -> list:
    """Phase 11 on the card: the HTTP enhancement server and long-form
    enhancement on the phase-3 M1 model (a copy) and mixtures at the full
    budget; returns the kernels-line entries of the served path."""
    import copy
    import io
    import signal
    import socket
    import threading
    import urllib.request

    import torch

    from dvae_tpu_torch.cli import enhance_wav
    from dvae_tpu_torch.data.io import read_wav, write_wav
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.longform import chunk_spans
    from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed
    from dvae_tpu_torch.enhance.mh_chain import make_chain_noise, mh_chain_reference, run_mh_chain
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import DisentangledVAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped, pad_signal, stft_realimag
    from dvae_tpu_torch.serving import EnhanceService, ServeConfig, make_server
    from dvae_tpu_torch.serving.metrics import _PROM_COUNTERS
    from dvae_tpu_torch.serving.wire import _parse_wav_bytes, _wav_bytes

    dev, sync, clock = torch.device("cuda"), torch.cuda.synchronize, time.perf_counter
    stft_cfg, mc, bsz = StftConfig(), McemConfig(), 8
    want, nfft, hop = mc.niter + 1, stft_cfg.nfft, stft_cfg.hop

    def body(x):
        """``x`` as a client posts it: a PCM16 RIFF file."""
        return _wav_bytes([x], FS)

    def sent(x):
        """What the server decodes from ``body(x)``."""
        return _parse_wav_bytes(body(x))[0].astype(np.float32)

    def post(url, data, timeout=300):
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()

    def get(url, timeout=60):
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()

    def partition(s, n, x, pcm=True):
        """max |s + n - x| on the covered core over its limit (<= 1 passes):
        phase 3's 1e-4 of the peak, plus one PCM16 step for a wav response
        (speech and noise are each rounded to the grid once)."""
        fr = n_stft_frames_clamped(len(x), stft_cfg)
        core = slice(nfft, min(len(x), (fr - 1) * hop + nfft) - nfft)
        limit = 1e-4 * float(np.abs(x).max()) + (1.0 / 32768 if pcm else 0.0)
        if not len(s) == len(n) == len(x):
            return math.inf
        return float(np.abs(s + n - x)[core].max()) / limit

    def stereo_partition(resp, x):
        both = read_wav(io.BytesIO(resp))[0]
        return partition(both[:, 0], both[:, 1], x)

    def settle(service):
        """Wait until every admitted item is fully processed (the worker
        counts a batch after it answers the waiters)."""
        deadline = clock() + 60
        while service._unfinished and clock() < deadline:
            time.sleep(0.005)

    def burst(service, base, reqs):
        """``reqs`` posted at once from one thread each; checks every answer
        and the launches, returns the chain launches and the line to log."""
        get(f"{base}/healthz")  # builds urllib's opener once, outside the timing
        bodies = [body(x) for x in reqs]
        st0 = service.stats_snapshot()
        results, lat = [None] * len(reqs), [0.0] * len(reqs)
        start = threading.Barrier(len(reqs))

        def client(i):
            start.wait(timeout=60)
            t = clock()
            results[i] = post(f"{base}/enhance?return=stereo", bodies[i])
            lat[i] = clock() - t

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        mh_chain.launches = mh_chain.launches_mma = 0
        t0 = clock()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = clock() - t0
        n_chain, n_served = mh_chain.launches, mh_chain.launches_mma
        settle(service)
        st = service.stats_snapshot()
        batches = st["batches"] - st0["batches"]
        check(all(r is not None and r[0] == 200 for r in results), "16 requests answered 200")
        worst = max(stereo_partition(r[1], sent(x)) for r, x in zip(results, reqs))
        check(worst <= 1.0, f"served Wiener partition at {worst} of its limit")
        check(batches <= 3 and n_chain == n_served == batches * want,
              f"{batches} batches, {n_served} bf16 launches of {n_chain}")
        busy = st["busy_seconds"] - st0["busy_seconds"]
        q = st["latency_seconds"]
        audio = sum(len(x) for x in reqs) / FS
        return n_served, (
            f"all 200 in {batches} batches, {n_served} bf16-body chain launches (expected "
            f"{batches} x {want}); wall {wall:.4f} s, {len(reqs) / wall:.3f} requests/s, "
            f"{audio / wall:.2f} audio s per s; /stats latency p50 {q['p50']} p90 {q['p90']} "
            f"p99 {q['p99']} s; client p50 {np.percentile(lat, 50):.4f} p95 "
            f"{np.percentile(lat, 95):.4f} s; busy_seconds {busy:.4f} over the wall: "
            f"{busy / wall:.3f}; Wiener partition max |s + n - x| at {worst:.3f} of its limit "
            f"(1e-4 of the peak + 1 PCM16 step)")

    # ---- 11a. service, server, warmup. Chunks of 6 s: the ~5.1 s mixtures
    # ride as one item each (a 4 s chunk would split each into two items of
    # the 256 bucket); the 30 s request splits into 6 s chunks
    cfg = ServeConfig(batch_size=bsz, batch_window_ms=25.0, chunk_seconds=6.0,
                      warmup_buckets=(320,))
    svc = EnhanceService(copy.deepcopy(model), "m1", EnhancerConfig(), cfg)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        t0 = clock()
        svc.warmup()
        warm = clock() - t0
        check(svc.warm_buckets == [320] and svc.ready.is_set(), "warmup of the 320 bucket")
        log(f"phase 11: EnhanceService M1 (batch 8, window 25 ms, chunk 6 s) on {svc.device}: "
            f"warmup of the 320-frame bucket {warm:.4f} s (one batch of {want} chain "
            f"launches; the kernels were built in phase 1) {tag}")

        # ---- 11b. 16 concurrent requests; counts from 0 around the path
        reqs = wavs[:16]
        n_served, said_pipelined = burst(svc, url, reqs)
        log(f"phase 11: 16 concurrent POST /enhance?return=stereo (phase-3 mixtures, "
            f"{sum(len(x) for x in reqs) / FS:.1f} s of audio), 2-deep pipelined worker: "
            f"{said_pipelined} {tag}")

        # ---- 11c. one 30 s request, streamed
        long_x = np.concatenate(wavs)[:30 * FS]
        n_chunks = len(chunk_spans(len(long_x), FS, hop, cfg.chunk_seconds,
                                   min(1.0, cfg.chunk_seconds / 4)))
        st0 = svc.stats_snapshot()
        mh_chain.launches = 0
        req = urllib.request.Request(f"{url}/enhance?stream=1&return=stereo",
                                     data=body(long_x), method="POST")
        t0 = clock()
        with urllib.request.urlopen(req, timeout=300) as r:
            first = r.read(48)       # the RIFF header and the first stereo frame
            t_first = clock() - t0
            resp = first + r.read()
            t_last = clock() - t0
            status, clen = r.status, int(r.headers["Content-Length"])
        st = svc.stats_snapshot()
        batches_long = st["batches"] - st0["batches"]
        part = stereo_partition(resp, sent(long_x))
        check(status == 200 and len(resp) == clen == 44 + 4 * len(long_x),
              f"stream length {len(resp)} / {clen} for {len(long_x)} samples")
        check(part <= 1.0 and mh_chain.launches == batches_long * want
              and st["utterances"] - st0["utterances"] == n_chunks, "30 s streamed request")
        log(f"phase 11: POST /enhance?stream=1 of a 30 s mixture: {n_chunks} chunks of 6 s in "
            f"{batches_long} batches ({mh_chain.launches} chain launches), exact length "
            f"{len(long_x)} samples; first body bytes after {t_first:.4f} s, last after "
            f"{t_last:.4f} s; Wiener partition at {part:.3f} of its limit {tag}")

        # ---- 11e. hot reload of perturbed weights, then a request
        pert = copy.deepcopy(model).cpu()
        gen = torch.Generator().manual_seed(SEED + 12)
        with torch.no_grad():
            for p in pert.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
        ckpt = os.path.join(work, "m1_perturbed.pt")
        torch.save(pert.state_dict(), ckpt)
        try:
            status, _ = post(f"{url}/reload?checkpoint={ckpt}", b"")
        finally:
            os.remove(ckpt)
        served = svc.enhancer.model.state_dict()
        same = all(torch.equal(served[k].cpu(), v) for k, v in pert.state_dict().items())
        status2, resp = post(f"{url}/enhance?return=stereo", body(wavs[16]))
        check(status == 200 and svc.stats_snapshot()["reloads"] == 1 and same,
              "hot reload applied")
        check(status2 == 200 and stereo_partition(resp, sent(wavs[16])) <= 1.0,
              "request after the reload")
        log("phase 11: POST /reload of perturbed weights: 200, reloads 1, the served weights "
            "are the checkpoint's; the next request answered 200 with the Wiener partition")

        # ---- 11f. status endpoints
        health = json.loads(get(f"{url}/healthz"))
        metrics = get(f"{url}/metrics").decode()
        check(health["platform"] == "gpu" and health["ready"] is True
              and health["status"] == "ok", f"/healthz {health}")
        check(all(f"\n{name} " in metrics for _, name, _ in _PROM_COUNTERS)
              and "\ndvae_ready 1\n" in metrics, "/metrics carries the service counters")
        log(f"phase 11: /healthz status {health['status']}, platform {health['platform']}, "
            f"warm buckets {health['warm_buckets']}; /metrics {len(metrics.splitlines())} "
            f"lines, requests_total {svc.stats_snapshot()['requests']}")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)

    # ---- 11b, again: the same burst against a strictly sequential worker
    seq = EnhanceService(copy.deepcopy(model), "m1", EnhancerConfig(),
                         dataclasses.replace(cfg, pipeline_dispatch=False))
    seq_srv = make_server(seq, "127.0.0.1", 0)
    seq_thread = threading.Thread(target=seq_srv.serve_forever, daemon=True)
    seq_thread.start()
    try:
        seq.warmup()
        _, said = burst(seq, f"http://127.0.0.1:{seq_srv.server_address[1]}", reqs)
        log(f"phase 11: the same 16 requests, sequential worker (pipeline_dispatch=False): "
            f"{said} {tag}")
    finally:
        seq_srv.shutdown()
        seq_srv.server_close()
        seq.close()
        seq_thread.join(timeout=10)

    # ---- 11d. a frozen served batch against the plain chain, both bodies
    for fast in (True, False):
        fcfg = EnhancerConfig(mcem=McemConfig(var_rw=0.0, fast_decoder=fast),
                              noise_from_partition=False, wire_dtype="float32")
        fsvc = EnhanceService(copy.deepcopy(model), "m1", fcfg,
                              ServeConfig(batch_size=bsz, batch_window_ms=1000.0,
                                          warmup_buckets=()))
        try:
            items = [fsvc._admit(x, "self-soft", True) for x in wavs[:bsz]]  # in batch order
            out_k = [fsvc._await(it, 600) for it in items]
            check(fsvc.stats_snapshot()["batches"] == 1, "frozen requests in one batch")
        finally:
            fsvc.close()
        with plain_chain():
            out_p = fsvc.enhancer.enhance_batch(wavs[:bsz], seed=fold_seed(cfg.seed, 0))
        wave_err = part_err = 0.0
        for (sk_, nk_), (sp_, _), xx in zip(out_k, out_p, wavs):
            fr = n_stft_frames_clamped(len(xx), stft_cfg)
            core = slice(nfft, min(len(xx), (fr - 1) * hop + nfft) - nfft)
            peak = float(np.abs(xx).max())
            wave_err = max(wave_err, float(np.abs(sk_ - sp_)[core].max()) / peak)
            part_err = max(part_err, float(np.abs(sk_ + nk_ - xx)[core].max()) / peak)
        log(f"phase 11: {'bf16' if fast else 'f32'} frozen chain, a served batch of 8 against "
            f"the same batch through enhance_batch with the plain chain: max |s_k - s_p| / peak "
            f"{wave_err:.3e} (limit 1e-3), Wiener partition {part_err:.3e} (limit 1e-4)")
        check(wave_err < 1e-3 and part_err < 1e-4, f"served frozen batch, fast={fast}")

    # ---- 11g. the conditional service: M2-info with self-soft labels
    v5 = init_xavier_(DisentangledVAE(513, 1, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    csvc = EnhanceService(v5, "v5", EnhancerConfig(y_mode="dec_only"),
                          ServeConfig(batch_size=bsz, warmup_buckets=()))
    try:
        outs = [None] * bsz

        def submit(i):
            outs[i] = csvc.submit(wavs[i], timeout=600)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(bsz)]
        mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        n_chain, n_cond, n_stft = mh_chain.launches, mh_chain.launches_mma, stft_power.launches
        batches_v5 = csvc.stats_snapshot()["batches"]
    finally:
        csvc.close()
    check(all(o is not None and partition(o[0], o[1], x, pcm=False) <= 1.0
              for o, x in zip(outs, wavs)), "M2-info served outputs, Wiener partition")
    check(n_stft == batches_v5 and n_chain == n_cond == batches_v5 * want,
          f"M2-info: {n_stft} stft_power, {n_chain} chain launches in {batches_v5} batches")
    log(f"phase 11: M2-info DisentangledVAE(513, 1, 16, (128, 128)) service, self-soft labels: "
        f"8 requests in {batches_v5} batch(es), {n_stft} stft_power launch(es) (one per batch), "
        f"{n_cond} conditioned bf16-body chain launches (expected {batches_v5} x {want})")
    t_max = max(len(x) for x in wavs[:bsz])
    batch = np.stack([np.pad(x, (0, t_max - len(x))) for x in wavs[:bsz]]).astype(np.float32)
    xp = pad_signal(torch.from_numpy(batch).to(dev), stft_cfg).contiguous()
    stft_entry = time_stft(xp, False, "serving self-soft", n_stft, cuda_ms, tag, phase=11)

    # ---- times: a served batch's dispatch and collect, a part-full batch,
    # and the chain's E-step segment at the served rows
    enh8 = Enhancer(copy.deepcopy(model), EnhancerConfig())
    full = list(wavs[:bsz])
    part_full = [wavs[0]] + [np.zeros(nfft, np.float32)] * (bsz - 1)  # 1 request + 7 fillers
    enh8.enhance_batch(full, seed=SEED)

    def split(ws):
        sync()
        t0 = clock()
        handle = enh8.dispatch(ws, seed=SEED)
        t1 = clock()
        enh8.collect(handle)
        return t1 - t0, clock() - t1

    split_full = np.median([split(full) for _ in range(3)], axis=0)
    split_part = np.median([split(part_full) for _ in range(3)], axis=0)
    d_s, c_s = split_full
    log(f"phase 11: a served batch (8 x 320 frames) through Enhancer.dispatch / collect "
        f"(medians of 3): dispatch returns after {d_s:.4f} s, collect then waits {c_s:.4f} s "
        f"for the card, so the worker's 2-deep pipeline can overlap at most {c_s:.4f} s of "
        f"the next batch's host work; the batch {d_s + c_s:.4f} s; 1 request + 7 fillers "
        f"{sum(split_part):.4f} s (dispatch {split_part[0]:.4f} s), ratio "
        f"{sum(split_part) / (d_s + c_s):.3f} of the full batch {tag}")

    xw, x_scale, _, _, mask, _, n_pad, _ = enh8._prepare(full, None, None)
    with torch.inference_mode():
        x = xw.to(dev).float() * x_scale.to(dev)[:, None]
        re, im = stft_realimag(x, stft_cfg)
        x2b = (re * re + im * im)[:, :n_pad].contiguous()
        z0b = enh8.model.encode(x2b, sample=False)[1]
    f, l = x2b.shape[-1], z0b.shape[-1]
    rows = bsz * n_pad
    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), bsz, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    vb_r = compute_vb(w_, h_).reshape(rows, f).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    n_burn, n_samp = mc.burnin_e_step, mc.nsamples_e_step
    noise = make_chain_noise(n_burn + n_samp, rows, l, gen, dev)
    args = (enh8.mats, x2b.reshape(rows, f), vb_r, g_.reshape(rows).contiguous(),
            z0b.reshape(rows, l).contiguous(), None, noise, n_burn, n_samp, mc.var_rw, False,
            True)
    k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
    p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
    h1, h2 = enh8.mats[0].shape[1], enh8.mats[3].shape[1]
    work_ = chain_work(rows, f, l, h1, h2, n_burn, n_samp, False)
    b_ms, b_by = chain_bound_ms(work_, True)
    fargs = (*args[:9], 0.0, False, True)
    _, sk = run_mh_chain(*fargs)
    _, sr = mh_chain_reference(*fargs)
    sync()
    err = float((sk - sr).abs().max())
    said = agree(sk, sr, True, 1e-5, "frozen segment at the served rows")
    log(f"phase 11: mh_chain bf16 body, E-step segment at the served rows ({bsz} x {n_pad} = "
        f"{rows}) steps={n_burn}+{n_samp}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({work_[3] / 1e6:.1f} MB), kernel at "
        f"{100 * b_ms / k_ms:.2f}% of bound; frozen segment kernel vs plain: max abs err "
        f"{err:.3e}, {said} {tag}")
    served_entry = {"name": "mh_chain (serving)", "route": "cuda",
                   "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                   "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n_served,
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}

    # ---- 11h. the serving CLI as a subprocess: boot, one request, SIGTERM
    ckpt = os.path.join(work, "m1.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    t0 = clock()
    proc = subprocess.Popen([sys.executable, "-m", "dvae_tpu_torch.cli.serve", "--checkpoint",
                             ckpt, "--port", str(port)],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        health = {}
        while clock() - t0 < 240 and proc.poll() is None:
            try:
                health = json.loads(get(f"{base}/healthz", timeout=5))
                if health.get("ready"):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        t_ready = clock() - t0
        check(health.get("ready") is True and health.get("platform") == "gpu",
              f"cli.serve ready: {health}, exit {proc.poll()}")
        status, resp = post(f"{base}/enhance?return=stereo", body(wavs[17]))
        check(status == 200 and stereo_partition(resp, sent(wavs[17])) <= 1.0,
              "cli.serve answered")
        t1 = clock()
        proc.send_signal(signal.SIGTERM)
        out, err_txt = proc.communicate(timeout=120)
        t_exit = clock() - t1
        check(proc.returncode == 0 and "drained, stopping" in out,
              f"cli.serve exit {proc.returncode}: {err_txt[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    boot = health["boot"]
    phases = {k: v["dur_s"] for k, v in boot["phases"].items()}
    log(f"phase 11: python -m dvae_tpu_torch.cli.serve --checkpoint <m1.pt>: /healthz ready "
        f"{t_ready:.2f} s after spawn (boot phases {phases} s, port bound at "
        f"{boot['marks'].get('port_bound')} s after process start), one request answered, "
        f"SIGTERM drained and exited 0 in {t_exit:.2f} s {tag}")

    # ---- 11i. the long-form CLI on a 30 s file
    long_dir = os.path.join(work, "long")
    os.makedirs(long_dir)
    write_wav(os.path.join(long_dir, "long.wav"), long_x, FS)
    mh_chain.launches = 0
    t0 = clock()
    enhance_wav.main([long_dir, "--checkpoint", ckpt, "--chunk-seconds", "4",
                      "--output-dir", os.path.join(work, "long_out")])
    wall_cli = clock() - t0
    x_file = read_wav(os.path.join(long_dir, "long.wav"))[0]
    s = read_wav(os.path.join(work, "long_out", "long_s_est.wav"))[0]
    n = read_wav(os.path.join(work, "long_out", "long_n_est.wav"))[0]
    groups = -(-len(chunk_spans(len(x_file), FS, hop, 4.0, 1.0)) // 4)
    part = partition(s, n, x_file)
    check(part <= 1.0 and mh_chain.launches == groups * want,
          f"enhance_wav --chunk-seconds 4: partition {part}, {mh_chain.launches} launches")
    log(f"phase 11: enhance_wav --chunk-seconds 4 on a 30 s wav: {groups} dispatches of up to "
        f"4 chunks, {mh_chain.launches} chain launches, {wall_cli:.3f} s with the wav I/O; "
        f"Wiener partition at {part:.3f} of its limit {tag}")
    return [served_entry, stft_entry]


def gated(clean: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """``clean`` switched off in 0.2-0.8 s stretches, so that a VAD finds
    frames without speech (its length, and so its frame count, kept)."""
    edges = np.cumsum(rng.uniform(0.2, 0.8, 16) * FS).astype(int)
    return (clean * (np.searchsorted(edges, np.arange(len(clean)), side="right") % 2 == 0)
            ).astype(np.float32)


def labelled_training_phase(wavs, cleans, cuda_ms, agree, tag: str, work: str) -> list:
    """Phase 12 on the card: labelled frame sets through B2, the conditional
    trainers at full width, and two trained priors served through B1;
    returns the kernels-line entries of this path."""
    import itertools

    import torch

    from dvae_tpu_torch.data.builders import DEFAULT_STFT, build_frames, padded_batch
    from dvae_tpu_torch.data.datasets import FrameDataset
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.labeling import self_soft_labels
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, VAE, CVAE_v3, CVAE_v4, DisentangledVAE
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
    from dvae_tpu_torch.ops.stft import power_spectrogram as plain_power
    from dvae_tpu_torch.ops.targets import clean_speech_ibm, clean_speech_vad
    from dvae_tpu_torch.train import checkpoint as ckpt
    from dvae_tpu_torch.train import loop
    from dvae_tpu_torch.train.loop import LoopConfig, fit_adversarial, fit_semisup, fit_vae
    from dvae_tpu_torch.train.steps import (
        adam,
        init_adversarial_state,
        make_adversarial_step,
        make_semisup_step,
        make_train_step,
    )

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    # phase 6's utterances (so its frame-set sizes), gated
    rng, gate_rng = np.random.default_rng(SEED + 1), np.random.default_rng(SEED + 12)
    clean_train = [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_TRAIN_UTTS)]
    clean_valid = [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_VALID_UTTS)]

    # ---- 12a. labelled frame sets, one B2 launch each, labels against the
    # plain path on the card
    def plain_labels(utts, counts, labels):
        """Each utterance alone: the port's clean_speech_vad of its padded
        signal, or clean_speech_ibm of the plain matmul-DFT magnitude, with
        the plain dB value's distance to its threshold."""
        ys, margins = [], []
        for u, n in zip(utts, counts):
            x = (u.astype(np.float64) / np.abs(u).max()).astype(np.float32)  # as build_frames
            x = torch.from_numpy(x).to(dev)
            if labels == "vad_labels":
                ys.append(clean_speech_vad(x, DEFAULT_STFT)[:n, None])
                continue
            mag = torch.sqrt(plain_power(x, DEFAULT_STFT))
            db = 20.0 * torch.log10(mag + 1e-8)
            ys.append(clean_speech_ibm(mag)[:n])
            margins.append((db - (db.max() - 50.0))[:n])
        cat = lambda t: torch.cat(t).cpu().numpy()  # noqa: E731
        return cat(ys), (cat(margins) if margins else None)

    sets, n_build = {}, 0
    for labels in ("vad_labels", "ibm_labels"):
        stft_power.launches = 0
        t0 = time.perf_counter()
        tr = build_frames(clean_train, labels=labels)
        va = build_frames(clean_valid, labels=labels)
        t_build = time.perf_counter() - t0
        n = stft_power.launches
        n_build += n
        check(n == 2, f"{n} stft_power launches for 2 labelled frame sets")
        check(np.isfinite(tr.x).all() and np.isfinite(tr.y).all() and (tr.std > 0).all(),
              f"{labels} frame set finite")
        n_off, n_bins, worst = 0, 0, 0.0
        for fs, utts in ((tr, clean_train), (va, clean_valid)):
            want_y, margin = plain_labels(utts, fs.counts, labels)
            check(want_y.shape == fs.y.shape, f"{labels} shape {fs.y.shape}")
            off = fs.y != want_y
            n_off, n_bins = n_off + int(off.sum()), n_bins + off.size
            if labels == "vad_labels":
                check(not off.any(), f"VAD labels differ from the plain path on {off.sum()} frames")
            elif off.any():
                worst = max(worst, float(np.abs(margin[off]).max()))
        if labels == "ibm_labels":
            check(n_off <= 1e-4 * n_bins and worst < 1e-3,
                  f"IBM labels: {n_off} of {n_bins} bins differ, up to {worst:.3e} dB off")
        sets[labels] = (FrameDataset.from_arrays(tr.x, tr.y, tr.mean, tr.std),
                        FrameDataset.from_arrays(va.x, va.y))
        log(f"phase 12: {labels} frame sets {tr.x.shape} + {va.x.shape}, labels {tr.y.shape} "
            f"({100 * tr.y.mean():.2f}% on), in {t_build:.3f} s, {n} stft_power launches (one "
            f"per frame set); against the plain path on the card: {n_off} of {n_bins} labels "
            f"differ" + (f", each within {worst:.3e} dB of its threshold (limit 1e-3 dB, "
                         f"share limit 1e-4)" if labels == "ibm_labels" else " (exact)"))

    # ---- 12b. five trainings, 3 epochs each
    cfg = LoopConfig(batch_size=128, learning_rate=1e-4, end_epoch=M1_EPOCHS + 1, seed=SEED)
    published = dict(alpha=0.0, beta=10.0, gamma=1.0)  # training_M2_info_vad.py:19-21
    runs = {
        "M2_VAD": (lambda: CVAE(513, 1, 16, (128, 128)), "vad_labels", "elbo",
                   lambda m, tr, va, d: fit_vae(m, tr, va, d, "M2_VAD", conditional=True,
                                                cfg=cfg)),
        "M2_IBM": (lambda: CVAE(513, 513, 16, (128, 128)), "ibm_labels", "elbo",
                   lambda m, tr, va, d: fit_vae(m, tr, va, d, "M2_IBM", conditional=True,
                                                cfg=cfg)),
        "M2_info": (lambda: DisentangledVAE(513, 1, 16, (128, 128)), "vad_labels", "enc",
                    lambda m, tr, va, d: fit_adversarial(m, tr, va, d, "M2_info", cfg=cfg,
                                                         **published)),
        "M2v4_hardlabel": (lambda: CVAE_v4(513, 1, 16, (128, 128)), "vad_labels", "enc",
                           lambda m, tr, va, d: fit_adversarial(
                               m, tr, va, d, "M2v4_hardlabel", cfg=cfg, y_cond="hardlabel",
                               **published)),
        "M2v3_Uloss": (lambda: CVAE_v3(513, 1, 16, (128, 128)), "vad_labels", "loss",
                       lambda m, tr, va, d: fit_semisup(m, tr, va, d, "M2v3_Uloss", "uloss",
                                                        10.0, cfg=cfg)),
    }
    best = {}
    for name, (make, labels, vkey, fit) in runs.items():
        model_dir = os.path.join(work, name)
        train_ds, valid_ds = sets[labels]
        t0 = time.perf_counter()
        _, hist = fit(make(), train_ds, valid_ds, model_dir)
        wall = time.perf_counter() - t0
        vals = [v for h in hist for part in ("train", "valid") for v in h[part].values()]
        check(np.isfinite(vals).all(), f"{name}: metrics not finite")
        pts = ckpt.checkpoints(model_dir, f"{name}_epoch_*.pt")
        check(len(pts) == M1_EPOCHS, f"{name}: {len(pts)} .pt files for {M1_EPOCHS} epochs")
        curve = "elbo" if vkey != "loss" else "objective"  # the semisup step's ELBO term
        train_c = [round(h["train"][curve], 3) for h in hist]
        valid_c = [round(h["valid"][curve], 3) for h in hist]
        if vkey == "elbo":
            check(valid_c[-1] < valid_c[0], f"{name}: validation ELBO did not fall")
        elif vkey == "enc":
            check(train_c[-1] < train_c[0], f"{name}: the elbo metric did not fall")
        best[name] = ckpt.best_checkpoint(model_dir, name)
        steps = M1_EPOCHS * -(-len(train_ds) // cfg.batch_size)
        last = {k: round(v, 3) for k, v in hist[-1]["valid"].items()}
        log(f"phase 12: {name} on {labels}: {steps} steps in {wall:.3f} s; {curve} per epoch "
            f"train {train_c}, valid {valid_c}; valid {vkey} "
            f"{[round(h['valid'][vkey], 3) for h in hist]}; last valid {last}; "
            f"{len(pts)} .pt files, best {best[name].name}")

    # ---- 12c. the trained M2-info and M2 IBM priors, served
    mc = McemConfig()
    want = mc.niter + 1

    def served(model, y_mode, path, ys_fn, what):
        enh = Enhancer(model, EnhancerConfig(y_mode=y_mode))
        enh.reload(torch.load(path, map_location="cpu", weights_only=True))
        mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
        ys = ys_fn(enh)
        out = enh.enhance_batch(wavs, ys, seed=SEED)
        n_b1, n_mma, n_b2 = mh_chain.launches, mh_chain.launches_mma, stft_power.launches
        check(n_mma == n_b1 == want, f"{what}: {n_mma} bf16 body launches of {n_b1}, "
                                     f"expected {want}")
        check(len(out) == len(wavs) and np.isfinite(enh.last_cost).all() and all(
            np.isfinite(a).all() and np.isfinite(b).all() for a, b in out),
            f"{what}: outputs not finite")
        log(f"phase 12: {path.name} ({what}) enhanced the phase-3 batch through {n_mma} "
            f"bf16-body mh_chain launches (expected {want}) and {n_b2} stft_power; outputs "
            f"finite, cost {enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}")
        return enh, ys, n_b1, n_b2

    stft_cfg = StftConfig()
    enh_v5, ys_v5, b1_v5, b2_v5 = served(
        DisentangledVAE(513, 1, 16, (128, 128)), "dec_only", best["M2_info"],
        lambda enh: self_soft_labels(enh.model, wavs, stft_cfg, 1, "classify_from_x"),
        "M2-info, dec_only, self-soft labels")
    check(b2_v5 == 1, f"{b2_v5} stft_power launches for one self-soft batch")
    _, _, b1_ibm, _ = served(
        CVAE(513, 513, 16, (128, 128)), "enc_dec", best["M2_IBM"],
        lambda enh: [ibm_labels(c, n_stft_frames_clamped(len(c), stft_cfg)) for c in cleans],
        "M2, enc_dec, IBM labels of the clean parts")

    # ---- 12d. times: each train step at batch 128, host clock over an epoch
    # and CUDA events over 50 warm steps
    vad_train, _ = sets["vad_labels"]
    ibm_train, _ = sets["ibm_labels"]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def kinds():
        m1 = VAE(513, 16, (128, 128)).to(dev)
        yield "M1 ELBO", vad_train, make_train_step(m1, adam(m1.parameters()))
        m2 = CVAE(513, 1, 16, (128, 128)).to(dev)
        yield "M2 ELBO (VAD)", vad_train, make_train_step(m2, adam(m2.parameters()), True)
        m2i = CVAE(513, 513, 16, (128, 128)).to(dev)
        yield "M2 ELBO (IBM)", ibm_train, make_train_step(m2i, adam(m2i.parameters()), True)
        v5 = DisentangledVAE(513, 1, 16, (128, 128)).to(dev)
        yield "M2-info adversarial", vad_train, make_adversarial_step(
            v5, *init_adversarial_state(v5), **published)
        v3 = CVAE_v3(513, 1, 16, (128, 128)).to(dev)
        yield "M2v3 semisup (uloss)", vad_train, make_semisup_step(
            v3, adam(v3.parameters()), "uloss", 10.0)

    for name, ds, step in kinds():
        rows = loop._host_rows(ds, dev, labels=True)
        for x, y in itertools.islice(rows(128, np.random.default_rng(SEED), True), 20):
            step(x, y, generator=g)
        sync()
        t0, n_steps = time.perf_counter(), 0
        for x, y in rows(128, np.random.default_rng(SEED + 1), True):
            step(x, y, generator=g)
            n_steps += 1
        sync()
        host_ms = (time.perf_counter() - t0) / n_steps * 1e3
        x, y = next(rows(128))
        ev_ms = cuda_ms(lambda: step(x, y, generator=g), reps=50, warm=5)
        log(f"phase 12: {name} train step batch 128: {host_ms:.4f} ms host clock over an "
            f"epoch of {n_steps} host-fed steps ({1e3 / host_ms:.1f} steps/s), {ev_ms:.4f} ms "
            f"CUDA events over 50 warm steps on one batch {tag}")

    # ---- the kernels at this path's launches
    seg = conditioned_segment(enh_v5.mats, cond_batch_inputs(enh_v5, wavs, ys_v5), mc,
                              cuda_ms, agree)
    log(f"phase 12: mh_chain bf16 body, E-step segment of the trained M2-info (row bias (rows, "
        f"{seg['h1']})) rows={seg['rows']} steps={seg['steps']}: kernel {seg['k_ms']:.4f} ms, "
        f"plain {seg['p_ms']:.4f} ms, bound {seg['b_ms']:.4f} ms by {seg['b_by']}; frozen "
        f"segment kernel vs plain: max abs err {seg['max_abs']:.3e}, {seg['said']} {tag}")
    stft_entry = time_stft(padded_batch(clean_train)[0].to(dev), False, "labelled frame set",
                           n_build, cuda_ms, tag, phase=12)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all")
    return [chain_entry("mh_chain (trained conditional priors)", b1_v5 + b1_ibm, seg),
            stft_entry]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvae_tpu_torch.enhance import mcem, mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig, run_mcem
    from dvae_tpu_torch.enhance.mh_chain import (
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf, nmf_m_step
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import stft_realimag

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    tag = f"[{card}]"
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc each, together
        for built in [pool.submit(mh_chain.build_library), pool.submit(stft_power.build_library)]:
            built.result()
    log(f"phase 1: mh_chain (both bodies) and stft_power kernels built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel vs plain on the card, full width
    f, l = 513, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def chain_problem(rows, h_dim=(128, 128)):
        model = init_xavier_(VAE(f, l, h_dim), torch.Generator().manual_seed(SEED)).to(dev)
        x2 = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        vb = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        g = torch.rand((rows,), generator=gen, device=dev) + 0.5
        z0 = 0.1 * torch.randn((rows, l), generator=gen, device=dev)
        return extract_decoder_mlp(model, l), x2, vb, g, z0

    def rel_err(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    def bf16_rule(a, b):
        """(max rel err, share of elements within BF16_REL) of a vs b."""
        rel = (a - b).abs() / b.abs().clamp_min(1e-30)
        return float(rel.max()), float((rel < BF16_REL).float().mean())

    def agree(a, b, fast, rtol, what):
        """Kernel vs plain of its precision: rtol for the f32 body, the bf16
        rule for the tensor-core body. Returns the printed comparison."""
        if not fast:
            err = rel_err(a, b)
            check(err < rtol, what)
            return f"max rel err {err:.3e} (limit {rtol:g})"
        worst, share = bf16_rule(a, b)
        check(worst < BF16_MAX_REL and share >= BF16_SHARE, what)
        return (f"max rel err {worst:.3e} (limit {BF16_MAX_REL:g}), {share:.5f} of "
                f"elements within {BF16_REL:g} (limit {BF16_SHARE})")

    rows = 4000  # not a multiple of the 16-row tile
    mats, x2, vb, g, z0 = chain_problem(rows)
    noise = make_chain_noise(5, rows, l, gen, dev)
    sr32 = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0)[1]
    for fast in (False, True):
        name = "bf16" if fast else "f32"
        zk, sk = run_mh_chain(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, fast_decoder=fast)
        zr, sr = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0,
                                    fast_decoder=fast)
        sync()
        check(torch.equal(zk, z0), "frozen chain moved")
        log(f"phase 2: {name} body, frozen E-step chain, "
            + agree(sk, sr, fast, 1e-5, f"frozen chain: {name} kernel vs plain"))
        if fast:
            worst, share = bf16_rule(sk, sr32)
            log(f"phase 2: bf16 body against the f32 plain chain (no limit): max rel err "
                f"{worst:.3e}, {share:.5f} of elements within {BF16_REL:g}")

    for fast in (False, True):
        for wf in (False, True):
            for h_dim in ((128, 128), (128, 64)):
                mats_h, x2, vb, g, z0 = chain_problem(rows, h_dim)
                noise = make_chain_noise(12, rows, l, gen, dev)
                args = (mats_h, x2, vb, g, z0, None, noise, 6, 6, 0.01, wf, fast)
                zk, *ok = run_mh_chain(*args)
                zr, *orf = mh_chain_reference(*args)
                sync()
                same = (zk - zr).abs().amax(-1) < 1e-4
                moved = float((zk != z0).any(-1).float().mean())
                check(float(same.float().mean()) > 0.99 and moved > 0.5,
                      f"live chain fast={fast} wf={wf} H={h_dim}: rows that end at the same z")
                said = [agree(a[..., same, :], b[..., same, :], fast, 1e-4,
                              f"live chain fast={fast} wf={wf} H={h_dim}: kernel vs plain")
                        for a, b in zip(ok, orf)]
                log(f"phase 2: {'bf16' if fast else 'f32'} body, live {'WF' if wf else 'E-step'} "
                    f"chain H={h_dim}: {float(same.float().mean()):.4f} of rows end at the same "
                    f"z (limit 0.99), {moved:.3f} moved; on them {'; '.join(said)}")

    w1y = 0.3 * torch.randn((2, 128), generator=gen, device=dev)
    cmats = (mats[0], w1y, *mats[2:])
    y = torch.rand((rows, 2), generator=gen, device=dev)  # soft labels
    noise = make_chain_noise(1, rows, l, gen, dev)
    _, x2, vb, g, z0 = chain_problem(rows)
    for fast in (False, True):
        _, sk = run_mh_chain(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0, fast_decoder=fast)
        _, sr = mh_chain_reference(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0, fast_decoder=fast)
        sync()
        log(f"phase 2: {'bf16' if fast else 'f32'} body, conditioned row bias, "
            + agree(sk, sr, fast, 1e-5, f"conditioned chain fast={fast}: kernel vs plain"))
        for bad_mats, bad_y in ((cmats, None), (mats, y)):
            try:
                run_mh_chain(bad_mats, x2, vb, g, z0, bad_y, noise, 0, 1, 0.0, fast_decoder=fast)
            except ValueError as e:
                check("conditioning mismatch" in str(e), f"mismatch message: {e}")
            else:
                raise RuntimeError("conditioning mismatch did not raise")
    log("phase 2: conditioning mismatch raises both ways, in both bodies")
    sync()

    # ---- 3. the M1 Enhancer end to end
    model = init_xavier_(VAE(513, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    wavs = synthetic_wavs(np.random.default_rng(SEED))
    cfg = EnhancerConfig()
    check(cfg.mcem.fast_decoder, "the default config runs the bf16 body")
    enh = Enhancer(model, cfg)
    mh_chain.launches = mh_chain.launches_mma = 0
    t0 = time.perf_counter()
    out = enh.enhance_batch(wavs, seed=SEED)
    t_first = time.perf_counter() - t0
    launches, launches_mma = mh_chain.launches, mh_chain.launches_mma
    want = cfg.mcem.niter + 1
    log(f"phase 3: enhance_batch B={B} ran {launches_mma} launches of the bf16 "
        f"tensor-core body, {launches} mh_chain launches in all (expected niter + 1 = "
        f"{want}), first call {t_first:.3f} s")
    check(launches_mma == launches == want, f"{launches_mma} bf16 body launches of "
          f"{launches}, expected {want}")
    check(len(out) == B and all(len(s) == len(x) == len(n) for (s, n), x in zip(out, wavs)),
          "output count and lengths")
    check(all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out), "finite outputs")
    cost = enh.last_cost
    check(cost.shape == (cfg.mcem.niter,) and np.isfinite(cost).all(), "finite cost trajectory")
    log(f"phase 3: cost {cost[0]:.5f} -> {cost[-1]:.5f}, outputs finite")

    enh32 = Enhancer(model, EnhancerConfig(mcem=McemConfig(fast_decoder=False)))
    mh_chain.launches = mh_chain.launches_mma = 0
    out32 = enh32.enhance_batch(wavs, seed=SEED)
    launches_f32 = mh_chain.launches - mh_chain.launches_mma
    log(f"phase 3: enhance_batch with fast_decoder=False ran {launches_f32} launches of "
        f"the f32 body ({mh_chain.launches_mma} of the bf16 body); cost "
        f"{enh32.last_cost[0]:.5f} -> {enh32.last_cost[-1]:.5f}")
    check(launches_f32 == want and mh_chain.launches_mma == 0, "f32 body launch count")
    check(all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out32),
          "finite outputs, f32 body")

    # the padded batch as the main path sees it, for the comparisons and times
    xw, x_scale, _, _, mask, _, n_pad, frames = enh._prepare(wavs, None, None)
    with torch.inference_mode():
        x = xw.to(dev).float() * x_scale.to(dev)[:, None]
        re, im = stft_realimag(x, cfg.stft)
        x2b = (re * re + im * im)[:, :n_pad].contiguous()
        z0b = enh.model.encode(x2b, sample=False)[1]
    maskb = mask.to(dev)
    rows_main = B * n_pad

    @contextlib.contextmanager
    def plain_chain():
        """run_mcem's chain through the plain version, for the comparison only."""
        before = mh_chain.launches
        mcem.run_mh_chain = mh_chain_reference
        try:
            yield
        finally:
            mcem.run_mh_chain = run_mh_chain
        check(mh_chain.launches == before, "the plain run launched the kernel")

    for fast in (True, False):
        name = "bf16" if fast else "f32"
        frozen = McemConfig(var_rw=0.0, fast_decoder=fast)
        with torch.inference_mode():
            rk = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen)
            with plain_chain():
                rp = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen)
        sync()
        mask_err, cost_err, part = frozen_agreement(rk, rp, maskb)
        log(f"phase 3: {name} frozen-chain run_mcem kernel vs plain: max mask diff "
            f"{mask_err:.3e} (limit 1e-3), max cost rel diff {cost_err:.3e} (limit 1e-4), "
            f"|WFs + WFn - 1| <= {part:.3e} on valid frames (limit 1e-5)")
        check(mask_err < 1e-3 and cost_err < 1e-4 and part < 1e-5,
              f"{name} frozen run_mcem: kernel vs plain")

        # float32 wire, device-side noise estimate; compared where the ISTFT's
        # window normalizer is full (the first and last nfft samples of an
        # utterance divide by a normalizer down to ~1e-10, as in the reference)
        fcfg = EnhancerConfig(mcem=frozen, noise_from_partition=False, wire_dtype="float32")
        enh_k = Enhancer(model, fcfg)
        out_k = enh_k.enhance_batch(wavs, seed=SEED)
        with plain_chain():
            out_p = enh_k.enhance_batch(wavs, seed=SEED)
        wave_err, part_err = 0.0, 0.0
        nfft, hop = cfg.stft.nfft, cfg.stft.hop
        for (sk_, nk_), (sp_, _), xx, fr in zip(out_k, out_p, wavs, frames):
            peak = float(np.abs(xx).max())
            core = slice(nfft, min(len(xx), (fr - 1) * hop + nfft) - nfft)
            wave_err = max(wave_err, float(np.abs(sk_ - sp_)[core].max()) / peak)
            part_err = max(part_err, float(np.abs(sk_ + nk_ - xx)[core].max()) / peak)
        log(f"phase 3: {name} frozen-chain enhance_batch kernel vs plain: max |s_k - s_p| "
            f"/ peak {wave_err:.3e} (limit 1e-3); Wiener partition max |s + n - x| / peak "
            f"{part_err:.3e} on covered samples (limit 1e-4)")
        check(wave_err < 1e-3 and part_err < 1e-4,
              f"{name} frozen enhance_batch: kernel vs plain, partition")
        sync()

    # ---- 4. times at main-path shape
    def cuda_ms(fn, reps, warm=1):
        for _ in range(warm):
            fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    mc = cfg.mcem
    w, h, g = init_nmf(torch.Generator(device=dev).manual_seed(SEED), B, n_pad, f,
                       mc.nmf_rank, mc.eps, device=dev)
    vb_r = compute_vb(w, h).reshape(rows_main, f).contiguous()
    g_r = g.reshape(rows_main).contiguous()
    x2_r = x2b.reshape(rows_main, f)
    z_r = z0b.reshape(rows_main, l).contiguous()
    h1, h2 = enh.mats[0].shape[1], enh.mats[3].shape[1]
    times, max_abs = {}, {}
    for fast in (True, False):
        name = "bf16" if fast else "f32"
        for wf in (False, True):
            n_burn = mc.burnin_wf if wf else mc.burnin_e_step
            n_samp = mc.nsamples_wf if wf else mc.nsamples_e_step
            noise = make_chain_noise(n_burn + n_samp, rows_main, l, gen, dev)
            args = (enh.mats, x2_r, vb_r, g_r, z_r, None, noise, n_burn, n_samp, mc.var_rw,
                    wf, fast)
            k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
            p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
            work = chain_work(rows_main, f, l, h1, h2, n_burn, n_samp, wf)
            b_ms, b_by = chain_bound_ms(work, fast)
            times[fast, wf] = (k_ms, p_ms, b_ms, b_by)
            log(f"phase 4: mh_chain {name} body, {'WF' if wf else 'E-step'} segment "
                f"rows={rows_main} steps={n_burn}+{n_samp}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({work[0] / 1e9:.2f} GFLOP of "
                f"products at the {name} peak, {work[1] / 1e9:.3f} GFLOP elementwise, "
                f"{work[3] / 1e6:.1f} MB; {work[2]:.3e} exp + log + divide), kernel at "
                f"{100 * b_ms / k_ms:.2f}% of bound {tag}")

        # max abs error of the body at main-path shape: frozen E-step segment
        noise = make_chain_noise(mc.burnin_e_step + mc.nsamples_e_step, rows_main, l, gen, dev)
        fargs = (enh.mats, x2_r, vb_r, g_r, z_r, None, noise, mc.burnin_e_step,
                 mc.nsamples_e_step, 0.0, False, fast)
        _, sk = run_mh_chain(*fargs)
        _, sr = mh_chain_reference(*fargs)
        sync()
        max_abs[fast] = float((sk - sr).abs().max())
        log(f"phase 4: {name} body, frozen E-step segment at main-path shape: max abs err "
            f"{max_abs[fast]:.3e}, " + agree(sk, sr, fast, 1e-5, f"{name} frozen segment at "
                                             "main-path shape"))

    vs_s = torch.rand((mc.nsamples_e_step, B, n_pad, f), generator=gen, device=dev) + 0.05
    m_ms = cuda_ms(lambda: nmf_m_step(x2b, vs_s, w, h, g, maskb, mc.eps), reps=5)
    log(f"phase 4: nmf_m_step R={mc.nsamples_e_step} B={B} N={n_pad}: {m_ms:.4f} ms {tag}")

    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        enh.enhance_batch(wavs, seed=SEED)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    chain_s = (mc.niter * times[True, False][0] + times[True, True][0]) / 1e3
    log(f"phase 4: enhance_batch B={B} wall {', '.join(f'{t:.4f}' for t in walls)} s "
        f"(median {wall:.4f} s, {B / wall:.2f} utt/s) {tag}")
    log(f"phase 4: breakdown of the median: chain kernel (bf16 body) {chain_s:.4f} s "
        f"({100 * chain_s / wall:.1f}%), M-step {mc.niter * m_ms / 1e3:.4f} s "
        f"({100 * mc.niter * m_ms / 1e3 / wall:.1f}%), rest "
        f"{wall - chain_s - mc.niter * m_ms / 1e3:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        stft_entries = training_phases(work, wavs, cuda_ms, tag)

    cleans = [c for c, _ in synthetic_parts(np.random.default_rng(SEED), B)]  # wavs' clean parts
    cond_entries = conditioned_phase(wavs, cleans, cuda_ms, plain_chain, agree, tag, wall)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        engine_entries = engines_phase(model, wavs, cleans, cfg.mcem, (x2b, z0b, maskb),
                                       cuda_ms, plain_chain, agree, tag, wall, work)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        serving_entries = serving_phase(model, wavs, cuda_ms, plain_chain, agree, tag, work)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        labelled_entries = labelled_training_phase(wavs, cleans, cuda_ms, agree, tag, work)
    peem_profile(enh.mats, (x2b, z0b, maskb), cfg.mcem, tag)

    def m1_chain_entry(name, fast, n):
        k_ms, p_ms, b_ms, b_by = times[fast, False]  # the E-step segment
        return {"name": name, "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n,
                "max_abs_err": max_abs[fast], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    log(json.dumps({"kernels": [m1_chain_entry("mh_chain", True, launches_mma),
                                m1_chain_entry("mh_chain_f32", False, launches_f32),
                                *stft_entries, *cond_entries, *engine_entries,
                                *serving_entries, *labelled_entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
