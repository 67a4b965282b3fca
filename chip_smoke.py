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
   by exactly niter + 1, the fused NMF M-step's by 3 niter (its three
   kernels per EM iteration), outputs must be finite; the same with
   ``fast_decoder=False`` through the f32 body; then, in each precision,
   the frozen-chain config runs once through the kernel and once through
   the plain chain, and masks and waveforms must agree, with the Wiener
   partition s + n = x;
4. times (CUDA events, warm): each body and its plain chain per E-step and
   WF segment at main-path shape, the NMF M-step, and the whole
   ``enhance_batch`` (default config, so the bf16 body), each with the
   card's name and power limit. The M-step (``csrc/nmf_mstep.cu``, three
   launches a call) is first held against ``nmf_m_step_reference`` on the
   same card tensors at the main path's shapes (R = nsamples_e_step, B 32
   and the served 8, N as ``enhance_batch`` padded the phase-3 batch, F
   513, K nmf_rank) on bf16 and f32 samples: relative L2 per utterance of
   W, H, g and Vb within 1e-4 (bf16; an R-sum may round to the other bf16
   neighbour) and 1e-5 (f32); then each is timed beside the plain body and
   ``m_step_work``'s bound;
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
   labelled frame set, each with the card's name and power limit;
13. the reference's CLI chain at full width, after phase 12: phase 12's
   utterances as a raw NTCD tree under ``build/`` (wavs and placeholder
   ``.mat`` files, no lip videos), ``python -m
   dvae_tpu_torch.cli.create_train_set --format npz`` for VAD and IBM
   labels as processes of their own (one STFT power launch per chunk of 64
   utterances, counted in the process), the arrays against an in-process
   ``build_frames`` of the same wavs (VAD exactly, IBM on all but 1e-4 of
   the bins); the five trainer CLIs as processes on the ``.npz`` sets, two
   epochs at ``--steps-per-dispatch 8`` (M2-info and its pretrain CLI with
   ``--device-data``; the pretrain CLI from the M2-info run's best
   ``.pt``): exit 0, finite metrics, the ELBO falling, one ``.pt`` per
   epoch under the mangled run name; the CLI-trained M2-info (self-soft
   labels, one STFT power launch) and M2 IBM priors serve the phase-3
   batch through niter + 1 bf16-body chain launches each; then, for the M1
   ELBO, the conditional ELBO at y_dim 513, semisup and the adversarial
   step, one replay of the K = 8 graph against 8 eager calls on a twin
   (within the train-step tolerances, bitwise reported), ms per optimizer
   step at K = 1, 8, 32 host-fed and K = 1, 8 device-resident (host clock
   over an epoch, CUDA events over warm dispatches), and the device's idle share
   over one epoch at K = 1 and 32 (``chip_smoke.py --kstep-profile``, a
   process of its own under ``torch.profiler``); the chain and the STFT
   power kernel at this path's launches, each with the card's name and
   power limit;
14. the audio-VAD CLI chain at full width, after phase 13: phase 12's
   gated utterances and 16 test utterances as a raw NTCD tree under
   ``build/`` with their mixtures on the subset grid (Babble and LR at -5
   dB) and a lip-video ``.npz`` per train utterance (shorter than the
   audio, so the trim cuts); ``python -m
   dvae_tpu_torch.cli.create_audio_train_set --format npz`` as a process of
   its own (one STFT power launch per chunk of 64 clean utterances and one
   per chunk of noisy train mixtures, counted there and again in process),
   held against an in-process CPU build (VAD labels exactly, the noisy
   statistics at rtol 1e-4); ``train_audio_net --std-norm --stats-h5
   <.npz>`` at ``LSTMVad(513, 1024, 2)``, batch 16, 3 epochs (exit 0, a
   finite BCE that falls, one ``.pt`` per epoch, one B2 launch per batch);
   ``predict_vad_labels --std-norm --snr all`` (a hard and a soft file per
   mixture with the oracle's frame count, the ``vs oracle:`` F1 printed
   without a limit, a rerun predicts nothing); ``evaluate_ntcd_m2`` on
   phase 12's best M2 VAD ``.pt`` with ``--y-source classifier`` and
   ``oracle``, both from the ``.npz`` labels (niter + 1 bf16-body chain
   launches per batch, finite outputs, the Wiener partition); then B2 held
   against its plain version and timed at the builder's chunk (power) and a
   predict batch (log, centred), B1 at the sweep's first batch, the
   full-width LSTM train step and predict batch, and each CLI's wall, each
   with the card's name and power limit;
15. the lip-video and audio-visual VAD chain at full width, on phase 14's
   tree: synthetic DCT lip frames at 30 fps per utterance (a low-order
   block following the clean utterance's envelope) through the video
   builder's per-utterance core (``build_video``: the IDCT on the card,
   the VAD labels, the 62.5 fps upsample) into ``.npz`` videos, labels and
   pixel statistics in ``build_video_files``' layout, held against the
   same core on the CPU (pixels within 1e-3 on 0-255, labels exactly,
   statistics at rtol 1e-5); ``train_video_net --modality video`` and
   ``--modality av`` (``hidden`` 512, 2 layers, ``emb_dim`` 128, batch 16,
   3 epochs, ``--std-norm``; side by side, each a process: exit 0, a finite
   BCE that falls, one ``.pt`` per epoch, one B2 launch per AV batch);
   ``predict_vad_labels --modality video`` (one hard and one soft file per
   utterance) and ``--modality av --snr all`` (per mixture), the F1
   against the oracle printed without a limit; ``evaluate_ntcd_m2
   --y-source classifier`` on the video predictions with phase 12's M2 VAD
   prior (niter + 1 bf16-body chain launches per batch, finite outputs, the
   Wiener partition); the trained models on the card against the CPU
   (posteriors within 1e-4); then B2 held against its plain version and
   timed at an AV train batch, B1 at the sweep's first batch, the
   full-width ``VideoVad`` / ``AVVad`` train step, predict batch and
   batcher, and each CLI's wall, each with the card's name and power limit;
16. scoring and reconstruction on phase 14's tree and the outputs of phases
   14 and 15: the reconstruction engine (``eval/reconstruct.py``) for phase
   13's CLI-trained M1 and M2-info and phase 12's M2 VAD prior on 8 test
   pairs, with the oracle and phase 14's classifier labels (2 STFT power
   launches per pair, the power within 1e-4 of the plain power relative to
   each frame's peak; the card's reconstructions with injected noise within
   1e-4 of the CPU's; the M2-info probe's classifiers finite); the six
   ``reconstruct_*`` CLIs at ``--max-utts 4`` on that tree and on a QUT tree
   from ``create_test_set`` (as processes, each figure set per utterance,
   where matplotlib imports; else a process must exit naming matplotlib,
   and the CLIs run in process with the figure writer recording the names
   and rows, nothing rendered); ``run_metrics`` on phase 14's and 15's
   ``evaluate_ntcd_m2`` outputs with ``--classifier-dir`` and
   ``--score-input``, ``run_metrics_classif`` on the audio, video and AV
   labels, as processes side by side (finite SI-SDR, ESTOI and PESQ means,
   printed without a limit; the in-sweep F1 columns equal to
   ``run_metrics_classif``'s over the same hard labels; the video labels'
   pooled F1 equal to ``predict_vad_labels``' ``vs oracle:`` line); then
   the scorers' host time per utterance and B2 at one utterance against
   its plain version, ``torch.stft`` and its bound, each with the card's
   name and power limit;
17. decoders of any depth and width (ROADMAP A10) and the BatchNorm
   classifier (A16), after phase 16: the MH-chain kernel against its plain
   chain at the phase-3 batch's 10,240 rows, frozen and live, E-step and WF
   segments, the f32 body at ``--h-dim`` 128, 128 128 128, 256 128 64,
   100 37 9 (odd widths) and 512 512 512 and the bf16 body at 256 256 and
   512 512 (the WF segments of the widest in the lean layout), a
   conditioned row bias at depth 3, and the ``Enhancer`` running depth 0,
   depth 9 and width 513 on 4 utterances at niter 2; the M1
   ``Enhancer`` on the phase-3 batch at the full budget at each of those
   shapes (exactly niter + 1 launches of the f32 body at depths other than
   2, of the bf16 body at 256 256 and 512 512, the plain chain refusing to
   run, finite outputs), and the frozen-chain config through the kernel and
   through the plain chain at 128 128 128 and 256 256 with phase 3's
   limits; every engine and ablation at 128 128 128 with their launch
   counts and segment rows, all in the f32 body; the CLI chain at depth 3
   as processes (``training_m1 --h-dim 256 128 64``, two epochs on phase
   13's VAD frame set, run beside the checks above, then
   ``evaluate_ntcd_m1 --h-dim 256 128 64`` from its best ``.pt`` on phase
   10's sweep tree with niter + 1 f32-body launches per batch);
   ``Classifier(batch_norm=True)`` on the card against the CPU in both
   modes with its running statistics; then each shape's E-step and WF
   segment times (CUDA events) beside their bounds, and both bodies at
   128 128 again, each with the card's name and power limit;
18. data parallelism (ROADMAP A14) and the AV fusion study (A18), after
   phase 17, on phases 14-15's tree: the M1 ``Enhancer`` on ``make_mesh()``
   against no mesh on the phase-3 batch at the full budget, bitwise, with
   niter + 1 launches; on a two-shard mesh of this one card
   (``Mesh([cuda:0, cuda:0])``), frozen chain, against the unsharded run
   within 1e-4 of each utterance's peak, with 2 x (niter + 1) launches of
   half the rows; ``training_m1 --data-parallel --steps-per-dispatch 8``
   and ``train_audio_net --data-parallel`` as processes under a torchrun
   environment of world size 1 (NCCL; the all-reduce inside the CUDA
   graphs), their checkpoints and epoch logs bitwise those of the runs
   without the flag, B2's launches counted; ``training_m1 --multihost``
   there failing loudly; ``av_fusion_study --train --epochs 2``; these six
   processes side by side; then B1 at a shard's rows and B2 at the
   data-parallel VAD batch against their plain versions and timed, each
   with the card's name and power limit;
19. ``McemConfig.fast_stats`` (ROADMAP A15), the default of both packages,
   after phase 18: B1 reading bf16 x2 (and an E-step's Vb; a WF segment
   keeps the f32 Vb for its sums and rounds it at the energy) and emitting
   bf16 samples, against the plain chain on the same planes at the
   phase-3 batch's 10,240 rows, both bodies, E-step and WF, frozen at the
   full budget's steps and live (the emission's dtype, its one-ulp flips
   by share and size, the WF sums, the partition); the bf16 body at 512
   512 in the lean layout; pmcem's segments at 102,400 rows; the
   frozen-chain config in both bodies through the kernel and the plain
   chain with phase 3's limits; ``enhance_batch`` at the full budget at
   fast_stats True and False (niter + 1 launches each, medians of three
   walls, peak device memory) and pmcem at fast_stats; then B1's segments
   at both settings and the NMF M-step on bf16 and f32 samples (CUDA
   events) beside their bounds by the bytes at the planes' dtypes, each
   with the card's name and power limit;
20. every decoder the JAX models build (ROADMAP A10b), after phase 19:
   B1 against its plain chain at the phase-3 batch's 10,240 rows, frozen
   and live, E-step and WF, each shape with its layout, the f32 body at
   ``--h-dim`` (none), 128 x 9, 64 x 16, 1024, 1024 1024 1024, 128 128,
   640, 640 x 9 and 1024 + 64 x 8, an M2 ``dec_only`` decoder at y_dim 1 with
   no hidden layer (its output row bias), the bf16 body at 128 128, 1024
   1024 and 2048 2048, so that every layout (shared, lean, wide) x body x
   mode runs, the f32 body's with its layers from its arguments (depth 1
   to 8) and from the device table (any other depth); pmcem's E-step
   segment at 102,400 rows at 2048 2048 (the wide layout's scratch the same
   at 10,240 and 102,400 rows, peak device memory); the M1 ``Enhancer`` on
   the phase-3 batch at the full budget at (none; std-normalized input),
   128 x 9, 1024 and 1024 1024 (niter + 1 launches of the body the depth
   selects, no plain chain, finite outputs) and the frozen config at niter
   10 through the kernel and the plain chain with phase 3's limits; each
   shape's E-step and WF segment times (CUDA events) beside their bounds,
   each with the card's name and power limit; last, alone on the card,
   ``evaluate_ntcd_m1 --h-dim 1024 1024`` as a process from a ``.pt`` of
   seeded random weights on phase 10's sweep tree (niter + 1 bf16-body
   launches per batch).

The frozen-chain comparisons of phases 3, 9, 10, 11, 17, 18 and 20 run at
``fast_stats=False``: their limits were set for f32 planes, and phase 19
holds the bf16 planes. The second-to-last line is a JSON summary of the kernels; the last line is
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
import shutil
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


def bf16_share_limit(units: int = 256) -> float:
    """The share of Vs elements the bf16 body must hold within BF16_REL
    for a decoder of ``units`` hidden units in all: BF16_SHARE at 128/128,
    with the allowance growing in proportion beyond. A row's Vs moves when
    any one of its units rounds the other way, so the rows that move grow
    with the units: measured on the card (phase 17, NVIDIA H100 80GB HBM3
    at 700 W), 0.06%, 0.20% and 0.43% of the elements of a frozen chain
    from the phase-2 latents at 256, 512 and 1,024 units, and 0.19%, 0.57%
    and 1.54% at a live chain's latents, where the kernel's last sample
    against the plain bf16 decoder on the kernel's own latent moves as
    many, so no chain state is involved."""
    return 1.0 - (1.0 - BF16_SHARE) * max(1.0, units / 256)


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


def chain_work(rows, f, l, widths, n_burn, n_samples, wf, fast_stats=False):
    """(product flops, elementwise flops, special functions, bytes) one
    chain segment needs with a decoder of hidden ``widths``: every step
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
    """(flops, bytes) the least one NMF M-step (``enhance/nmf.py::nmf_m_step``)
    needs with R = ``r`` samples of (B, N, F) = (``b``, ``n``, ``f``) stored
    at ``vs_bytes`` a value, as ``benchmark/work.py`` counts it for
    ``mstep_roofline``: the samples and x2 (f32) read once, whatever an
    implementation reads again (one utterance's samples fit in L2), and the
    f32 Vb written once; per sample element the W and H stages take
    g Vs + Vb, the floor, 1/Vx, its square and two sums (7 operations
    each), the g stage those and x2 Vs, two products and two sums (9)."""
    elems = r * b * n * f
    return 23 * elems, elems * vs_bytes + 8 * b * n * f


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


def frozen_vs_plain(model, frozen, wavs, batch, frames, plain_chain, name: str,
                    phase: int, mask_limit: float = 1e-3, norm=None) -> None:
    """A frozen-chain McemConfig (``frozen``) through the kernel and through
    the plain chain, with phase 3's limits (the masks' at ``mask_limit``):
    ``run_mcem`` on ``batch`` (x2, z0, mask, as the main path sees the
    phase-3 batch), then ``enhance_batch`` on ``wavs`` (float32 wire,
    device-side noise estimate), whose waveforms are compared where the
    ISTFT's window normalizer is full (the first and last nfft samples of
    an utterance divide by a normalizer down to ~1e-10, as in the
    reference). ``norm``: the ``EnhancerConfig`` input statistics."""
    import torch

    from dvae_tpu_torch.enhance.mcem import run_mcem
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig

    x2b, z0b, maskb = batch
    fcfg = EnhancerConfig(mcem=frozen, noise_from_partition=False, wire_dtype="float32",
                          norm=norm)
    enh_k = Enhancer(model, fcfg)
    with torch.inference_mode():
        rk = run_mcem(enh_k.mats, x2b, z0b, maskb, SEED, frozen)
        with plain_chain():
            rp = run_mcem(enh_k.mats, x2b, z0b, maskb, SEED, frozen)
    torch.cuda.synchronize()
    mask_err, cost_err, part = frozen_agreement(rk, rp, maskb)
    log(f"phase {phase}: {name} frozen-chain run_mcem kernel vs plain: max mask diff "
        f"{mask_err:.3e} (limit {mask_limit:g}), max cost rel diff {cost_err:.3e} (limit "
        f"1e-4), |WFs + WFn - 1| <= {part:.3e} on valid frames (limit 1e-5)")
    check(mask_err < mask_limit and cost_err < 1e-4 and part < 1e-5,
          f"{name} frozen run_mcem: kernel vs plain")

    out_k = enh_k.enhance_batch(wavs, seed=SEED)
    with plain_chain():
        out_p = enh_k.enhance_batch(wavs, seed=SEED)
    wave_err, part_err = 0.0, 0.0
    nfft, hop = fcfg.stft.nfft, fcfg.stft.hop
    for (sk_, nk_), (sp_, _), xx, fr in zip(out_k, out_p, wavs, frames):
        peak = float(np.abs(xx).max())
        core = slice(nfft, min(len(xx), (fr - 1) * hop + nfft) - nfft)
        wave_err = max(wave_err, float(np.abs(sk_ - sp_)[core].max()) / peak)
        part_err = max(part_err, float(np.abs(sk_ + nk_ - xx)[core].max()) / peak)
    log(f"phase {phase}: {name} frozen-chain enhance_batch kernel vs plain: max |s_k - s_p| "
        f"/ peak {wave_err:.3e} (limit 1e-3); Wiener partition max |s + n - x| / peak "
        f"{part_err:.3e} on covered samples (limit 1e-4)")
    check(wave_err < 1e-3 and part_err < 1e-4,
          f"{name} frozen enhance_batch: kernel vs plain, partition")


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
    h1 = cm.widths[0]
    work = chain_work(rows, f, l, cm.widths, n_burn, n_samp, False)
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
            frozen = McemConfig(var_rw=0.0, fast_decoder=fast, fast_stats=False)
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


@contextlib.contextmanager
def chain_calls():
    """The (rows, WF mode) of every chain segment the engines run: the
    launches themselves are counted by the wrapper."""
    from dvae_tpu_torch.enhance import mcem

    seen, real = [], mcem.run_mh_chain

    def spy(mats, x2, *args, **kw):
        seen.append((x2.shape[0], kw["wf_mode"]))
        return real(mats, x2, *args, **kw)

    mcem.run_mh_chain = spy
    try:
        yield seen
    finally:
        mcem.run_mh_chain = real


def engine_fields(mc, rows: int) -> dict:
    """{name: (EnhancerConfig fields, the (rows, WF mode) chain segments
    the run must make)} of every engine and ablation beside mcem, for a
    batch of ``rows`` frame rows."""
    r = mc.pmcem_chains
    return {
        "pmcem": (dict(engine="pmcem"), [(r * rows, False)] * mc.niter + [(r * rows, True)]),
        "peem": (dict(engine="peem"), []),
        "peem-wf": (dict(engine="peem-wf"), [(rows, True)]),
        "clean-z": (dict(ablation="clean_z"), [(rows, False)] * mc.niter + [(rows, True)]),
        "clean-z-nomcem": (dict(ablation="clean_z_nomcem"), []),
    }


def engine_runs(model, wavs, cleans, mc, batch_shape, bf16: bool, phase: int) -> list:
    """Each engine and ablation of :func:`engine_fields` once through the
    ``Enhancer`` on ``wavs`` (mixtures of ``cleans``; float32 wire,
    device-side noise estimate), counts from 0 around each run: every chain
    segment at the rows and mode the engine makes, each one launch of the
    body the decoder takes (the bf16 body if ``bf16``, else the f32 body),
    finite outputs and the Wiener partition. Returns pmcem's segments."""
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped

    stft_cfg = StftConfig()
    nfft, hop = stft_cfg.nfft, stft_cfg.hop
    frames = [n_stft_frames_clamped(len(x), stft_cfg) for x in wavs]

    def partition_err(out):
        worst = 0.0
        for (s, n_), x, fr in zip(out, wavs, frames):
            core = slice(nfft, min(len(x), (fr - 1) * hop + nfft) - nfft)
            worst = max(worst, float(np.abs(s + n_ - x)[core].max()) / float(np.abs(x).max()))
        return worst

    pmcem_seen = []
    for name, (fields, want) in engine_fields(mc, batch_shape[0] * batch_shape[1]).items():
        enh = Enhancer(model, EnhancerConfig(mcem=mc, wire_dtype="float32",
                                             noise_from_partition=False, **fields))
        mh_chain.launches = mh_chain.launches_mma = 0
        with chain_calls() as seen:
            out = enh.enhance_batch(wavs, seed=SEED, clean_wavs=cleans)
        n_all, n_mma = mh_chain.launches, mh_chain.launches_mma
        part = partition_err(out)
        finite = all(np.isfinite(s).all() and np.isfinite(n_).all() and len(s) == len(x)
                     for (s, n_), x in zip(out, wavs)) and np.isfinite(enh.last_cost).all()
        log(f"phase {phase}: {name}: {n_all} mh_chain launches ({n_mma} of the bf16 body; "
            f"expected {len(want)}), segments at {sorted(set(seen))} rows / WF mode; cost "
            f"{enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}; outputs finite: {finite}; "
            f"Wiener partition max |s + n - x| / peak {part:.3e} (limit 1e-4)")
        check(n_all == len(want) and n_mma == (n_all if bf16 else 0) and seen == want,
              f"{name}: chain launches")
        check(finite and part < 1e-4, f"{name}: outputs finite, Wiener partition")
        if name == "pmcem":
            pmcem_seen = seen
    return pmcem_seen


def engines_phase(model, wavs, cleans, mc, batch, cuda_ms, plain_chain, agree, tag: str,
                  m1_wall: float, work: str) -> list:
    """Phase 10 on the card: every E-step engine and ablation beside mcem at
    full width on the phase-3 batch (``wavs``, mixtures of ``cleans``) and
    the budget ``mc``; ``batch`` is the phase-3 batch as the engines see it
    (x2, z0, mask). Returns the kernels-line entries of these paths."""
    import torch

    from dvae_tpu_torch.cli import evaluate_ntcd_m1, evaluate_ntcd_m2_info_vad
    from dvae_tpu_torch.enhance import mh_chain
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
    from dvae_tpu_torch.ops.stft import StftConfig

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    x2b, z0b, maskb = batch
    b, n_pad, f = x2b.shape
    l = z0b.shape[-1]
    rows, r = b * n_pad, mc.pmcem_chains
    stft_cfg = StftConfig()
    mats = extract_decoder_mlp(model, l)
    runs = engine_fields(mc, rows)

    # ---- 10a. each engine and ablation once, counts from 0 around the path
    pmcem_seen = engine_runs(model, wavs, cleans, mc, (b, n_pad), True, 10)
    pmcem_launches = sum(not wf for _, wf in pmcem_seen)

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
          and seen == pmcem_seen, "M2-info pmcem launches")
    check(all(np.isfinite(s).all() and np.isfinite(n_).all() for s, n_ in out)
          and np.isfinite(enh_v5.last_cost).all(), "M2-info pmcem outputs finite")

    # ---- 10b. frozen chains, kernel vs plain, at the main path's rows
    frozen = dataclasses.replace(mc, var_rw=0.0, niter=5, fast_stats=False)
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
        b_ms, b_by = chain_bound_ms(chain_work(rr, f, l, mats.widths, n_burn, n_samp, wf), True)
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
        fcfg = EnhancerConfig(mcem=McemConfig(var_rw=0.0, fast_decoder=fast, fast_stats=False),
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
    work_ = chain_work(rows, f, l, enh8.mats.widths, n_burn, n_samp, False)
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


def labelled_training_phase(wavs, cleans, cuda_ms, agree, tag: str, work: str,
                            keep: str) -> tuple:
    """Phase 12 on the card: labelled frame sets through B2, the conditional
    trainers at full width, and two trained priors served through B1;
    returns the kernels-line entries of this path and the best M2 VAD
    ``.pt``, copied to ``keep`` for phase 14."""
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
    m2_vad = os.path.join(keep, "m2_vad.pt")
    shutil.copyfile(best["M2_VAD"], m2_vad)
    return [chain_entry("mh_chain (trained conditional priors)", b1_v5 + b1_ibm, seg),
            stft_entry], m2_vad


CLI_EPOCHS, K_TIMES, CLI_CHUNK = 2, (1, 8, 32), 64
KSTEP_KINDS = ("M1 ELBO", "M2 ELBO (IBM)", "M2v3 semisup (uloss)", "M2-info adversarial")


def write_raw_tree(raw: str, splits: dict) -> dict:
    """``splits`` ({split: utterances}) as a raw NTCD-TIMIT tree under
    ``raw``: each utterance its own speaker's ``sa1``, the wav under
    ``ntcd_timit/Clean/volunteers/<spk>/straightcam/`` and a placeholder
    ``.mat`` under ``ntcd_timit/matlab_raw/<split dir>/<spk>/`` (the catalog
    only lists them; no lip-video h5s, so no trim). Returns {split: the
    wav paths in the catalog's order}."""
    from dvae_tpu_torch.data.io import write_wav

    paths = {}
    for split, utts in splits.items():
        sdir, pre = {"train": ("train", "tr"), "validation": ("dev", "va"),
                     "test": ("test", "te")}[split]
        paths[split] = []
        for i, u in enumerate(utts):
            spk = f"{pre}{i:04d}"
            mat = os.path.join(raw, "ntcd_timit", "matlab_raw", sdir, spk, "sa1.mat")
            os.makedirs(os.path.dirname(mat), exist_ok=True)
            open(mat, "wb").close()
            wav = os.path.join(raw, "ntcd_timit", "Clean", "volunteers", spk, "straightcam",
                               "sa1.wav")
            os.makedirs(os.path.dirname(wav), exist_ok=True)
            write_wav(wav, u, FS)
            paths[split].append(wav)
    return paths


def spawn_module(module: str, argv: list, count_stft: bool = False, count_chain: bool = False,
                 env: dict | None = None) -> subprocess.Popen:
    """``python -m module *argv`` started as a subprocess from the repo's
    root (``env`` added to this process's); with ``count_stft``
    (``count_chain``) through a wrapper that prints the process's B2
    launches (B1 launches, all and the bf16 body's) at its end."""
    root = os.path.dirname(os.path.abspath(__file__))
    if count_stft or count_chain:
        said = ("print(f'stft_power launches {stft_power.launches}')\n" if count_stft else
                "print(f'mh_chain launches {mh_chain.launches} {mh_chain.launches_mma}')\n")
        wrap = ("import runpy, sys\nfrom dvae_tpu_torch.ops import stft_power\n"
                "from dvae_tpu_torch.enhance import mh_chain\n"
                "sys.argv = sys.argv[1:]\n"
                "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n" + said)
        cmd = [sys.executable, "-c", wrap, module, *map(str, argv)]
    else:
        cmd = [sys.executable, "-m", module, *map(str, argv)]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=None if env is None else {**os.environ, **env})


def collect_module(proc: subprocess.Popen, what: str, count_stft: bool = False,
                   count_chain: bool = False) -> tuple:
    """Wait for a :func:`spawn_module` process (killed after 600 s).
    Returns (stdout, B2 launches or (B1 launches, bf16 ones) or None); a
    non-zero exit fails."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{out[-2000:]}\n"
                                f"{err[-4000:]}")
    launches = None
    if count_stft or count_chain:
        last = [int(v) for v in out.strip().splitlines()[-1].split()[2:]]
        launches = last[0] if count_stft else tuple(last)
    return out, launches


def run_module(module: str, argv: list, count_stft: bool = False,
               count_chain: bool = False) -> tuple:
    """:func:`spawn_module`, then :func:`collect_module`."""
    return collect_module(spawn_module(module, argv, count_stft, count_chain),
                          f"{module} {' '.join(map(str, argv))}", count_stft, count_chain)


def epoch_metrics(stdout: str) -> list:
    """The ``[Train]`` lines of a fit's epoch log, as dicts."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("[Train]"):
            pairs = line.split("]", 1)[1].split("    ")
            out.append({k.strip(): float(v) for k, v in (p.split(":") for p in pairs if p.strip())})
    return out


def kstep_setup(kind: str, k: int, ds, device_data: bool):
    """A fresh full-width model of ``kind`` (Xavier from the seed) on the
    card with its train step as a K-step fit runs it (capturable Adam and
    kept gradients when ``k > 1``), and its batch source. Returns (model,
    optimizers, step, MultiStep or None, feed)."""
    import torch

    from dvae_tpu_torch.models import CVAE, VAE, CVAE_v3, DisentangledVAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.train import loop
    from dvae_tpu_torch.train.steps import (
        MultiStep,
        adam,
        init_adversarial_state,
        make_adversarial_step,
        make_semisup_step,
        make_train_step,
    )

    multi = k > 1
    make = {"M1 ELBO": lambda: VAE(513, 16, (128, 128)),
            "M2 ELBO (IBM)": lambda: CVAE(513, 513, 16, (128, 128)),
            "M2v3 semisup (uloss)": lambda: CVAE_v3(513, 1, 16, (128, 128)),
            "M2-info adversarial": lambda: DisentangledVAE(513, 1, 16, (128, 128))}[kind]
    model = init_xavier_(make(), torch.Generator().manual_seed(SEED)).cuda()
    if kind == "M2-info adversarial":
        opts = init_adversarial_state(model, 1e-4, capturable=multi)
        step = make_adversarial_step(model, *opts, 0.0, 10.0, 1.0, keep_grads=multi)
    else:
        opts = (adam(model.parameters(), 1e-4, capturable=multi),)
        step = (make_semisup_step(model, opts[0], "uloss", 10.0, keep_grads=multi)
                if kind.startswith("M2v3") else
                make_train_step(model, opts[0], kind != "M1 ELBO", keep_grads=multi))
    feed = (loop._DeviceFeed if device_data else loop._HostFeed)(
        ds, torch.device("cuda"), kind != "M1 ELBO")
    return model, opts, step, (MultiStep(step, opts, feed.data) if multi else None), feed


def kstep_epoch(step, multi, feed, k: int, gen, rng) -> int:
    """One epoch of full batches of 128, ``k`` per dispatch, as
    ``loop._run_epochs`` runs them (the leftover batches as one smaller
    dispatch), the metrics summed on the card. Returns the steps run."""
    import torch

    acc, buf, n = None, [], 0

    def flush():
        nonlocal acc, n
        if len(buf) > 1:
            vals = multi(*feed.stack(buf), generator=gen)
            feed.sent()
        elif buf:
            m = step(*feed.one(buf[0]), generator=gen)
            vals = torch.stack(list(m.values()))[None]
        else:
            return
        part = vals.sum(0, dtype=torch.float64)
        acc = part if acc is None else acc + part
        n += len(buf)
        buf.clear()

    for item in feed.batches(128, rng, True):
        buf.append(item)
        if len(buf) >= k:
            flush()
    flush()
    check(bool(torch.isfinite(acc).all()), "K-step epoch metrics not finite")
    return n


def kstep_profile(kind: str, k: int, npz: str) -> int:
    """``chip_smoke.py --kstep-profile <kind> <K> <npz>``: one host-fed epoch
    of ``kind`` at ``K`` steps per dispatch under ``torch.profiler``, after a
    warm epoch; prints the device's idle share. Run as a process of its own
    (host timings after the profiler ran slower in the same process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvae_tpu_torch.data.datasets import FrameDataset

    ds = FrameDataset(npz, "train")
    _, _, step, multi, feed = kstep_setup(kind, k, ds, False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kstep_epoch(step, multi, feed, k, gen, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = kstep_epoch(step, multi, feed, k, gen, np.random.default_rng(SEED + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0) / 1e6
    if busy > 0:
        log(f"{kind} K={k}: {n} steps in {wall:.4f} s under the profiler, device busy "
            f"{busy:.4f} s, idle share {100 * (1 - busy / wall):.1f}%")
    else:
        log(f"{kind} K={k}: no device time in the trace, idle share not measured")
    return 0


def cli_chain_phase(wavs, cleans, cuda_ms, agree, tag: str, work: str, keep: str) -> tuple:
    """Phase 13 on the card: the reference's CLI chain at full width, from a
    raw tree through ``create_train_set`` (B2) and the five trainer CLIs
    (K = 8) to serving two CLI-trained priors (B1); then the K-step graph
    against eager K steps, the K-step times and idle shares. Returns the
    kernels-line entries of this path and {"m1", "m2_info": the best
    ``.pt`` of the CLI-trained M1 and M2-info, copied to ``keep`` for phase
    16; "vad_npz": the VAD frame set, copied there for phase 17}."""
    import torch

    from dvae_tpu_torch.data.builders import build_frames, padded_batch
    from dvae_tpu_torch.data.datasets import FrameDataset
    from dvae_tpu_torch.data.io import read_wav
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.labeling import self_soft_labels
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, DisentangledVAE
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
    from dvae_tpu_torch.train import checkpoint as ckpt

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    # ---- 13a. phase 12's gated utterances as a raw NTCD tree under build/
    rng, gate_rng = np.random.default_rng(SEED + 1), np.random.default_rng(SEED + 12)
    clean_train = [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_TRAIN_UTTS)]
    clean_valid = [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_VALID_UTTS)]
    data = os.path.join(work, "data")
    paths = write_raw_tree(os.path.join(data, "subset", "raw"),
                           {"train": clean_train, "validation": clean_valid})
    frames_dir = os.path.join(data, "subset", "processed", "ntcd_timit")

    # ---- 13b. create_train_set --format npz, B2 once per chunk
    n_b2, npz = 0, {}
    read = {s: [read_wav(p)[0] for p in ps] for s, ps in paths.items()}
    for labels in ("vad_labels", "ibm_labels"):
        t0 = time.perf_counter()
        out, n = run_module("dvae_tpu_torch.cli.create_train_set",
                            ["--data-root", data, "--labels", labels, "--format", "npz",
                             "--chunk-utterances", str(CLI_CHUNK)], count_stft=True)
        wall = time.perf_counter() - t0
        npz[labels] = os.path.join(frames_dir, f"Clean_{labels}_upsampled.npz")
        check(out.startswith(f"wrote {npz[labels]}"), f"create_train_set said {out!r}")
        chunks = {s: -(-len(u) // CLI_CHUNK) for s, u in read.items()}
        check(n == sum(chunks.values()), f"{n} stft_power launches for chunks {chunks}")
        n_b2 += n
        with np.load(npz[labels]) as f:
            got = {k: f[k] for k in f.files}
        said = []
        for split in ("train", "validation"):
            want = build_frames(read[split], labels=labels)  # one launch, in process
            x, y = got[f"X_{split}"].T, got[f"Y_{split}"].T
            check(x.shape == want.x.shape and y.shape == want.y.shape,
                  f"{labels} {split}: {x.shape} vs {want.x.shape}")
            p = torch.from_numpy(want.x)
            ratio = limit_ratio(torch.from_numpy(x), p)
            off = int((y != want.y).sum())
            check(ratio <= 1.0, f"{labels} {split} rows at {ratio} of the power limit")
            check(off == 0 if labels == "vad_labels" else off <= 1e-4 * y.size,
                  f"{labels} {split}: {off} labels differ")
            rows_said = ("exact" if np.array_equal(x, want.x)
                         else f"at {ratio:.3f} of the power limit")
            said.append(f"{split} {x.shape} rows {rows_said}, {off} labels differ")
            if split == "train":
                for k, w in (("X_train_mean", want.mean), ("X_train_std", want.std)):
                    check(np.allclose(got[k], w, rtol=1e-5, atol=0), f"{labels} {k}")
        log(f"phase 13: create_train_set --labels {labels} --format npz in {wall:.2f} s (a "
            f"process of its own): {n} stft_power launches for {chunks} chunks of "
            f"{CLI_CHUNK} utterances; against an in-process build_frames of the same wavs: "
            f"{'; '.join(said)}; train statistics within rtol 1e-5")

    # ---- 13c. the five trainer CLIs on the .npz frame sets, K = 8
    models = os.path.join(work, "models")
    base = ["--data-root", data, "--models-root", models, "--end-epoch", str(CLI_EPOCHS + 1),
            "--steps-per-dispatch", "8"]
    hdim = "hdim_128_128_zdim_016_end_epoch_003"
    runs = {
        "training_m1": (["--frames", npz["vad_labels"]], f"ntcd_M1_nonorm_{hdim}", "M1",
                        "elbo"),
        "training_m2": (["--labels", "ibm_labels", "--frames", npz["ibm_labels"]],
                        f"ntcd_M2_IBM_nonorm_{hdim}", "M2", "elbo"),
        "training_m2v3_semisup": (["--frames", npz["vad_labels"], "--alpha", "10"],
                                  f"ntcd_M2v3_VAD_Uloss_alpha_10.0_nonorm_{hdim}", "M2",
                                  "objective"),
        "training_m2_info_vad": (["--frames", npz["vad_labels"], "--device-data"],
                                 "ntcd_M2_info_VAD_Lenc_aux_v1_alpha_0.0_beta_10.0_gamma_1.0"
                                 f"_y_nonorm_{hdim}", "M2", "elbo"),
    }
    pre_name = f"ntcd_M2_info_VAD_Lenc_aux_v3_alpha_0.0_beta_10.0_pretrain_yhatsoft_nonorm_{hdim}"

    def finished(cli, out, run, prefix, curve, wall):
        hist = epoch_metrics(out)
        check(len(hist) == CLI_EPOCHS and all(np.isfinite(list(h.values())).all() for h in hist),
              f"{cli}: epoch metrics {hist}")
        check(hist[-1][curve] < hist[0][curve], f"{cli}: the {curve} did not fall: {hist}")
        pts = ckpt.checkpoints(os.path.join(models, run), f"{prefix}_epoch_*.pt")
        check(len(pts) == CLI_EPOCHS, f"{cli}: {len(pts)} .pt files under {run}")
        log(f"phase 13: {cli} ({wall:.1f} s, a process of its own): train {curve} per epoch "
            f"{[h[curve] for h in hist]}; {len(pts)} .pt under {run}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futs = {cli: pool.submit(run_module, f"dvae_tpu_torch.cli.{cli}", base + extra)
                for cli, (extra, *_rest) in runs.items()}
        outs = {cli: f.result()[0] for cli, f in futs.items()}
    wall = time.perf_counter() - t0
    for cli, (extra, run, prefix, curve) in runs.items():
        finished(cli, outs[cli], run, prefix, curve, wall)
    info_best = ckpt.best_checkpoint(os.path.join(models, runs["training_m2_info_vad"][1]), "M2")
    t0 = time.perf_counter()
    out, _ = run_module("dvae_tpu_torch.cli.training_m2_info_vad_pretrain",
                        base + ["--frames", npz["vad_labels"], "--device-data",
                                "--pretrained-checkpoint", str(info_best)])
    finished("training_m2_info_vad_pretrain", out, pre_name, "M2", "elbo",
             time.perf_counter() - t0)
    log(f"phase 13: the four independent trainer CLIs ran side by side in {wall:.1f} s, the "
        f"pretrain CLI after them from {info_best.name}")

    # ---- 13d. the CLI-trained M2-info and M2 IBM priors, served
    mc = McemConfig()
    want = mc.niter + 1
    stft_cfg = StftConfig()

    def served(model, y_mode, path, ys_fn, what):
        enh = Enhancer(model, EnhancerConfig(y_mode=y_mode))
        enh.reload(torch.load(path, map_location="cpu", weights_only=True))
        mh_chain.launches = mh_chain.launches_mma = stft_power.launches = 0
        ys = ys_fn(enh)
        out = enh.enhance_batch(wavs, ys, seed=SEED)
        n_b1, n_mma, n_st = mh_chain.launches, mh_chain.launches_mma, stft_power.launches
        check(n_mma == n_b1 == want, f"{what}: {n_mma} bf16 body launches of {n_b1}")
        check(all(np.isfinite(a).all() and np.isfinite(b).all() for a, b in out)
              and np.isfinite(enh.last_cost).all(), f"{what}: outputs not finite")
        log(f"phase 13: {path.name} of the CLI run ({what}) enhanced the phase-3 batch through "
            f"{n_mma} bf16-body mh_chain launches (expected {want}) and {n_st} stft_power; "
            f"outputs finite, cost {enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}")
        return enh, ys, n_b1, n_st

    enh_v5, ys_v5, b1_v5, st_v5 = served(
        DisentangledVAE(513, 1, 16, (128, 128)), "dec_only", info_best,
        lambda enh: self_soft_labels(enh.model, wavs, stft_cfg, 1, "classify_from_x"),
        "M2-info, dec_only, self-soft labels")
    check(st_v5 == 1, f"{st_v5} stft_power launches for one self-soft batch")
    m2_best = ckpt.best_checkpoint(os.path.join(models, runs["training_m2"][1]), "M2")
    _, _, b1_m2, _ = served(
        CVAE(513, 513, 16, (128, 128)), "enc_dec", m2_best,
        lambda enh: [ibm_labels(c, n_stft_frames_clamped(len(c), stft_cfg)) for c in cleans],
        "M2, enc_dec, IBM labels of the clean parts")

    # ---- 13e. the K-step graph against K eager steps, then its times
    sets = {"vad_labels": FrameDataset(npz["vad_labels"], "train"),
            "ibm_labels": FrameDataset(npz["ibm_labels"], "train")}

    def ds_of(kind):
        return sets["ibm_labels" if "IBM" in kind else "vad_labels"]

    def adam_state(opts):
        return [v for o in opts for st in o.state.values() for _, v in sorted(st.items())]

    for kind in KSTEP_KINDS:
        said = []
        for device_data in (False, True):
            model_a, opts_a, _, multi, feed = kstep_setup(kind, 8, ds_of(kind), device_data)
            model_b, opts_b, step_b, _, _ = kstep_setup(kind, 8, ds_of(kind), device_data)
            ga = torch.Generator(device=dev).manual_seed(SEED)
            gb = torch.Generator(device=dev).manual_seed(SEED)
            items = list(feed.batches(128, np.random.default_rng(SEED), True))[:24]
            same, m_rel, p_abs = [], 0.0, 0.0
            for d in range(3):
                chunk = items[8 * d:8 * d + 8]
                got = multi(*feed.stack(chunk), generator=ga)
                feed.sent()
                ref = torch.stack([torch.stack(list(step_b(*feed.one(it), generator=gb).values()))
                                   for it in chunk])
                sync()
                pa = list(model_a.state_dict().values()) + adam_state(opts_a)
                pb = list(model_b.state_dict().values()) + adam_state(opts_b)
                m_rel = max(m_rel, float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max()))
                p_abs = max([p_abs] + [float((a.float() - b.float()).abs().max())
                                       for a, b in zip(pa, pb)])
                same.append(torch.equal(got, ref) and all(torch.equal(a, b)
                                                          for a, b in zip(pa, pb)))
            check(m_rel <= 1e-5 and p_abs <= 2e-6,
                  f"{kind}: graph against eager K steps: metrics {m_rel}, state {p_abs}")
            said.append(f"{'device_data' if device_data else 'host-fed'} bitwise per dispatch "
                        f"{same} (max metric rel diff {m_rel:.3e}, max weight / Adam state "
                        f"diff {p_abs:.3e})")
        log(f"phase 13: {kind}, one replay of the K=8 graph against 8 eager calls of the "
            f"same step on a twin (capturable Adam, the same generator state), 3 dispatches "
            f"(the eager warm-up, two replays): {'; '.join(said)}")

    # ms per optimizer step: the host clock over an epoch (after a warm epoch
    # that also captures the graphs) and CUDA events over warm dispatches
    times = {}
    for kind in KSTEP_KINDS:
        for device_data in (False, True):
            # K = 32 host-fed only: device_data at K = 32 matched K = 8 (PR 11)
            for k in K_TIMES if not device_data else K_TIMES[:-1]:
                _, _, step, multi, feed = kstep_setup(kind, k, ds_of(kind), device_data)
                gen = torch.Generator(device=dev).manual_seed(SEED)
                kstep_epoch(step, multi, feed, k, gen, np.random.default_rng(SEED))
                sync()
                t0 = time.perf_counter()
                n = kstep_epoch(step, multi, feed, k, gen, np.random.default_rng(SEED + 1))
                sync()
                host_ms = (time.perf_counter() - t0) / n * 1e3
                items = list(feed.batches(128, np.random.default_rng(SEED), True))[:k]
                if k > 1:
                    stack = feed.stack(items)

                    def dispatch():
                        multi(*stack, generator=gen)
                        feed.sent()
                else:
                    batch = feed.one(items[0])

                    def dispatch():
                        step(*batch, generator=gen)
                ev_ms = cuda_ms(dispatch, reps=128 // k, warm=2) / k
                times[kind, device_data, k] = (host_ms, ev_ms)
        rows = "; ".join(
            f"K={k}: host-fed {times[kind, False, k][0]:.4f} / {times[kind, False, k][1]:.4f}"
            + (f", device_data {times[kind, True, k][0]:.4f} / {times[kind, True, k][1]:.4f}"
               if (kind, True, k) in times else "") for k in K_TIMES)
        log(f"phase 13: {kind} ms per optimizer step at batch 128 (host clock over an epoch of "
            f"{n} steps / CUDA events over 128 steps of warm dispatches): {rows} {tag}")

    # ---- 13f. the device's idle share over one epoch, K = 1 and K = 32, each
    # under the profiler in a process of its own
    for kind in ("M1 ELBO", "M2-info adversarial"):
        for k in (1, 32):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--kstep-profile",
                                kind, str(k), npz["vad_labels"]], capture_output=True,
                               text=True, timeout=600,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
            check(r.returncode == 0, f"K-step profile {kind} K={k}: {r.stderr[-3000:]}")
            said = r.stdout.strip().splitlines()[-1]
            log(f"phase 13: host-fed epoch under torch.profiler, {said} {tag}")

    # ---- the kernels at this path's launches
    seg = conditioned_segment(enh_v5.mats, cond_batch_inputs(enh_v5, wavs, ys_v5), mc, cuda_ms,
                              agree)
    log(f"phase 13: mh_chain bf16 body, E-step segment of the CLI-trained M2-info (row bias "
        f"(rows, {seg['h1']})) rows={seg['rows']} steps={seg['steps']}: kernel "
        f"{seg['k_ms']:.4f} ms, plain {seg['p_ms']:.4f} ms, bound {seg['b_ms']:.4f} ms by "
        f"{seg['b_by']}; frozen segment kernel vs plain: max abs err {seg['max_abs']:.3e}, "
        f"{seg['said']} {tag}")
    chunk_xp = padded_batch(read["train"][:CLI_CHUNK])[0].to(dev)
    stft_entry = time_stft(chunk_xp, False, "create_train_set chunk", n_b2, cuda_ms, tag,
                           phase=13)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all")
    kept = {"m1": os.path.join(keep, "cli_m1.pt"), "m2_info": os.path.join(keep, "cli_m2_info.pt"),
            "vad_npz": os.path.join(keep, "cli_vad_frames.npz")}
    shutil.copyfile(ckpt.best_checkpoint(os.path.join(models, runs["training_m1"][1]), "M1"),
                    kept["m1"])
    shutil.copyfile(info_best, kept["m2_info"])
    shutil.copyfile(npz["vad_labels"], kept["vad_npz"])
    return [chain_entry("mh_chain (CLI-trained priors)", b1_v5 + b1_m2, seg), stft_entry], kept


AUDIO_TEST_UTTS, AUDIO_EPOCHS, AUDIO_CHUNK = 16, 3, 64
AUDIO_NOISES = ("Babble", "LR")


def write_audio_tree(raw: str, proc: str, splits: dict, rng: np.random.Generator) -> dict:
    """``splits`` ({split: clean utterances}) as a raw NTCD-TIMIT tree under
    ``raw`` (:func:`write_raw_tree`), with each utterance's mixtures on the
    subset grid (Babble and LR at -5 dB: white noise scaled to -5 dB of the
    utterance's power, a draw each) under ``ntcd_timit/u/drspeech/data/
    TCDTIMIT/Noisy_TCDTIMIT/<noise>/-5/volunteers/<spk>/straightcam/``, and a
    processed lip video ``.npz`` per train utterance under ``proc``
    (``X`` (4, 4, frames) shorter than the audio, so that the statistics'
    trim cuts). Returns {split: the clean wav paths}."""
    from dvae_tpu_torch.data.io import write_wav

    paths = write_raw_tree(raw, splits)
    noisy = os.path.join(raw, "ntcd_timit", "u", "drspeech", "data", "TCDTIMIT",
                         "Noisy_TCDTIMIT")
    for split, wavs in paths.items():
        for wav, clean in zip(wavs, splits[split]):
            spk = wav.split(os.sep)[-3]
            for noise in AUDIO_NOISES:
                n = rng.standard_normal(len(clean))
                n *= np.sqrt(np.mean(clean ** 2) * 10 ** 0.5 / np.mean(n ** 2))
                mix = clean + n
                path = os.path.join(noisy, noise, "-5", "volunteers", spk, "straightcam",
                                    "sa1.wav")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_wav(path, 0.9 * mix / np.abs(mix).max(), FS)
            if split == "train":
                video = os.path.join(proc, "ntcd_timit", "matlab_raw", "train", spk,
                                     "sa1_upsampled.npz")
                os.makedirs(os.path.dirname(video), exist_ok=True)
                np.savez(video, X=np.zeros((4, 4, len(clean) // 256 - 10), np.float32))
    return paths


def sequence_metrics(stdout: str) -> tuple:
    """The (train, valid) metric dicts per epoch of ``fit_sequence``'s log."""
    def parse(line):
        return {k: float(v) for k, v in (kv.split("=") for kv in line.split(": ", 1)[1].split())}

    lines = stdout.splitlines()
    return ([parse(x) for x in lines if x.startswith("epoch ")],
            [parse(x) for x in lines if x.startswith("  valid: ")])


def audio_vad_phase(m2_vad: str, cuda_ms, agree, tag: str, work: str, said_f1: dict) -> list:
    """Phase 14 on the card: the audio-VAD CLI chain at full width, from a
    raw tree through ``create_audio_train_set --format npz`` (B2),
    ``train_audio_net`` (``LSTMVad(513, 1024, 2)``, B2 per batch) and
    ``predict_vad_labels`` (B2 per batch) to ``evaluate_ntcd_m2`` on the
    classifier's and the oracle's labels (B1), every label file and
    statistic an ``.npz``; then the kernels at this path's launches and the
    times. Returns the kernels-line entries of this path; ``said_f1["audio"]``
    is predict_vad_labels' ``vs oracle:`` line, for phase 16."""
    import torch

    from dvae_tpu_torch.cli import evaluate_ntcd_m2, predict_vad_labels
    from dvae_tpu_torch.data.builders import NOISY_STATS, build_audio_train_set, padded_batch
    from dvae_tpu_torch.data.catalog import ntcd_timit
    from dvae_tpu_torch.data.datasets import UtteranceDataset
    from dvae_tpu_torch.data.io import read_labels, read_wav
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.evaluate import find_classifier_labels
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, LSTMVad
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, pad_signal
    from dvae_tpu_torch.train import checkpoint as ckpt
    from dvae_tpu_torch.train.sequence import (
        batch_utterances,
        make_lstm_vad_predict,
        make_lstm_vad_step,
        pad_utterances,
    )
    from dvae_tpu_torch.train.steps import adam

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    # ---- 14a. phase 12's gated utterances and 16 more as a raw NTCD tree
    # with mixtures, and a lip video per train utterance
    rng, gate_rng = np.random.default_rng(SEED + 1), np.random.default_rng(SEED + 12)
    splits = {"train": [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_TRAIN_UTTS)],
              "validation": [gated(c, gate_rng) for c, _ in synthetic_parts(rng, M1_VALID_UTTS)],
              "test": [gated(c, gate_rng) for c, _ in synthetic_parts(rng, AUDIO_TEST_UTTS)]}
    data = os.path.join(work, "data")
    raw, proc = os.path.join(data, "subset", "raw"), os.path.join(data, "subset", "processed")
    write_audio_tree(raw, proc, splits, np.random.default_rng(SEED + 14))
    n_utts = {k: len(v) for k, v in splits.items()}

    # ---- 14b. create_audio_train_set --format npz as a process of its own,
    # then in process on the card (counted) and on the CPU (the reference)
    walls = {}
    t0 = time.perf_counter()
    out, n_cli = run_module("dvae_tpu_torch.cli.create_audio_train_set",
                            ["--data-root", data, "--format", "npz", "--chunk-utterances",
                             str(AUDIO_CHUNK)], count_stft=True)
    walls["create_audio_train_set"] = time.perf_counter() - t0
    check(out.startswith("done"), f"create_audio_train_set said {out!r}")
    stats = os.path.join(proc, NOISY_STATS + ".npz")
    chunks = sum(-(-n // AUDIO_CHUNK) for n in n_utts.values())
    noisy_chunks = -(-len(AUDIO_NOISES) * n_utts["train"] // AUDIO_CHUNK)
    check(n_cli == chunks + noisy_chunks,
          f"{n_cli} stft_power launches, expected {chunks} + {noisy_chunks} chunks")
    outs = {}
    for platform in ("cuda", "cpu"):
        d = os.path.join(work, f"inproc_{platform}")
        shutil.copytree(os.path.join(proc, "ntcd_timit", "matlab_raw"),
                        os.path.join(d, "ntcd_timit", "matlab_raw"))
        stft_power.launches = 0
        t0 = time.perf_counter()
        build_audio_train_set(raw, d, dataset_size="subset", fmt="npz", chunk=AUDIO_CHUNK,
                              device=platform)
        sync()
        walls[f"build_audio_train_set ({platform}, in process)"] = time.perf_counter() - t0
        outs[platform] = (d, stft_power.launches)
    n_build = outs["cuda"][1]
    check(n_build == n_cli and outs["cpu"][1] == 0, f"in-process launches {outs}")
    label_rels = sorted(os.path.relpath(os.path.join(r, f), proc) for r, _, fs in os.walk(proc)
                        for f in fs if f.endswith("_vad_labels_upsampled.npz"))
    check(len(label_rels) == sum(n_utts.values()), f"{len(label_rels)} label files")
    cpu_dir = outs["cpu"][0]
    off = sum(int((read_labels(os.path.join(proc, r)) != read_labels(
        os.path.join(cpu_dir, r))).sum()) for r in label_rels)
    check(off == 0, f"{off} VAD labels differ from the CPU build")
    with np.load(stats) as got, np.load(os.path.join(cpu_dir, NOISY_STATS + ".npz")) as want:
        stat_err = {k: float((np.abs(got[k] - want[k]) / np.abs(want[k])).max())
                    for k in ("X_train_mean", "X_train_std")}
    check(max(stat_err.values()) <= 1e-4, f"noisy statistics against the CPU build: {stat_err}")
    log(f"phase 14: create_audio_train_set --format npz in {walls['create_audio_train_set']:.2f}"
        f" s (a process of its own): {n_utts} clean utterances, "
        f"{len(AUDIO_NOISES) * sum(n_utts.values())} mixtures copied, {len(label_rels)} "
        f"label .npz; {n_cli} stft_power launches ({chunks} chunks of clean labels + "
        f"{noisy_chunks} of noisy train statistics, {AUDIO_CHUNK} utterances each), the "
        f"same in process on the card ({walls['build_audio_train_set (cuda, in process)']:.2f}"
        f" s); against the CPU build "
        f"({walls['build_audio_train_set (cpu, in process)']:.2f} s): VAD labels exact, noisy "
        f"log-power statistics max rel diff mean {stat_err['X_train_mean']:.3e}, std "
        f"{stat_err['X_train_std']:.3e} (limit 1e-4) {tag}")

    # ---- 14c. train_audio_net at the reference width, --std-norm from the .npz
    models = os.path.join(work, "models")
    run = os.path.join(models, "ntcd_audio_vad_lstm_1024x2_norm")
    t0 = time.perf_counter()
    out, n_train = run_module("dvae_tpu_torch.cli.train_audio_net",
                              ["--data-root", data, "--models-root", models, "--end-epoch",
                               str(AUDIO_EPOCHS + 1), "--std-norm", "--stats-h5", stats],
                              count_stft=True)
    walls["train_audio_net"] = time.perf_counter() - t0
    train_m, valid_m = sequence_metrics(out)
    bces = [(t["bce"], v["bce"]) for t, v in zip(train_m, valid_m)]
    check(len(bces) == AUDIO_EPOCHS and np.isfinite(bces).all(), f"VAD BCE {bces}")
    check(bces[-1][0] < bces[0][0], f"the train BCE did not fall: {bces}")
    pts = ckpt.checkpoints(run, "VAD_epoch_*.pt")
    check(len(pts) == AUDIO_EPOCHS, f"{len(pts)} .pt files under {run}")
    n_mix = {k: len(AUDIO_NOISES) * v for k, v in n_utts.items()}
    per_epoch = -(-n_mix["train"] // VAD_BATCH) + -(-n_mix["validation"] // VAD_BATCH)
    check(n_train == AUDIO_EPOCHS * per_epoch,
          f"{n_train} stft_power launches in training, expected one per batch")
    log(f"phase 14: train_audio_net LSTMVad(513, 1024, 2) --std-norm, batch {VAD_BATCH}, "
        f"{n_mix['train']} + {n_mix['validation']} mixtures, {AUDIO_EPOCHS} epochs in "
        f"{walls['train_audio_net']:.1f} s (a process of its own): (train, valid) BCE per epoch "
        f"{bces}; valid F1 per epoch {[v['f1'] for v in valid_m]}; {n_train} stft_power "
        f"launches (one per batch); {len(pts)} .pt under {os.path.basename(run)}")

    # ---- 14d. predict_vad_labels over the test mixtures
    preds = os.path.join(work, "preds")
    argv = ["--data-root", data, "--models-root", models, "--model-dir", run, "--std-norm",
            "--stats-h5", stats, "--snr", "all", "--output-dir", preds]
    t0 = time.perf_counter()
    out, n_pred = run_module("dvae_tpu_torch.cli.predict_vad_labels", argv, count_stft=True)
    walls["predict_vad_labels"] = time.perf_counter() - t0
    said = [x for x in out.splitlines() if x.startswith("vs oracle:")]
    check(len(said) == 1 and f"done: {n_mix['test']} utterances" in out,
          f"predict_vad_labels said {out[-600:]!r}")
    check(n_pred == -(-n_mix["test"] // VAD_BATCH), f"{n_pred} stft_power launches")
    pairs = ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "test", "subset", "vad_labels",
                                                  True)
    frames_ok = 0
    for noisy_rel, clean_rel in pairs.items():
        stem = os.path.join(preds, os.path.splitext(noisy_rel)[0])
        hard, soft = np.load(stem + "_y_hat_hard.npy"), np.load(stem + "_y_hat_soft.npy")
        n_oracle = read_labels(os.path.join(proc, clean_rel)).shape[1]
        frames_ok += (len(hard) == len(soft) == n_oracle
                      and np.array_equal(hard, (soft > 0.5).astype(np.float32)))
    check(frames_ok == len(pairs) == n_mix["test"],
          f"{frames_ok} of {len(pairs)} predictions with the oracle's frames")
    said_f1["audio"] = said[0]
    n_again = predict_vad_labels.main(argv)
    check(n_again == 0, f"a rerun predicted {n_again}")
    log(f"phase 14: predict_vad_labels --snr all in {walls['predict_vad_labels']:.1f} s (a "
        f"process of its own): {n_mix['test']} mixtures, a hard and a soft .npy each with the "
        f"oracle's frame count, {n_pred} stft_power launches (one per batch of {VAD_BATCH}); "
        f"{said[0]} (no limit); a rerun predicted 0")

    # ---- 14e. evaluate_ntcd_m2 on phase 12's M2 VAD prior: classifier, oracle
    mc = McemConfig()
    batches = -(-n_mix["test"] // 16)
    outputs = {}
    for source in ("classifier", "oracle"):
        out_dir = os.path.join(work, f"enh_{source}")
        extra = ["--classifier-dir", preds] if source == "classifier" else []
        mh_chain.launches = mh_chain.launches_mma = 0
        t0 = time.perf_counter()
        n_done = evaluate_ntcd_m2.main(["--data-root", data, "--checkpoint", m2_vad, "--snr",
                                        "all", "--y-source", source, "--output-dir", out_dir,
                                        *extra])
        walls[f"evaluate_ntcd_m2 --y-source {source}"] = time.perf_counter() - t0
        n_b1, n_mma = mh_chain.launches, mh_chain.launches_mma
        check(n_done == n_mix["test"] and n_b1 == n_mma == batches * (mc.niter + 1),
              f"{source}: {n_done} enhanced, {n_mma} bf16 launches of {n_b1}")
        worst, finite = 0.0, True
        for noisy_rel in pairs:
            x = read_wav(os.path.join(proc, noisy_rel))[0]
            base = os.path.join(out_dir, os.path.splitext(noisy_rel)[0])
            s_hat = read_wav(base + "_s_est" + ("_y_hat_hard" if source == "classifier"
                                                else "") + ".wav")[0]
            n_hat = read_wav(base + "_n_est" + ("_y_hat_hard" if source == "classifier"
                                                else "") + ".wav")[0]
            finite &= bool(np.isfinite(s_hat).all() and np.isfinite(n_hat).all())
            core = slice(1024, len(x) - 1024)  # the ISTFT's normalizer is full there
            lim = 1e-4 * np.abs(x).max() + 1 / 32768
            worst = max(worst, float(np.abs(s_hat + n_hat - x)[core].max() / lim))
        check(finite and worst <= 1.0, f"{source}: finite {finite}, partition at {worst}")
        outputs[source] = (n_b1, worst)
        log(f"phase 14: evaluate_ntcd_m2 --y-source {source} over {n_done} mixtures in "
            f"{walls[f'evaluate_ntcd_m2 --y-source {source}']:.2f} s: {n_mma} bf16-body "
            f"mh_chain launches of {n_b1} (niter + 1 = {mc.niter + 1} per batch of 16, "
            f"{batches} batches); outputs finite; Wiener partition max |s + n - x| at "
            f"{worst:.3f} of its limit (1e-4 of the peak + 1 PCM16 step) {tag}")

    # ---- 14f. the kernels at this path's launches, and the times
    enh = Enhancer(CVAE(513, 1, 16, (128, 128)), EnhancerConfig(y_mode="enc_dec"))
    enh.reload(torch.load(m2_vad, map_location="cpu", weights_only=True))
    todo = sorted(pairs.items(), key=lambda t: (os.path.getsize(os.path.join(proc, t[0])), t[0]))
    first = todo[:16]  # the sweep's first batch
    s_wavs = [read_wav(os.path.join(proc, n))[0].astype(np.float32) for n, _ in first]
    s_ys = [find_classifier_labels(preds, n.split("/")[-2], "sa1", 1,
                                   rel_dir=os.path.dirname(n)) for n, _ in first]
    seg = conditioned_segment(enh.mats, cond_batch_inputs(enh, s_wavs, s_ys), mc, cuda_ms, agree)
    log(f"phase 14: mh_chain bf16 body, E-step segment at the sweep's first batch (M2 VAD, "
        f"classifier labels folded into the row bias (rows, {seg['h1']})) rows={seg['rows']} "
        f"steps={seg['steps']}: kernel {seg['k_ms']:.4f} ms, plain {seg['p_ms']:.4f} ms, bound "
        f"{seg['b_ms']:.4f} ms by {seg['b_by']}; frozen segment kernel vs plain: max abs err "
        f"{seg['max_abs']:.3e}, {seg['said']} {tag}")
    chunk_xp = padded_batch([read_wav(p)[0] for p in sorted(
        os.path.join(r, f) for r, _, fs in os.walk(os.path.join(proc, "ntcd_timit", "Clean",
                                                                "train"))
        for f in fs if f.endswith(".wav"))[:AUDIO_CHUNK]])[0].to(dev)
    b2_builder = time_stft(chunk_xp, False, "audio builder chunk", n_build, cuda_ms, tag,
                           phase=14)
    stft_cfg = StftConfig(center=True)
    test_ds = UtteranceDataset([(os.path.join(proc, n), os.path.join(proc, c))
                                for n, c in todo[:VAD_BATCH]])
    pred_xp = pad_signal(torch.from_numpy(pad_utterances(test_ds, range(len(test_ds)),
                                                         stft_cfg)[0]).to(dev),
                         stft_cfg).contiguous()
    b2_pred = time_stft(pred_xp, True, "VAD train / predict batch", n_train + n_pred, cuda_ms,
                        tag, phase=14)

    # the LSTM at the reference width: a train step and a predict batch, after
    # a warm-up that holds the first B2 launch and cuDNN's setup
    with np.load(stats) as f:
        norm = (f["X_train_mean"], f["X_train_std"])
    vad = LSTMVad(513, 1024, 2, generator=torch.Generator().manual_seed(SEED)).to(dev)
    vstep = make_lstm_vad_step(vad, adam(vad.parameters(), 1e-4), norm=norm)
    predict = make_lstm_vad_predict(vad, norm=norm)
    train_ds = UtteranceDataset([(os.path.join(proc, n), os.path.join(proc, c)) for n, c in
                                 ntcd_timit.proc_noisy_clean_pair_dict(
                                     proc + "/", "train", "subset", "vad_labels", True).items()])
    xb, yb, mb = batch_utterances(train_ds, range(VAD_BATCH), stft_cfg)
    xt = batch_utterances(test_ds, range(len(test_ds)), stft_cfg)[0]

    def host_ms(fn, reps):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    step_host = host_ms(lambda: vstep(xb, yb, mb), 20)
    step_ev = cuda_ms(lambda: vstep(xb, yb, mb), reps=20, warm=2)
    pred_host = host_ms(lambda: predict(xt).cpu(), 20)
    pred_ev = cuda_ms(lambda: predict(xt), reps=20, warm=2)
    batch_host = host_ms(lambda: batch_utterances(test_ds, range(len(test_ds)), stft_cfg), 10)
    log(f"phase 14: LSTMVad(513, 1024, 2) train step at {tuple(xb.shape)}: {step_host:.4f} ms "
        f"host clock, {step_ev:.4f} ms CUDA events; predict batch at {tuple(xt.shape)}: "
        f"{pred_host:.4f} ms host clock (copy back included), {pred_ev:.4f} ms CUDA events; "
        f"its batch_utterances (wav and label reads, one STFT power launch) "
        f"{batch_host:.4f} ms host clock {tag}")
    log(f"phase 14: walls {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}; "
        f"{time.perf_counter() - t_phase:.1f} s in all {tag}")
    return [chain_entry("mh_chain (M2 VAD sweeps on classifier / oracle labels)",
                        sum(v[0] for v in outputs.values()), seg), b2_builder, b2_pred]


VIDEO_EPOCHS, VIDEO_SIDE = 3, 67
# the trainers' full widths (train_video_net's defaults)
VIDEO_WIDTHS = {"hidden": 512, "num_layers": 2, "emb_dim": 128}


def lip_dct_frames(clean: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Synthetic DCT lip frames of a clean utterance at 30 fps, (n, 67 *
    67): a floor of coefficients decaying with their order, and a low-order
    block (the mouth's coarse shape) whose gain follows the utterance's
    speech envelope, so that a lip net has something to learn."""
    side = VIDEO_SIDE
    n = int(np.ceil(len(clean) / FS * 30))
    env = np.array([np.sqrt(np.mean(s ** 2)) if len(s) else 0.0
                    for s in np.array_split(clean, n)])
    env = env / max(env.max(), 1e-12)
    decay = np.exp(-np.add.outer(np.arange(side), np.arange(side)) / 8.0)
    dct = rng.standard_normal((n, side, side)) * decay * 300.0
    dct[:, :4, :4] += 4000.0 * env[:, None, None] * np.array(
        [[1.0, -0.6, 0.4, -0.2], [0.7, 0.5, -0.3, 0.2], [-0.4, 0.3, 0.2, -0.1],
         [0.2, -0.1, 0.1, 0.05]])
    return dct.reshape(n, side * side)


def video_vad_phase(m2_vad: str, cuda_ms, agree, tag: str, work: str, said_f1: dict) -> list:
    """Phase 15 on the card: the lip-video and audio-visual VAD chain at
    full width on phase 14's tree (``work``): synthetic DCT lip frames per
    utterance through the video builder's per-utterance core (the IDCT on
    the card, held against the CPU) into ``.npz`` videos, labels and pixel
    statistics; ``train_video_net --modality video`` and ``--modality av``
    (B2 per AV batch); ``predict_vad_labels --modality video`` and ``av``;
    ``evaluate_ntcd_m2 --y-source classifier`` on the video net's labels
    (B1); then the card's models against the CPU's, the kernels at this
    path's launches and the times. Returns the kernels-line entries;
    ``said_f1["video"]`` and ``["av"]`` are predict_vad_labels' ``vs
    oracle:`` lines, for phase 16."""
    import torch

    from dvae_tpu_torch.cli import evaluate_ntcd_m2
    from dvae_tpu_torch.data.av_dataset import AudioVisualDataset, VideoDataset
    from dvae_tpu_torch.data.builders import (
        NOISY_STATS,
        build_video,
        save_video_statistics,
        write_video,
    )
    from dvae_tpu_torch.data.catalog import ntcd_timit
    from dvae_tpu_torch.data.io import read_labels, read_wav
    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.evaluate import find_classifier_labels
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, AVVad, VideoVad
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, pad_signal
    from dvae_tpu_torch.train import checkpoint as ckpt
    from dvae_tpu_torch.train.sequence import (
        batch_av_utterances,
        batch_video_utterances,
        make_lstm_vad_predict,
        make_lstm_vad_step,
        pad_av_utterances,
    )
    from dvae_tpu_torch.train.steps import adam

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    data = os.path.join(work, "data")
    raw, proc = os.path.join(data, "subset", "raw"), os.path.join(data, "subset", "processed")
    astats = os.path.join(proc, NOISY_STATS + ".npz")
    walls = {}

    # ---- 15a. a lip video per utterance of phase 14's tree, through the
    # builder's per-utterance core on the card, held against the CPU
    rng = np.random.default_rng(SEED + 15)
    sums = {"cuda": [0, 0.0, 0.0], "cpu": [0, 0.0, 0.0]}
    pixel_err, label_off, audio_off, n_videos, card_s = 0.0, 0, 0, {}, 0.0
    t0 = time.perf_counter()
    for split in ("train", "validation", "test"):
        mats = ntcd_timit.video_list(raw + "/", split)
        clean_rels, _ = ntcd_timit.speech_list(raw + "/", split)
        n_videos[split] = len(mats)
        for mat_rel, clean_rel in zip(mats, clean_rels):
            speech = read_wav(os.path.join(raw, clean_rel))[0]
            dct = lip_dct_frames(speech, rng)
            t1 = time.perf_counter()
            vk = build_video(dct, speech, device=dev)
            card_s += time.perf_counter() - t1
            vp = build_video(dct, speech, device="cpu")
            pixel_err = max(pixel_err, float(np.abs(vk.x - vp.x).max()))
            label_off += int((vk.y != vp.y).sum())
            write_video(proc, mat_rel, "vad_labels", vk, "npz")
            if split == "train":
                for key, v in (("cuda", vk.x), ("cpu", vp.x)):
                    v64 = v.astype(np.float64)
                    sums[key][0] += v64.size
                    sums[key][1] += float(v64.sum())
                    sums[key][2] += float((v64 * v64).sum())
    vstats = str(save_video_statistics(proc, *sums["cuda"], "npz"))
    cpu_stats = save_video_statistics(os.path.join(work, "cpu_stats"), *sums["cpu"], "npz")
    walls["video build (card, CPU, writes)"] = time.perf_counter() - t0
    with np.load(vstats) as got, np.load(cpu_stats) as want:
        stat_err = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                    for k in ("X_train_mean", "X_train_std")}
        pixel_mean, pixel_std = float(got["X_train_mean"][0, 0]), float(got["X_train_std"][0, 0])
    # the audio builder of phase 14 wrote the same labels over the same wavs
    for r, _, fs in os.walk(os.path.join(proc, "ntcd_timit", "Clean")):
        for f in fs:
            if f.endswith("_vad_labels_upsampled.npz"):
                lab = read_labels(os.path.join(r, f))
                vid = os.path.join(r.replace(os.sep + "Clean" + os.sep,
                                             os.sep + "matlab_raw" + os.sep),
                                   f.replace("_vad_labels_upsampled", "_upsampled"))
                with np.load(vid) as v:
                    audio_off += int(v["X"].shape[-1] != lab.shape[1])
    check(pixel_err <= 1e-3 and label_off == 0 and max(stat_err.values()) <= 1e-5
          and audio_off == 0,
          f"video build: pixels {pixel_err}, labels off {label_off}, statistics {stat_err}, "
          f"{audio_off} videos off their label frames")
    log(f"phase 15: lip videos for {n_videos} utterances (synthetic DCT frames at 30 fps, "
        f"67 x 67) through build_video on the card ({card_s:.2f} s of the "
        f"{walls['video build (card, CPU, writes)']:.2f} s that card, CPU "
        f"and .npz writes took): pixels within {pixel_err:.3e} of the CPU's (limit 1e-3 on "
        f"0-255), VAD labels exact, pixel statistics mean {pixel_mean:.4f} std "
        f"{pixel_std:.4f} within {max(stat_err.values()):.3e} relative (limit 1e-5); every "
        f"video has its label file's frames {tag}")

    # ---- 15b. train_video_net, both modalities side by side
    models = os.path.join(work, "models")
    widths = ["--hidden", str(VIDEO_WIDTHS["hidden"]), "--num-layers",
              str(VIDEO_WIDTHS["num_layers"]), "--emb-dim", str(VIDEO_WIDTHS["emb_dim"])]
    tag_w = f"{VIDEO_WIDTHS['hidden']}x{VIDEO_WIDTHS['num_layers']}"
    runs = {m: os.path.join(models, f"ntcd_{m}_vad_{tag_w}_norm") for m in ("video", "av")}
    n_mix = {k: len(AUDIO_NOISES) * v for k, v in n_videos.items()}

    def train(modality):
        argv = ["--data-root", data, "--models-root", models, "--modality", modality,
                "--end-epoch", str(VIDEO_EPOCHS + 1), "--std-norm", "--video-stats-h5", vstats,
                "--stats-h5", astats, *widths]
        t1 = time.perf_counter()
        out, n = run_module("dvae_tpu_torch.cli.train_video_net", argv, count_stft=True)
        return out, n, time.perf_counter() - t1

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        trained = dict(zip(("video", "av"), pool.map(train, ("video", "av"))))
    walls["train_video_net x 2, side by side"] = time.perf_counter() - t0
    n_av_train = 0
    for modality, (out, n_b2, wall) in trained.items():
        walls[f"train_video_net --modality {modality}"] = wall
        train_m, valid_m = sequence_metrics(out)
        bces = [(t["bce"], v["bce"]) for t, v in zip(train_m, valid_m)]
        check(len(bces) == VIDEO_EPOCHS and np.isfinite(bces).all(), f"{modality} BCE {bces}")
        check(bces[-1][0] < bces[0][0], f"the {modality} train BCE did not fall: {bces}")
        prefix = "AV_Net" if modality == "av" else "Video_Net"
        pts = ckpt.checkpoints(runs[modality], f"{prefix}_epoch_*.pt")
        check(len(pts) == VIDEO_EPOCHS, f"{len(pts)} .pt files under {runs[modality]}")
        items = n_mix if modality == "av" else n_videos
        per_epoch = -(-items["train"] // VAD_BATCH) + -(-items["validation"] // VAD_BATCH)
        want = VIDEO_EPOCHS * per_epoch if modality == "av" else 0
        check(n_b2 == want, f"{modality}: {n_b2} stft_power launches, expected {want}")
        if modality == "av":
            n_av_train = n_b2
        log(f"phase 15: train_video_net --modality {modality} {prefix} ({tag_w}, emb_dim "
            f"{VIDEO_WIDTHS['emb_dim']}) --std-norm, batch {VAD_BATCH}, {items['train']} + "
            f"{items['validation']} {'mixtures' if modality == 'av' else 'utterances'}, "
            f"{VIDEO_EPOCHS} epochs in {wall:.1f} s (a process of its own, the two modalities "
            f"side by side): (train, valid) BCE per epoch {bces}; valid F1 per epoch "
            f"{[v['f1'] for v in valid_m]}; {n_b2} stft_power launches; {len(pts)} .pt {tag}")

    # ---- 15c. predict_vad_labels, both modalities side by side
    preds = {m: os.path.join(work, f"preds_{m}") for m in ("video", "av")}

    def predict_cli(modality):
        argv = ["--data-root", data, "--models-root", models, "--model-dir", runs[modality],
                "--modality", modality, "--std-norm", "--video-stats-h5", vstats,
                "--stats-h5", astats, "--output-dir", preds[modality], *widths]
        if modality == "av":
            argv += ["--snr", "all"]
        t1 = time.perf_counter()
        out, n = run_module("dvae_tpu_torch.cli.predict_vad_labels", argv, count_stft=True)
        return out, n, time.perf_counter() - t1

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        predicted = dict(zip(("video", "av"), pool.map(predict_cli, ("video", "av"))))
    n_av_pred = 0
    pairs = ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "test", "subset", "vad_labels",
                                                  True)
    for modality, (out, n_b2, wall) in predicted.items():
        walls[f"predict_vad_labels --modality {modality}"] = wall
        n_items = n_mix["test"] if modality == "av" else n_videos["test"]
        said = [x for x in out.splitlines() if x.startswith("vs oracle:")]
        check(len(said) == 1 and f"done: {n_items} utterances" in out,
              f"predict_vad_labels --modality {modality} said {out[-600:]!r}")
        want = -(-n_items // VAD_BATCH) if modality == "av" else 0
        check(n_b2 == want, f"{modality} predict: {n_b2} stft_power launches, expected {want}")
        if modality == "av":
            n_av_pred = n_b2
            stems = [(os.path.splitext(n)[0], c) for n, c in pairs.items()]
        else:
            stems = sorted({(os.path.splitext(c.replace(
                "_vad_labels_upsampled.npz", ".wav"))[0], c) for c in pairs.values()})
        ok = 0
        for stem, clean_rel in stems:
            base = os.path.join(preds[modality], stem)
            hard, soft = np.load(base + "_y_hat_hard.npy"), np.load(base + "_y_hat_soft.npy")
            n_oracle = read_labels(os.path.join(proc, clean_rel)).shape[1]
            frames_ok = len(hard) == n_oracle if modality == "video" else \
                n_oracle - 8 <= len(hard) <= n_oracle
            ok += (len(hard) == len(soft) and frames_ok
                   and np.array_equal(hard, (soft > 0.5).astype(np.float32)))
        check(ok == len(stems) == n_items, f"{modality}: {ok} of {len(stems)} predictions")
        said_f1[modality] = said[0]
        log(f"phase 15: predict_vad_labels --modality {modality} in {wall:.1f} s (a process of "
            f"its own, side by side with the other): {n_items} "
            f"{'mixtures' if modality == 'av' else 'utterances, the clean layout'}, a hard and "
            f"a soft .npy each ({'the oracle frame count' if modality == 'video' else 'trimmed to the audio frames'}), "
            f"{n_b2} stft_power launches; {said[0]} (no limit) {tag}")

    # ---- 15d. evaluate_ntcd_m2 on phase 12's M2 VAD prior, video-net labels
    mc = McemConfig()
    batches = -(-n_mix["test"] // 16)
    out_dir = os.path.join(work, "enh_video")
    mh_chain.launches = mh_chain.launches_mma = 0
    t0 = time.perf_counter()
    n_done = evaluate_ntcd_m2.main(["--data-root", data, "--checkpoint", m2_vad, "--snr", "all",
                                    "--y-source", "classifier", "--classifier-dir",
                                    preds["video"], "--output-dir", out_dir])
    walls["evaluate_ntcd_m2 --y-source classifier (video-net labels)"] = \
        time.perf_counter() - t0
    n_b1, n_mma = mh_chain.launches, mh_chain.launches_mma
    check(n_done == n_mix["test"] and n_b1 == n_mma == batches * (mc.niter + 1),
          f"video-net labels: {n_done} enhanced, {n_mma} bf16 launches of {n_b1}")
    worst, finite = 0.0, True
    for noisy_rel in pairs:
        x = read_wav(os.path.join(proc, noisy_rel))[0]
        base = os.path.join(out_dir, os.path.splitext(noisy_rel)[0])
        s_hat = read_wav(base + "_s_est_y_hat_hard.wav")[0]
        n_hat = read_wav(base + "_n_est_y_hat_hard.wav")[0]
        finite &= bool(np.isfinite(s_hat).all() and np.isfinite(n_hat).all())
        core = slice(1024, min(len(x), len(s_hat)) - 1024)
        lim = 1e-4 * np.abs(x).max() + 1 / 32768
        worst = max(worst, float(np.abs(s_hat[:len(x)] + n_hat[:len(x)] - x[:len(s_hat)])[core]
                                 .max() / lim))
    check(finite and worst <= 1.0, f"video-net labels: finite {finite}, partition at {worst}")
    log(f"phase 15: evaluate_ntcd_m2 --y-source classifier on the video net's labels over "
        f"{n_done} mixtures in "
        f"{walls['evaluate_ntcd_m2 --y-source classifier (video-net labels)']:.2f} s: {n_mma} "
        f"bf16-body mh_chain launches of {n_b1} (niter + 1 = {mc.niter + 1} per batch of 16, "
        f"{batches} batches); outputs finite; Wiener partition max |s + n - x| at {worst:.3f} "
        f"of its limit (1e-4 of the peak + 1 PCM16 step) {tag}")

    # ---- 15e. the trained models on the card against the CPU, same weights
    cfg = StftConfig(center=True)
    pixel_norm = (np.float32([[pixel_mean]]), np.float32([[pixel_std]]))
    with np.load(astats) as f:
        audio_norm = (f["X_train_mean"], f["X_train_std"])
    test_v = VideoDataset([(os.path.join(proc, ntcd_timit.video_h5_rel(c)), os.path.join(proc, c))
                           for c in sorted(set(pairs.values()))])
    todo = sorted(pairs.items(), key=lambda t: (os.path.getsize(os.path.join(proc, t[0])), t[0]))
    test_av = AudioVisualDataset([(os.path.join(proc, n), os.path.join(
        proc, ntcd_timit.video_h5_rel(c)), os.path.join(proc, c)) for n, c in todo])
    few = range(min(4, len(test_v)))
    vb = batch_video_utterances(test_v, few, device="cpu")[0]
    (sb, avb), _, _ = batch_av_utterances(test_av, few, cfg, device="cpu")
    fwd_err = {}
    for modality, cls, x_cpu, norm in (("video", VideoVad, vb, pixel_norm),
                                       ("av", AVVad, (sb, avb), (audio_norm, pixel_norm))):
        model = cls(**VIDEO_WIDTHS)
        best = ckpt.best_checkpoint(runs[modality])
        model.load_state_dict(torch.load(best, map_location="cpu", weights_only=True))
        p_cpu = make_lstm_vad_predict(model, norm=norm)(x_cpu)
        x_card = tuple(t.to(dev) for t in x_cpu) if modality == "av" else x_cpu.to(dev)
        p_card = make_lstm_vad_predict(model.to(dev), norm=norm)(x_card).cpu()
        fwd_err[modality] = float((p_card - p_cpu).abs().max())
    check(max(fwd_err.values()) <= 1e-4, f"card vs CPU forward: {fwd_err}")
    log(f"phase 15: the trained VideoVad and AVVad (best .pt of each) on the card (cuDNN convs "
        f"and LSTMs, TF32 off) against the CPU on {len(few)} test utterances at "
        f"{tuple(vb.shape)}: max "
        f"abs posterior diff video {fwd_err['video']:.3e}, av {fwd_err['av']:.3e} (limit "
        f"1e-4) {tag}")

    # ---- 15f. the kernels at this path's launches, and the times
    enh = Enhancer(CVAE(513, 1, 16, (128, 128)), EnhancerConfig(y_mode="enc_dec"))
    enh.reload(torch.load(m2_vad, map_location="cpu", weights_only=True))
    first = todo[:16]  # the sweep's first batch
    s_wavs = [read_wav(os.path.join(proc, n))[0].astype(np.float32) for n, _ in first]
    s_ys = [find_classifier_labels(preds["video"], n.split("/")[-2], "sa1", 1,
                                   rel_dir=os.path.dirname(n)) for n, _ in first]
    seg = conditioned_segment(enh.mats, cond_batch_inputs(enh, s_wavs, s_ys), mc, cuda_ms, agree)
    log(f"phase 15: mh_chain bf16 body, E-step segment at the sweep's first batch (M2 VAD, "
        f"video-net labels folded into the row bias (rows, {seg['h1']})) rows={seg['rows']} "
        f"steps={seg['steps']}: kernel {seg['k_ms']:.4f} ms, plain {seg['p_ms']:.4f} ms, bound "
        f"{seg['b_ms']:.4f} ms by {seg['b_by']}; frozen segment kernel vs plain: max abs err "
        f"{seg['max_abs']:.3e}, {seg['said']} {tag}")
    train_pairs = ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "train", "subset",
                                                        "vad_labels", True)
    train_av = AudioVisualDataset([(os.path.join(proc, n), os.path.join(
        proc, ntcd_timit.video_h5_rel(c)), os.path.join(proc, c)) for n, c in train_pairs.items()])
    av_xp = pad_signal(torch.from_numpy(pad_av_utterances(
        train_av, range(min(VAD_BATCH, len(train_av))), cfg)[0]).to(dev), cfg).contiguous()
    b2_av = time_stft(av_xp, True, "AV batch", n_av_train + n_av_pred, cuda_ms, tag, phase=15)

    train_v = VideoDataset([(os.path.join(proc, ntcd_timit.video_h5_rel(c)), os.path.join(proc, c))
                            for c in sorted(set(train_pairs.values()))])

    def host_ms(fn, reps):
        fn()
        sync()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t1) / reps * 1e3

    said = []
    for modality, cls, batch, norm in (
            ("video", VideoVad, lambda ds, idx: batch_video_utterances(ds, idx, device=dev),
             pixel_norm),
            ("av", AVVad, lambda ds, idx: batch_av_utterances(ds, idx, cfg, device=dev),
             (audio_norm, pixel_norm))):
        ds_train, ds_test = (train_v, test_v) if modality == "video" else (train_av, test_av)
        model = cls(**VIDEO_WIDTHS, generator=torch.Generator().manual_seed(SEED)).to(dev)
        step = make_lstm_vad_step(model, adam(model.parameters(), 1e-4), norm=norm)
        predict = make_lstm_vad_predict(model, norm=norm)
        xb, yb, mb = batch(ds_train, range(min(VAD_BATCH, len(ds_train))))
        xt = batch(ds_test, range(min(VAD_BATCH, len(ds_test))))[0]
        step_host = host_ms(lambda: step(xb, yb, mb), 20)
        step_ev = cuda_ms(lambda: step(xb, yb, mb), reps=20, warm=2)
        pred_host = host_ms(lambda: predict(xt).cpu(), 20)
        pred_ev = cuda_ms(lambda: predict(xt), reps=20, warm=2)
        batch_host = host_ms(lambda: batch(ds_test, range(min(VAD_BATCH, len(ds_test)))), 5)
        shape = tuple((xb[1] if modality == "av" else xb).shape)
        said.append(f"{cls.__name__} train step at {shape}: {step_host:.4f} ms host clock, "
                    f"{step_ev:.4f} ms CUDA events; predict batch: {pred_host:.4f} ms host "
                    f"clock (copy back included), {pred_ev:.4f} ms CUDA events; its batcher "
                    f"{batch_host:.4f} ms host clock")
    log(f"phase 15: {'; '.join(said)} {tag}")
    log(f"phase 15: walls {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}; "
        f"{time.perf_counter() - t_phase:.1f} s in all {tag}")
    return [chain_entry("mh_chain (M2 VAD sweep on video-net labels)", n_b1, seg), b2_av]


RECON_PAIRS, RECON_CLI_UTTS = 8, 4
QUT_NOISES = ("cafe", "home", "street", "car")
# each model's figure set, and the reconstruct CLIs: (module, model, extra flags)
FIGURES = {"m1": ("_s_recon.png", "_x_recon.png"),
           "m2": ("_s_recon.png", "_x_recon.png", "_x_recon_ones.png", "_x_recon_zeros.png"),
           "m2_info": ("_s_recon.png", "_x_recon.png", "_x_recon_soft.png", "_x_recon_ones.png",
                       "_x_recon_zeros.png", "_recon_aux.png")}
RECON_CLIS = (("reconstruct_ntcd_m1", "m1", False), ("reconstruct_ntcd_m2", "m2", True),
              ("reconstruct_ntcd_m2_info", "m2_info", False), ("reconstruct_m1", "m1", False),
              ("reconstruct_m2", "m2", False), ("reconstruct_m2_info", "m2_info", False))
F1_KEYS = ("accuracy", "precision", "recall", "f1")


def frame_peak_err(got, want) -> float:
    """Largest |got - want| over each frame's peak |want|."""
    peak = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / peak).max())


def f1_numbers(line: str) -> dict:
    """The ``name=value`` pairs of a ``vs oracle:`` / ``pooled over ...:`` line."""
    return dict(kv.split("=") for kv in line.split(":", 1)[1].split())


def scoring_phase(kept: dict, said_f1: dict, cuda_ms, tag: str, work: str) -> list:
    """Phase 16 on the card: scoring and reconstruction on phase 14's tree
    and the outputs of phases 14 and 15 (``work``): the reconstruction
    engine for the models of ``kept`` on test pairs (B2 for each signal's
    power, held against the plain power; the card against the CPU with
    injected noise); the six reconstruct CLIs (processes where matplotlib
    imports, else in process with the figure writer recording);
    ``run_metrics`` and ``run_metrics_classif`` as processes; the scorers'
    host times and B2 at one utterance. Returns the kernels-line entry."""
    import copy
    import importlib
    import importlib.util
    import io

    import torch

    from dvae_tpu_torch import viz
    from dvae_tpu_torch.cli import create_test_set
    from dvae_tpu_torch.data.catalog import ntcd_timit
    from dvae_tpu_torch.data.io import read_wav, write_wav
    from dvae_tpu_torch.enhance.evaluate import find_classifier_labels, load_oracle_labels
    from dvae_tpu_torch.eval import reconstruct as rec
    from dvae_tpu_torch.eval.pesq import pesq_wheel_available
    from dvae_tpu_torch.eval.pesq_native import pesq_wb
    from dvae_tpu_torch.eval.stoi import stoi
    from dvae_tpu_torch.models import CVAE, VAE, DisentangledVAE
    from dvae_tpu_torch.ops import stft_power
    from dvae_tpu_torch.ops.stft import StftConfig, pad_signal

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    data = os.path.join(work, "data")
    proc = os.path.join(data, "subset", "processed")
    preds = {"audio": os.path.join(work, "preds"), "video": os.path.join(work, "preds_video"),
             "av": os.path.join(work, "preds_av")}
    cfg = StftConfig()
    walls = {}
    all_pairs = list(ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "test", "subset",
                                                           "vad_labels", True).items())
    pairs = all_pairs[:RECON_PAIRS]

    # ---- 16a. the reconstruction engine on the card, against the CPU
    on_cpu = {"m1": VAE(513, 16, (128, 128)), "m2": CVAE(513, 1, 16, (128, 128)),
              "m2_info": DisentangledVAE(513, 1, 16, (128, 128))}
    for name, model in on_cpu.items():
        model.load_state_dict(torch.load(kept[name], map_location="cpu", weights_only=True))
    models = {name: copy.deepcopy(m).to(dev) for name, m in on_cpu.items()}
    rng = np.random.default_rng(SEED + 16)
    stft_power.launches = 0
    x2_err, rec_err, probe_err, n_rec, probe_ok = 0.0, 0.0, 0.0, 0, True
    t0 = time.perf_counter()
    for noisy_rel, clean_rel in pairs:
        power = {}
        for key, path in zip("sx", rec.ntcd_pair_wavs(proc, noisy_rel, clean_rel)):
            w = read_wav(path)[0]
            power[key] = rec.power_spec(w, cfg, device=dev)[1]
            plain = stft_power.stft_power_reference(
                torch.as_tensor(w.astype(np.float32), device=dev), cfg)
            x2_err = max(x2_err, frame_peak_err(power[key], plain))
        utt = os.path.splitext(os.path.basename(noisy_rel))[0]
        ys = [load_oracle_labels(os.path.join(proc, clean_rel)),
              find_classifier_labels(preds["audio"], noisy_rel.split("/")[-2], utt, 1,
                                     rel_dir=os.path.dirname(noisy_rel))]
        n = min(*(len(y) for y in ys), *(p.shape[0] for p in power.values()))
        for p in power.values():
            eps = rng.standard_normal((n, 16)).astype(np.float32)
            for name, y in [("m1", None)] + [(m, y[:n]) for m in ("m2", "m2_info") for y in ys]:
                got = rec.reconstruct(models[name], p[:n], y, eps=eps)
                want = rec.reconstruct(on_cpu[name], p[:n].cpu(), y, eps=eps)
                rec_err = max(rec_err, float(np.max(np.abs(got - want) / want)))
                n_rec += 1
        # the M2-info probe: its own soft labels on the clean power, the
        # latent of that decode and the auxiliary classifier on it
        s2 = power["s"][:n]
        soft = rec.classify(models["m2_info"], "classify_from_x", s2)
        r, z = rec.reconstruct(models["m2_info"], s2, soft, return_z=True)
        yz = rec.classify(models["m2_info"], "classify_from_z", z)
        probe_ok &= bool(np.isfinite(soft).all() and np.isfinite(yz).all() and np.isfinite(r).all())
        for method, inp, out in (("classify_from_x", s2.cpu(), soft), ("classify_from_z", z, yz)):
            probe_err = max(probe_err, float(np.abs(
                rec.classify(on_cpu["m2_info"], method, inp) - out).max()))
    walls["the engine"] = time.perf_counter() - t0
    n_engine = stft_power.launches
    check(n_engine == 2 * len(pairs), f"{n_engine} stft_power launches for {len(pairs)} pairs")
    check(x2_err <= 1e-4, f"x2 from the kernel at {x2_err} of each frame's peak")
    check(rec_err <= 1e-4, f"card vs CPU reconstructions: max rel diff {rec_err}")
    check(probe_ok, "the M2-info probe's outputs are not finite")
    log(f"phase 16: the reconstruction engine on {len(pairs)} of phase 14's test pairs (the "
        f"CLI-trained M1 and M2-info of phase 13, phase 12's M2 VAD; each conditional model on "
        f"the oracle and on phase 14's classifier labels): {n_engine} stft_power launches (2 "
        f"per pair, the clean and the noisy power); x2 within {x2_err:.3e} of the plain power "
        f"relative to each frame's peak (limit 1e-4); {n_rec} reconstructions with injected "
        f"noise, card against CPU on the same power, labels and noise: max rel diff "
        f"{rec_err:.3e} (limit 1e-4); the M2-info probe's classify_from_x / classify_from_z "
        f"finite, max abs diff from the CPU {probe_err:.3e} (no limit) {tag}")

    # ---- 16b. a QUT tree for the reconstruct_m* CLIs, then the six CLIs
    noise_dir = os.path.join(work, "qut_noise")
    os.makedirs(os.path.join(noise_dir, "test"), exist_ok=True)
    nrng = np.random.default_rng(SEED + 160)
    for name in QUT_NOISES:  # longer than every utterance, as create_test_set needs
        write_wav(os.path.join(noise_dir, "test", f"{name}.wav"),
                  0.1 * nrng.standard_normal(8 * FS), FS)
    t0 = time.perf_counter()
    n_qut = len(create_test_set.main(["--data-root", data, "--noise-dir", noise_dir]))
    walls["create_test_set"] = time.perf_counter() - t0

    def cli_argv(cli, model, classifier):
        return ["--data-root", data, "--checkpoint", kept[model], "--max-utts",
                str(RECON_CLI_UTTS), "--output-dir", os.path.join(work, "figures", cli)] + (
            ["--y-source", "classifier", "--classifier-dir", preds["audio"]] if classifier
            else [])

    said = []
    if importlib.util.find_spec("matplotlib") is not None:
        def run_cli(job):
            cli, model, classifier = job
            t1 = time.perf_counter()
            out, n = run_module(f"dvae_tpu_torch.cli.{cli}", cli_argv(cli, model, classifier),
                                count_stft=True)
            return out, n, time.perf_counter() - t1

        with concurrent.futures.ThreadPoolExecutor(len(RECON_CLIS)) as pool:
            ran = list(pool.map(run_cli, RECON_CLIS))
        for (cli, model, _), (out, n, wall) in zip(RECON_CLIS, ran):
            # the utterances of this tree are each speaker's sa1: their
            # figure names repeat, and each name holds the last one's figures
            names = {x.split()[-1] for x in out.splitlines() if x.startswith("reconstructed ")}
            files = sorted(os.listdir(os.path.join(work, "figures", cli)))
            want = sorted(f"{u}{s}" for u in names for s in FIGURES[model])
            done = out.count("reconstructed ")
            check(done == RECON_CLI_UTTS and n == 2 * done and files == want and all(
                os.path.getsize(os.path.join(work, "figures", cli, f)) > 0 for f in files),
                f"{cli}: {done} utterances, {n} stft_power launches, files {files}")
            walls[cli] = wall
            said.append(f"{cli} {done} utterances, {n} stft_power launches, {len(files)} "
                        f"figures")
        log(f"phase 16: the six reconstruct CLIs as processes, side by side: {'; '.join(said)} "
            f"(QUT tree of {n_qut} mixtures from create_test_set) {tag}")
    else:
        log("phase 16: the six reconstruct CLIs are not run as processes: matplotlib does not "
            "import on this machine, and every reconstruct CLI draws figures")
        r = subprocess.run([sys.executable, "-m", "dvae_tpu_torch.cli.reconstruct_ntcd_m1",
                            *cli_argv("reconstruct_ntcd_m1", "m1", False)],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode != 0 and "need matplotlib" in r.stderr and "loaded" not in r.stdout,
              f"reconstruct_ntcd_m1 without matplotlib: exit {r.returncode}, {r.stderr[-500:]}")
        # each CLI's walk, model and device path in process, the figure
        # writer replaced by a recorder of the names and rows it is given
        calls = []
        guard, save = viz.require_matplotlib, rec.save_signal_rows
        viz.require_matplotlib = lambda what="figures": None
        rec.save_signal_rows = lambda out_path, rows, *a, **k: calls.append((str(out_path), rows))
        try:
            for cli, model, classifier in RECON_CLIS:
                calls.clear()
                stft_power.launches = 0
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):  # its per-utterance lines
                    done = importlib.import_module(f"dvae_tpu_torch.cli.{cli}").main(
                        cli_argv(cli, model, classifier))
                walls[f"{cli} (in process)"] = time.perf_counter() - t1
                kinds = [next((s for s in FIGURES[model] if path.endswith(s)), None)
                         for path, _ in calls]
                finite = all(np.isfinite(np.asarray(v)).all() for _, rows in calls
                             for row in rows for v in row if v is not None)
                check(done == RECON_CLI_UTTS and stft_power.launches == 2 * done and finite
                      and None not in kinds and sorted(kinds) == sorted(FIGURES[model] * done),
                      f"{cli}: {done} utterances, {stft_power.launches} launches, figures "
                      f"{kinds}, finite {finite}")
                said.append(f"{cli} {done} utterances, {stft_power.launches} stft_power "
                            f"launches, {len(calls)} figures ({len(FIGURES[model])} each)")
        finally:
            viz.require_matplotlib, rec.save_signal_rows = guard, save
        log(f"phase 16: reconstruct_ntcd_m1 as a process exits {r.returncode} naming matplotlib, "
            f"before any device work; the six reconstruct CLIs in process on the card, "
            f"--max-utts {RECON_CLI_UTTS}, the figure writer recording (nothing rendered): "
            f"{'; '.join(said)} (QUT tree of {n_qut} mixtures from create_test_set) {tag}")

    # ---- 16c. run_metrics and run_metrics_classif as processes, side by side
    out_dirs = {k: os.path.join(work, f"scores_{k}") for k in ("input", "audio", "video", "av")}
    for d in out_dirs.values():
        os.makedirs(d, exist_ok=True)
    enhanced = {"audio": os.path.join(work, "enh_classifier"),
                "video": os.path.join(work, "enh_video")}
    jobs = {("run_metrics", k): ["--model-output-dir", enhanced[k], "--suffix", "_y_hat_hard",
                                 "--classifier-dir", preds[k]] for k in enhanced}
    jobs["run_metrics", "input"] = ["--score-input", "--model-output-dir", out_dirs["input"]]
    for k in preds:
        jobs["run_metrics_classif", k] = ["--classifier-dir", preds[k], "--stats-dir",
                                          out_dirs[k]]

    def run_job(job):
        t1 = time.perf_counter()
        out, _ = run_module(f"dvae_tpu_torch.cli.{job[0]}", ["--data-root", data, *jobs[job]])
        return out, time.perf_counter() - t1

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        outs = dict(zip(jobs, pool.map(run_job, jobs)))
    walls["the six scoring processes, side by side"] = time.perf_counter() - t0
    scores = {}
    for (cli, k), (_, wall) in outs.items():
        walls[f"{cli} {k}"] = wall
        path = (os.path.join(out_dirs[k], "stats_input.json") if k == "input" else
                os.path.join(enhanced[k] if cli == "run_metrics" else out_dirs[k], "stats.json"))
        with open(path) as f:
            scores[cli, k] = json.load(f)
    pesq_by = "the licensed wheel" if pesq_wheel_available() else "native P.862.2"
    for k in ("audio", "video", "input"):
        st = scores["run_metrics", k]["overall"]
        for key in ("si_sdr", "estoi", "pesq"):
            check(st[key]["avg"] is not None and np.isfinite(st[key]["avg"]),
                  f"run_metrics {k}: {key} {st[key]}")
        what = ("--score-input (the mixtures)" if k == "input" else
                f"on phase {14 if k == 'audio' else 15}'s evaluate_ntcd_m2 outputs, --suffix "
                f"_y_hat_hard --classifier-dir <the {k} labels>")
        log(f"phase 16: run_metrics {what} over {len(all_pairs)} mixtures "
            f"({walls['run_metrics ' + k]:.1f} s, a process of its own; PESQ {pesq_by}): "
            + ", ".join(f"{key} {v['avg']} +/- {v['+/-']}" for key, v in st.items())
            + f" (no limit) {tag}")
    # the in-sweep F1 columns against run_metrics_classif over the same hard
    # labels: the classif index takes one file per (speaker, utterance), the
    # first path sorted, which is the Babble half of the per-mixture labels;
    # the video net's labels are one per utterance, for both noise types
    for k, groups in (("audio", ("Babble",)), ("video", ("Babble", "LR"))):
        want = {key: scores["run_metrics_classif", k]["overall"][key] for key in F1_KEYS}
        for g in groups:
            got = {key: scores["run_metrics", k]["noise_type"][g][key] for key in F1_KEYS}
            check(got == want, f"run_metrics {k} {g} F1 columns {got} vs classif {want}")
    pooled = {}
    for k in preds:
        lines = [x for x in outs["run_metrics_classif", k][0].splitlines()
                 if x.startswith("pooled over")]
        check(len(lines) == 1, f"run_metrics_classif {k}: pooled lines {lines}")
        pooled[k] = lines[0]
    check(f1_numbers(pooled["video"]) == f1_numbers(said_f1["video"]),
          f"video labels: {pooled['video']} vs predict_vad_labels' {said_f1['video']}")
    for k in preds:
        st = scores["run_metrics_classif", k]["overall"]
        same = {"audio": "; run_metrics' F1 columns for Babble equal these",
                "video": "; run_metrics' F1 columns for both noise types equal these",
                "av": ""}[k]
        log(f"phase 16: run_metrics_classif on the {k} labels "
            f"({walls['run_metrics_classif ' + k]:.1f} s, a process of its own): per utterance "
            + ", ".join(f"{key} {st[key]['avg']} +/- {st[key]['+/-']}" for key in F1_KEYS)
            + f"{same}; {pooled[k]}; predict_vad_labels said {said_f1[k]} "
            + ("(the same files: equal)" if k == "video" else
               "(over both noise types; run_metrics_classif scored the Babble half; no limit)")
            + f" {tag}")

    # ---- 16d. host times of the scorers, B2 at one utterance
    t_stoi, t_pesq = [], []
    for noisy_rel, clean_rel in pairs:
        s_path = rec.ntcd_pair_wavs(proc, noisy_rel, clean_rel)[0]
        s_t, fs = read_wav(s_path)
        s_hat = read_wav(os.path.join(enhanced["audio"], os.path.splitext(noisy_rel)[0]
                                      + "_s_est_y_hat_hard.wav"))[0]
        off, n = int(0.05 * fs), min(len(s_t), len(s_hat))
        s_t, s_hat = s_t[off:n - off], s_hat[off:n - off]
        t1 = time.perf_counter()
        stoi(s_t, s_hat, fs, extended=True)
        t_stoi.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        pesq_wb(s_t, s_hat, fs)
        t_pesq.append(time.perf_counter() - t1)
    log(f"phase 16: host time per ~5 s utterance over {len(pairs)} (the run_metrics trims): "
        f"ESTOI mean {1e3 * np.mean(t_stoi):.2f} ms (median {1e3 * np.median(t_stoi):.2f}), "
        f"native PESQ mean {1e3 * np.mean(t_pesq):.2f} ms (median "
        f"{1e3 * np.median(t_pesq):.2f}) {tag}")
    one = read_wav(rec.ntcd_pair_wavs(proc, *pairs[0])[0])[0].astype(np.float32)
    xp = pad_signal(torch.as_tensor(one, device=dev), cfg)[None].contiguous()
    entry = time_stft(xp, False, "reconstruct, one utterance", n_engine, cuda_ms, tag, phase=16)
    log(f"phase 16: walls {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}; "
        f"{time.perf_counter() - t_phase:.1f} s in all {tag}")
    return [entry]


@contextlib.contextmanager
def no_plain_chain():
    """The plain chain raises: CUDA tensors must take the kernel."""
    from dvae_tpu_torch.enhance import mh_chain

    real = mh_chain.mh_chain_reference

    def plain(*args, **kw):
        raise RuntimeError("the plain chain ran on CUDA tensors")

    mh_chain.mh_chain_reference = plain
    try:
        yield
    finally:
        mh_chain.mh_chain_reference = real


def power_norm(x2b, maskb) -> tuple:
    """(mean, std) per bin of the batch's power over its valid frames, as
    ``EnhancerConfig(norm=...)`` takes a std_norm model's train statistics.
    A random decoder with no hidden layer needs it: its Vs is the exp of a
    linear map of the encoder's mean, which overflows on raw power."""
    valid = x2b[maskb > 0]
    return valid.mean(0).cpu().numpy(), valid.std(0).cpu().numpy()


# phase 17's decoders: the f32 body's depths and widths (as --h-dim takes
# them; the decoder's hidden widths are their reverse) and the bf16 body's
# two-layer widths past 128; the CLI chain's --h-dim
DEPTH_F32 = ((128,), (128, 128, 128), (256, 128, 64), (100, 37, 9), (512, 512, 512))
DEPTH_BF16 = ((256, 256), (512, 512))
DEPTH_CLI = (256, 128, 64)


def depth_phase(wavs, cleans, batch, frames, cuda_ms, plain_chain, agree, tag: str,
                work: str, vad_npz: str) -> list:
    """Phase 17 on the card: decoders of any depth and width up to 512
    (ROADMAP A10) in both bodies, and the BatchNorm classifier (A16).
    ``batch`` is the phase-3 batch as the engines see it (x2, mask) and
    ``frames`` its frame counts; ``vad_npz`` is phase 13's VAD frame set.
    Returns the kernels-line entries of the new shapes."""
    import copy

    import torch

    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.mh_chain import (
        chain_layout,
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import Classifier, init_xavier_
    from dvae_tpu_torch.train import checkpoint as ckpt

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    x2b, maskb = batch
    b, n_pad, f = x2b.shape
    l, rows = 16, b * n_pad
    mc = McemConfig()
    shapes = [(h, False) for h in DEPTH_F32] + [(h, True) for h in DEPTH_BF16]

    def model_of(h_dim):
        return init_xavier_(VAE(f, l, h_dim), torch.Generator().manual_seed(SEED))

    def body(fast):
        return "bf16" if fast else "f32"

    models = os.path.join(work, "models")
    hdim = "_".join(f"{h:03d}" for h in DEPTH_CLI)
    run_name = f"ntcd_M1_nonorm_hdim_{hdim}_zdim_016_end_epoch_{CLI_EPOCHS + 1:03d}"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # ---- 17d, first half: the depth-3 trainer CLI, a process of its own,
        # while the checks below run
        t_train = time.perf_counter()
        training = pool.submit(run_module, "dvae_tpu_torch.cli.training_m1",
                               ["--frames", vad_npz, "--models-root", models, "--end-epoch",
                                str(CLI_EPOCHS + 1), "--steps-per-dispatch", "8",
                                "--h-dim", *map(str, DEPTH_CLI)])

        # ---- 17a. each body against its plain chain at the phase-3 batch's rows
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        x2 = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        vb = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        g = torch.rand((rows,), generator=gen, device=dev) + 0.5
        z0 = 0.1 * torch.randn((rows, l), generator=gen, device=dev)
        max_abs = {}
        for h_dim, fast in shapes:
            mats = extract_decoder_mlp(model_of(h_dim).to(dev), l)
            for wf in (False, True):
                said = []
                noise = make_chain_noise(5, rows, l, gen, dev)
                args = (mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, wf, fast)
                zk, *ok = run_mh_chain(*args)
                zr, *orf = mh_chain_reference(*args)
                sync()
                check(torch.equal(zk, z0), f"{h_dim} {body(fast)}: the frozen chain moved")
                if not wf:
                    max_abs[h_dim, fast] = float((ok[0] - orf[0]).abs().max())
                said += [agree(a, b_, fast, 1e-5, f"frozen {h_dim} {body(fast)} WF={wf}",
                               sum(h_dim)) for a, b_ in zip(ok, orf)]
                noise = make_chain_noise(12, rows, l, gen, dev)
                args = (mats, x2, vb, g, z0, None, noise, 6, 6, 0.01, wf, fast)
                zk, *ok = run_mh_chain(*args)
                zr, *orf = mh_chain_reference(*args)
                sync()
                same = (zk - zr).abs().amax(-1) < 1e-4
                share, moved = float(same.float().mean()), float((zk != z0).any(-1).float().mean())
                check(share > 0.99 and moved > 0.5,
                      f"live {h_dim} {body(fast)} WF={wf}: rows that end at the same z")
                said += [agree(a[..., same, :], b_[..., same, :], fast, 1e-4,
                               f"live {h_dim} {body(fast)} WF={wf}", sum(h_dim))
                         for a, b_ in zip(ok, orf)]
                layout = chain_layout(mats, f, l, wf, fast)
                log(f"phase 17: {body(fast)} body, --h-dim {' '.join(map(str, h_dim))} "
                    f"(decoder widths {mats.widths}), {'WF' if wf else 'E-step'} segments at "
                    f"{rows} rows, {layout} layout: frozen {'; '.join(said[:len(ok)])}; live "
                    f"{share:.4f} of rows end at the same z (limit 0.99), {moved:.3f} moved, on "
                    f"them {'; '.join(said[len(ok):])}")

        mats3 = extract_decoder_mlp(model_of((128, 128, 128)).to(dev), l)
        cmats = mats3._replace(w1y=0.3 * torch.randn((2, 128), generator=gen, device=dev))
        y = torch.rand((rows, 2), generator=gen, device=dev)
        noise = make_chain_noise(3, rows, l, gen, dev)
        said = []
        for wf in (False, True):
            _, *ok = run_mh_chain(cmats, x2, vb, g, z0, y, noise, 1, 2, 0.0, wf)
            _, *orf = mh_chain_reference(cmats, x2, vb, g, z0, y, noise, 1, 2, 0.0, wf)
            sync()
            said += [agree(a, b_, False, 1e-5, f"conditioned depth 3 WF={wf}")
                     for a, b_ in zip(ok, orf)]
        log(f"phase 17: f32 body, depth 3 with a conditioned row bias (rows, 128), frozen "
            f"E-step and WF segments: {'; '.join(said)}")
        short = McemConfig(niter=2)
        for h_dim, what in (((), "depth 0"), ((128,) * 9, "depth 9"), ((513,), "width 513")):
            enh = Enhancer(model_of(h_dim), EnhancerConfig(
                mcem=short, norm=power_norm(x2b, maskb) if not h_dim else None))
            mh_chain.launches = 0
            with no_plain_chain():
                out = enh.enhance_batch(wavs[:4], seed=SEED)
            sync()
            check(mh_chain.launches == short.niter + 1, f"{what}: {mh_chain.launches} launches")
            check(all(np.isfinite(s_).all() and np.isfinite(n_).all() for s_, n_ in out),
                  f"{what}: finite outputs")
        log(f"phase 17: the Enhancer runs depth 0 (std-normalized input), depth 9 and width 513 "
            f"(phase 20 runs them at the full budget): niter + 1 = {short.niter + 1} launches "
            f"each on 4 utterances, finite outputs, no plain chain")

        # ---- 17b. the M1 Enhancer at B = 32 and the full budget, each shape
        launches = {}
        for h_dim, fast in shapes:
            model = model_of(h_dim)
            enh = Enhancer(model, EnhancerConfig())
            mh_chain.launches = mh_chain.launches_mma = 0
            t0 = time.perf_counter()
            with no_plain_chain():
                out = enh.enhance_batch(wavs, seed=SEED)
            sync()
            wall = time.perf_counter() - t0
            n_all, n_mma = mh_chain.launches, mh_chain.launches_mma
            launches[h_dim, fast] = n_all
            finite = all(np.isfinite(s).all() and np.isfinite(n_).all() and len(s) == len(x)
                         for (s, n_), x in zip(out, wavs)) and np.isfinite(enh.last_cost).all()
            log(f"phase 17: enhance_batch B={B} --h-dim {' '.join(map(str, h_dim))}, default "
                f"config: {n_all} mh_chain launches, {n_mma} of the bf16 body (expected niter + "
                f"1 = {mc.niter + 1} of the {body(fast)} body), no plain chain; cost "
                f"{enh.last_cost[0]:.5f} -> {enh.last_cost[-1]:.5f}; outputs finite: {finite}; "
                f"{wall:.3f} s {tag}")
            check(n_all == mc.niter + 1 and n_mma == (n_all if fast else 0),
                  f"{h_dim}: launches of the {body(fast)} body")
            check(finite, f"{h_dim}: finite outputs")
            if h_dim in (DEPTH_F32[1], DEPTH_BF16[0]):
                with torch.inference_mode():
                    z0b = enh.model.encode(x2b, sample=False)[1]
                frozen_vs_plain(model, McemConfig(var_rw=0.0, fast_stats=False), wavs,
                                (x2b, z0b, maskb), frames,
                                plain_chain, f"--h-dim {' '.join(map(str, h_dim))} "
                                             f"{body(fast)}", 17)

        # ---- 17c. every engine and ablation at depth 3, through the f32 body
        engine_runs(model_of((128, 128, 128)), wavs, cleans, mc, (b, n_pad), False, 17)

        # ---- 17e. Classifier(batch_norm=True) on the card against the CPU
        cpu = Classifier(f, (128, 128), 1, batch_norm=True)
        with torch.no_grad():
            gb = torch.Generator().manual_seed(SEED + 18)
            for bn in cpu.bn:
                bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape, generator=gb))
                bn.bias.copy_(0.2 * torch.randn(bn.bias.shape, generator=gb))
                bn.running_mean.copy_(torch.rand(bn.running_mean.shape, generator=gb))
                bn.running_var.copy_(0.5 + torch.rand(bn.running_var.shape, generator=gb))
        card = copy.deepcopy(cpu).to(dev)
        worst = 0.0
        for shape in ((256, f), (4, 80, f)):
            xc = torch.rand(shape, generator=gb)
            with torch.no_grad():
                for train in (False, True):
                    got, want = card(xc.to(dev), train=train).cpu(), cpu(xc, train=train)
                    worst = max(worst, float(((got - want).abs() / (want.abs() + 1e-5)).max()))
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
            for (k, v), (_, w) in zip(card.state_dict().items(), cpu.state_dict().items()):
                torch.testing.assert_close(v.cpu(), w, rtol=1e-4, atol=1e-6, msg=k)
        log(f"phase 17: Classifier(513, (128, 128), 1, batch_norm=True) on the card against the "
            f"CPU, eval and train mode on (256, 513) and (4, 80, 513): outputs and the running "
            f"statistics after each train call within rtol 1e-4 (largest relative difference "
            f"{worst:.3e})")

        out, _ = training.result()
    # ---- 17d. the depth-3 CLI chain: the training above, then evaluate_ntcd_m1
    hist = epoch_metrics(out)
    pts = ckpt.checkpoints(os.path.join(models, run_name), "M1_epoch_*.pt")
    log(f"phase 17: training_m1 --h-dim {' '.join(map(str, DEPTH_CLI))} on phase 13's VAD "
        f"frame set ({time.perf_counter() - t_train:.1f} s, a process of its own, beside the "
        f"checks above): train elbo per epoch {[h['elbo'] for h in hist]}; {len(pts)} .pt")
    check(len(hist) == CLI_EPOCHS and all(np.isfinite(list(h.values())).all() for h in hist),
          f"training_m1 depth 3: epoch metrics {hist}")
    check(hist[-1]["elbo"] < hist[0]["elbo"], "training_m1 depth 3: the elbo did not fall")
    check(len(pts) == CLI_EPOCHS, f"training_m1 depth 3: {len(pts)} .pt files")
    best = ckpt.best_checkpoint(os.path.join(models, run_name), "M1")
    noisy = sweep_tree(work, 16, SEED + 11)
    want = sorted(f"{os.path.splitext(p)[0]}{k}.wav" for p in noisy for k in ("_s_est", "_n_est"))
    t0 = time.perf_counter()
    _, (n_chain, n_mma) = run_module(
        "dvae_tpu_torch.cli.evaluate_ntcd_m1",
        ["--data-root", os.path.join(work, "data"), "--snr", "all", "--batch-size", "16",
         "--checkpoint", str(best), "--h-dim", *map(str, DEPTH_CLI), "--output-dir",
         os.path.join(work, "eval")], count_chain=True)
    wall = time.perf_counter() - t0
    files = sorted(os.path.relpath(os.path.join(d, x), os.path.join(work, "eval"))
                   for d, _, xs in os.walk(os.path.join(work, "eval")) for x in xs)
    batches = -(-len(noisy) // 16)
    log(f"phase 17: evaluate_ntcd_m1 --h-dim {' '.join(map(str, DEPTH_CLI))} from {best.name} "
        f"over {len(noisy)} utterances ({wall:.1f} s, a process of its own): {len(files)} "
        f"files, {n_chain} mh_chain launches, {n_mma} of the bf16 body (expected {batches} "
        f"batches x (niter + 1) = {batches * (mc.niter + 1)} of the f32 body)")
    check(files == want and n_chain == batches * (mc.niter + 1) and n_mma == 0,
          "evaluate_ntcd_m1 depth 3: outputs and f32-body launches")

    # ---- 17f. times at the phase-3 batch's rows, each beside its bound
    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), b, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    planes = (x2b.reshape(rows, f), compute_vb(w_, h_).reshape(rows, f).contiguous(),
              g_.reshape(rows).contiguous())
    entries = []
    for h_dim, fast in [((128, 128), True), ((128, 128), False)] + shapes:
        mats = extract_decoder_mlp(model_of(h_dim).to(dev), l)
        times = {}
        for wf in (False, True):
            n_burn = mc.burnin_wf if wf else mc.burnin_e_step
            n_samp = mc.nsamples_wf if wf else mc.nsamples_e_step
            noise = make_chain_noise(n_burn + n_samp, rows, l, gen, dev)
            args = (mats, *planes, z0, None, noise, n_burn, n_samp, mc.var_rw, wf, fast)
            k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=3)
            p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=2)
            work_ = chain_work(rows, f, l, mats.widths, n_burn, n_samp, wf)
            b_ms, b_by = chain_bound_ms(work_, fast)
            times[wf] = (k_ms, p_ms, b_ms, b_by)
            log(f"phase 17: mh_chain {body(fast)} body, --h-dim {' '.join(map(str, h_dim))}, "
                f"{'WF' if wf else 'E-step'} segment rows={rows} steps={n_burn}+{n_samp}: "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                f"({work_[0] / 1e9:.2f} GFLOP of products, {work_[3] / 1e6:.1f} MB), kernel at "
                f"{100 * b_ms / k_ms:.2f}% of bound {tag}")
        if (h_dim, fast) in launches:
            k_ms, p_ms, b_ms, b_by = times[False]  # the E-step segment
            entries.append({
                "name": f"mh_chain{'' if fast else '_f32'} (--h-dim "
                        f"{' '.join(map(str, h_dim))})", "route": "cuda",
                "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                "replaces": "dvae_tpu/enhance/pallas_mcem.py:112",
                "launches": launches[h_dim, fast], "max_abs_err": max_abs[h_dim, fast],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s in all")
    return entries


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def torchrun_env() -> dict:
    """The variables torchrun gives a group of one process on this card,
    and a deterministic cuBLAS workspace (both runs of a pair get it)."""
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port()), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def _same_tree(a, b) -> bool:
    """Two loaded checkpoints (tensors in dicts and lists) equal, tensors
    bitwise."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_tree, a, b))
    return a == b


def same_run_dirs(a: str, b: str, what: str) -> int:
    """Every checkpoint (``.pt``, ``.opt.pt``, ``.json``) of run dir ``b``
    equal to ``a``'s, the tensors bitwise, and the epoch logs line for line
    but the wall-clock ``Epoch: N (t s)`` lines. Returns the files held."""
    import torch

    names = sorted(f for f in os.listdir(a) if f.endswith((".pt", ".json", ".log")))
    check(names and names == sorted(f for f in os.listdir(b)
                                    if f.endswith((".pt", ".json", ".log"))),
          f"{what}: run dirs hold other files: {names} / {sorted(os.listdir(b))}")
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".pt"):
            ta, tb = (torch.load(q, map_location="cpu", weights_only=True) for q in (pa, pb))
            check(_same_tree(ta, tb), f"{what}: {name} differs")
        else:
            with open(pa) as fa, open(pb) as fb:
                ka = [x for x in fa if not x.startswith("Epoch: ")]
                kb = [x for x in fb if not x.startswith("Epoch: ")]
            check(ka == kb, f"{what}: {name} differs")
    return len(names)


def parallel_phase(model, wavs, cuda_ms, tag: str, work: str, tree: str, vad_npz: str,
                   chain_times: dict) -> list:
    """Phase 18 on the card: data parallelism (ROADMAP A14) and the AV
    fusion study (A18). The M1 ``Enhancer`` on ``make_mesh()`` against no
    mesh on the phase-3 batch at the full budget, bitwise; a two-shard mesh
    on this one card, ``Mesh([cuda:0, cuda:0])``, frozen chain against the
    unsharded run at JAX's limit (1e-4 of each utterance's peak), with
    2 x (niter + 1) B1 launches of half the rows; ``training_m1
    --data-parallel`` (K = 8, the NCCL all-reduce inside the CUDA graphs)
    and ``train_audio_net --data-parallel`` as processes under a torchrun
    environment of world size 1, each against the run without the flag,
    checkpoints and epoch logs bitwise, B2's launches counted; ``training_m1
    --multihost`` there failing loudly; and ``av_fusion_study`` on phases
    14-15's tree (``tree``), all those processes side by side. Then B1 at
    the shard's rows and B2 at the data-parallel VAD batch, against their
    plain versions and timed. Returns the kernels-line entries."""
    import torch

    from dvae_tpu_torch.data.catalog import ntcd_timit
    from dvae_tpu_torch.data.builders import NOISY_STATS
    from dvae_tpu_torch.data.datasets import UtteranceDataset
    from dvae_tpu_torch.enhance import mcem, mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.mh_chain import make_chain_noise, mh_chain_reference, run_mh_chain
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.ops.stft import StftConfig, pad_signal
    from dvae_tpu_torch.parallel import Mesh, make_mesh
    from dvae_tpu_torch.train.sequence import pad_utterances

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    data = os.path.join(tree, "data")
    proc = os.path.join(data, "subset", "processed")
    stats = os.path.join(proc, NOISY_STATS + ".npz")
    models = os.path.join(work, "models")

    # ---- 18c, started first: the trainer pairs, the loud --multihost and the
    # fusion study as processes, side by side with 18a-b
    m1_args = ["--frames", vad_npz, "--end-epoch", str(CLI_EPOCHS + 1),
               "--steps-per-dispatch", "8", "--run-name", "m1"]
    vad_args = ["--data-root", data, "--end-epoch", "2", "--std-norm", "--stats-h5", stats,
                "--run-name", "vad"]
    det = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    jobs = {
        "training_m1": spawn_module("dvae_tpu_torch.cli.training_m1", [
            *m1_args, "--models-root", os.path.join(models, "plain")], env=det),
        "training_m1 --data-parallel": spawn_module("dvae_tpu_torch.cli.training_m1", [
            *m1_args, "--models-root", os.path.join(models, "dp"), "--data-parallel"],
            env=torchrun_env()),
        "train_audio_net": spawn_module("dvae_tpu_torch.cli.train_audio_net", [
            *vad_args, "--models-root", os.path.join(models, "plain")], count_stft=True,
            env=det),
        "train_audio_net --data-parallel": spawn_module("dvae_tpu_torch.cli.train_audio_net", [
            *vad_args, "--models-root", os.path.join(models, "dp"), "--data-parallel"],
            count_stft=True, env=torchrun_env()),
        "training_m1 --multihost": spawn_module("dvae_tpu_torch.cli.training_m1", [
            *m1_args, "--models-root", os.path.join(models, "mh"), "--multihost"],
            env=torchrun_env()),
        "av_fusion_study": spawn_module("dvae_tpu_torch.cli.av_fusion_study", [
            "--data-root", data, "--models-root", os.path.join(work, "study"), "--train",
            "--epochs", "2", "--out", os.path.join(work, "study.json")]),
    }
    t_jobs = time.perf_counter()

    # ---- 18a. make_mesh() against no mesh, the phase-3 batch, full budget
    cfg = EnhancerConfig()
    mesh = make_mesh()
    check(mesh.devices == (torch.device("cuda", 0),) and mesh.size == torch.cuda.device_count(),
          f"make_mesh() on this card: {mesh!r}")
    plain_out = Enhancer(model, cfg).enhance_batch(wavs, seed=SEED)
    enh = Enhancer(model, cfg, mesh=mesh)
    mh_chain.launches = mh_chain.launches_mma = 0
    mesh_out = enh.enhance_batch(wavs, seed=SEED)
    n_mesh = mh_chain.launches_mma
    want = cfg.mcem.niter + 1
    check(n_mesh == mh_chain.launches == want, f"make_mesh() Enhancer: {n_mesh} launches")
    check(all(np.array_equal(a, c) and np.array_equal(b, d)
              for (a, b), (c, d) in zip(plain_out, mesh_out)), "make_mesh() Enhancer differs")
    log(f"phase 18: Enhancer(mesh=make_mesh()) on {mesh!r}: the phase-3 batch (B={B}, full "
        f"budget) bitwise the run without a mesh, {n_mesh} bf16-body launches (niter + 1) {tag}")

    # ---- 18b. two shards on this one card, frozen chain
    frozen = EnhancerConfig(mcem=McemConfig(var_rw=0.0, fast_stats=False), wire_dtype="float32")
    rows_seen = []

    def seen(*a, **kw):
        rows_seen.append(a[1].shape[0])
        return run_mh_chain(*a, **kw)

    one = Enhancer(model, frozen).enhance_batch(wavs, seed=SEED)
    two_enh = Enhancer(model, frozen, mesh=Mesh([dev.type + ":0"] * 2))
    mh_chain.launches = mh_chain.launches_mma = 0
    mcem.run_mh_chain = seen
    try:
        two = two_enh.enhance_batch(wavs, seed=SEED)
    finally:
        mcem.run_mh_chain = run_mh_chain
    n_two = mh_chain.launches_mma
    full_rows = enh._prepare(wavs, None, None)[4].numel()
    check(n_two == mh_chain.launches == 2 * want and rows_seen == [full_rows // 2] * (2 * want),
          f"two-shard mesh: {n_two} launches, rows {sorted(set(rows_seen))}")
    worst = max(float(np.abs(c - a).max() / (np.abs(a).max() + 1e-9))
                for (a, _), (c, _) in zip(one, two))
    check(worst <= 1e-4, f"two shards vs unsharded, frozen chain: {worst:.3e} of the peak")
    check(all(np.isfinite(c).all() and np.isfinite(n).all() for c, n in two),
          "two shards: finite outputs")
    walls = {}
    for name, e in (("unsharded", Enhancer(model, cfg)), ("two shards", Enhancer(
            model, cfg, mesh=Mesh([dev.type + ":0"] * 2)))):
        w = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            e.enhance_batch(wavs, seed=SEED)
            w.append(time.perf_counter() - t0)
        walls[name] = w
    log(f"phase 18: Mesh([cuda:0, cuda:0]) frozen chain (wire float32): {n_two} bf16-body "
        f"launches of {full_rows // 2} rows (2 x (niter + 1)), against the unsharded run max "
        f"|s_2 - s_1| {worst:.3e} of each utterance's peak (limit 1e-4); enhance_batch at the "
        f"default config, two shards on one card {', '.join(f'{t:.4f}' for t in walls['two shards'])}"
        f" s against unsharded {', '.join(f'{t:.4f}' for t in walls['unsharded'])} s (these "
        f"launches, while 18c's processes share the card) {tag}")

    # ---- 18c. the processes
    mh = jobs.pop("training_m1 --multihost")
    out = {name: collect_module(p, name, count_stft=name.startswith("train_audio_net"))
           for name, p in jobs.items()}
    try:
        _, mh_err = mh.communicate(timeout=600)
    finally:
        if mh.poll() is None:
            mh.kill()
            mh.wait()
    check(mh.returncode != 0 and "--multihost was requested" in mh_err and "torchrun" in mh_err,
          f"--multihost at world size 1 exited {mh.returncode}: {mh_err[-1500:]}")
    jobs_s = time.perf_counter() - t_jobs
    n_m1 = same_run_dirs(os.path.join(models, "plain", "m1"), os.path.join(models, "dp", "m1"),
                         "training_m1 --data-parallel")
    n_vad = same_run_dirs(os.path.join(models, "plain", "vad"), os.path.join(models, "dp", "vad"),
                          "train_audio_net --data-parallel")
    logs = {k: [x for x in out[k][0].splitlines() if x.startswith(("epoch ", "  valid:"))]
            for k in ("train_audio_net", "train_audio_net --data-parallel")}
    check(logs["train_audio_net"] and logs["train_audio_net"] == logs[
        "train_audio_net --data-parallel"], f"train_audio_net logs differ: {logs}")
    n_b2, n_b2_dp = out["train_audio_net"][1], out["train_audio_net --data-parallel"][1]
    train_ds = UtteranceDataset([(os.path.join(proc, n), os.path.join(proc, c)) for n, c in
                                 ntcd_timit.proc_noisy_clean_pair_dict(
                                     proc + "/", "train", "subset", "vad_labels", True).items()])
    valid_n = len(ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "validation", "subset",
                                                        "vad_labels", True))
    per_epoch = -(-len(train_ds) // VAD_BATCH) + -(-valid_n // VAD_BATCH)
    check(n_b2 == n_b2_dp == per_epoch, f"B2 launches {n_b2} / {n_b2_dp}, one per batch "
                                        f"({per_epoch})")
    with open(os.path.join(work, "study.json")) as fh:
        study = json.load(fh)
    f1 = {m: study["f1_per_condition"][m]["overall_mean_f1"] for m in ("audio", "video", "av")}
    check(study["protocol"]["budgets"]["epochs"] == 2 and all(
        study["training"][m]["epochs_trained"] == 1 for m in f1) and all(
        0.0 <= v <= 1.0 for v in f1.values()), f"av_fusion_study: {study}")
    log(f"phase 18: under a torchrun environment of world size 1 (NCCL): training_m1 "
        f"--data-parallel --steps-per-dispatch 8 (the all-reduce in the CUDA graphs) and "
        f"train_audio_net --data-parallel LSTMVad(513, 1024, 2), each bitwise the run without "
        f"the flag ({n_m1} and {n_vad} checkpoint and log files, the epoch logs but their wall "
        f"times), {n_b2_dp} stft_power launches in the flagged VAD run (one per batch, as "
        f"without); training_m1 --multihost there exited {mh.returncode} naming torchrun; "
        f"av_fusion_study --train --epochs 2 on phases 14-15's tree: conditions "
        f"{study['protocol']['conditions']}, mean F1 per modality {f1}, trainings "
        f"{ {k: v for k, v in study['training'].items() if k.endswith('_s')} } s; the six "
        f"processes side by side in {jobs_s:.1f} s {tag}")

    # ---- 18d. B1 at the shard's rows, B2 at the data-parallel VAD batch
    x2b, z0b, maskb = chain_times["batch"]
    half = B // 2
    n_pad = maskb.shape[1]
    rows = half * n_pad
    f, l, mc = 513, 16, cfg.mcem
    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), half, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    noise = make_chain_noise(mc.burnin_e_step + mc.nsamples_e_step, rows, l, gen, dev)
    args = (enh.mats, x2b[:half].reshape(rows, f), compute_vb(w_, h_).reshape(rows, f)
            .contiguous(), g_.reshape(rows).contiguous(), z0b[:half].reshape(rows, l)
            .contiguous(), None, noise, mc.burnin_e_step, mc.nsamples_e_step, mc.var_rw,
            False, True)
    k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
    p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
    work_ = chain_work(rows, f, l, enh.mats.widths, mc.burnin_e_step, mc.nsamples_e_step, False)
    b_ms, b_by = chain_bound_ms(work_, True)
    fargs = (*args[:9], 0.0, False, True)
    _, sk = run_mh_chain(*fargs)
    _, sr = mh_chain_reference(*fargs)
    sync()
    max_abs = float((sk - sr).abs().max())
    log(f"phase 18: mh_chain bf16 body, E-step segment at a two-shard mesh's shard ({half} x "
        f"{n_pad} = {rows} rows, steps {mc.burnin_e_step}+{mc.nsamples_e_step}): kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (kernel at "
        f"{100 * b_ms / k_ms:.2f}%); the full batch's segment (phase 4) "
        f"{chain_times['k_ms']:.4f} ms; frozen segment kernel vs plain max abs err "
        f"{max_abs:.3e} {tag}")
    stft_cfg = StftConfig(center=True)
    xp = pad_signal(torch.from_numpy(pad_utterances(train_ds, range(min(VAD_BATCH, len(train_ds))),
                                                   stft_cfg)[0])
                    .to(dev), stft_cfg).contiguous()
    b2 = time_stft(xp, True, "data-parallel VAD batch", n_b2_dp, cuda_ms, tag, phase=18)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s in all {tag}")
    return [{"name": "mh_chain (make_mesh() Enhancer)", "route": "cuda",
             "source": "dvae_tpu_torch/csrc/mh_chain.cu",
             "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n_mesh,
             "max_abs_err": chain_times["max_abs"], "ms": chain_times["k_ms"],
             "plain_ms": chain_times["p_ms"], "bound_ms": chain_times["b_ms"],
             "bound_by": chain_times["b_by"], "library_ms": None},
            {"name": "mh_chain (two-shard mesh, one card)", "route": "cuda",
             "source": "dvae_tpu_torch/csrc/mh_chain.cu",
             "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n_two,
             "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None}, b2]


# the emitted bf16 samples (fast_stats), kernel against the plain chain: each
# side rounds its own f32 Vs, so where the two straddle a bf16 rounding
# boundary they differ by one bf16 ulp (at most 2^-7 relative). The f32 body
# differs from the plain chain by f32 rounding only, so few elements flip;
# the bf16 body's own differences (BF16_MAX_REL on its 1% of elements, see
# bf16_share_limit) come on top
EMIT_ULP, EMIT_F32_SHARE = 2.0 ** -7, 1e-3
# phase 19's frozen run_mcem, the bf16 body against the plain chain at
# fast_stats: the largest mask difference (see 19d)
FAST_STATS_BF16_MASK = 5e-3


def emitted_agreement(a, b, fast: bool, units: int = 256) -> tuple:
    """bf16 samples ``a`` (kernel) against ``b`` (plain): (max relative
    difference, share of elements that differ, their limits)."""
    a, b = a.float(), b.float()
    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    differ = float((a != b).float().mean())
    if fast:
        share_lim = 1.0 - bf16_share_limit(units) + EMIT_F32_SHARE
        return rel, differ, BF16_MAX_REL + EMIT_ULP, share_lim
    return rel, differ, EMIT_ULP, EMIT_F32_SHARE


def fast_stats_phase(model, wavs, batch, frames, cuda_ms, plain_chain, agree, tag: str) -> list:
    """Phase 19 on the card: ``McemConfig.fast_stats`` (ROADMAP A15), the
    default of both packages. B1 reads bf16 x2 (and an E-step's Vb; a WF
    segment's Vb stays f32, rounded at the energy) and emits bf16 samples.
    Both bodies against the plain chain at the phase-3 batch's rows
    (``batch``: x2, z0, mask), E-step and WF, frozen at the full budget's
    steps and live; the bf16 body at 512 512 in the lean layout; pmcem's
    segments at R x those rows; the frozen-chain config through the kernel
    and the plain chain with phase 3's limits; ``enhance_batch`` at the
    full budget at fast_stats True and False (launches, medians of the
    walls, peak device memory), pmcem at fast_stats; then B1's segments and
    the NMF M-step at both settings (CUDA events) beside their bounds by
    the bytes at the planes' dtypes. Returns the kernels-line entries."""
    import torch

    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.mh_chain import (
        chain_layout,
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf, nmf_m_step
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops.stft import StftConfig

    dev, sync, half = torch.device("cuda"), torch.cuda.synchronize, torch.bfloat16
    t_phase = time.perf_counter()
    x2b, z0b, maskb = batch
    b, n_pad, f = x2b.shape
    rows, l = b * n_pad, z0b.shape[-1]
    mc = McemConfig()
    check(mc.fast_stats and mc.fast_decoder, "the default config runs fast_stats, bf16 body")
    enh = Enhancer(model, EnhancerConfig())
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    w, h, g = init_nmf(gen, b, n_pad, f, mc.nmf_rank, mc.eps, device=dev)
    x2_r = x2b.reshape(rows, f)
    vb_r = compute_vb(w, h).reshape(rows, f).contiguous()
    g_r = g.reshape(rows).contiguous()
    z_r = z0b.reshape(rows, l).contiguous()

    def body(fast):
        return "bf16" if fast else "f32"

    def planes(x2, vb, wf):
        """The planes as run_mcem hands them to the chain under fast_stats."""
        return x2.to(half), vb if wf else vb.to(half)

    def budget(wf):
        return (mc.burnin_wf, mc.nsamples_wf) if wf else (mc.burnin_e_step, mc.nsamples_e_step)

    def held(mats, x2, vb, gg, z, fast, wf, var_rw, steps, what, units=256):
        """One segment at fast_stats through the kernel and the plain chain,
        on the same planes and noise: rows that end at the same z (all of a
        frozen chain's, >= 99% of a live one's), the emission's dtype and
        agreement, the WF sums and the partition. Returns (max abs err,
        the printed comparison)."""
        noise = make_chain_noise(sum(steps), x2.shape[0], l, gen, dev)
        args = (mats, *planes(x2, vb, wf), gg, z, None, noise, *steps, var_rw, wf, fast)
        zk, *ok = run_mh_chain(*args, fast_stats=True)
        zr, *orf = mh_chain_reference(*args, fast_stats=True)
        sync()
        same = (zk - zr).abs().amax(-1) < 1e-4
        share = float(same.float().mean())
        moved = float((zk != z).any(-1).float().mean())
        if var_rw == 0.0:
            check(torch.equal(zk, z), f"{what}: the frozen chain moved")
        else:
            check(share > 0.99 and moved > 0.5, f"{what}: {share:.4f} of rows end at the same z, "
                                               f"{moved:.3f} moved")
        said = f"{share:.4f} of rows end at the same z" + (
            f" (limit 0.99), {moved:.3f} moved" if var_rw else "")
        if wf:
            said += "; " + "; ".join(agree(a[same], b_[same], fast, 1e-4 if var_rw else 1e-5,
                                           f"{what}: WF sums", units)
                                     for a, b_ in zip(ok, orf))
            part = float(((ok[0] + ok[1]) / steps[1] - 1.0).abs().max())
            check(part < 1e-5, f"{what}: WFs + WFn = 1 ({part:.3e})")
            said += f"; |WFs + WFn - 1| <= {part:.3e} (limit 1e-5)"
            err = max(float((a - b_).abs().max()) for a, b_ in zip(ok, orf))
        else:
            check(ok[0].dtype == orf[0].dtype == half, f"{what}: emitted {ok[0].dtype}")
            rel, differ, rel_lim, differ_lim = emitted_agreement(
                ok[0][:, same], orf[0][:, same], fast, units)
            check(rel <= rel_lim and differ <= differ_lim, f"{what}: bf16 samples")
            said += (f"; bf16 samples: max rel diff {rel:.3e} (limit {rel_lim:.3e}), "
                     f"{differ:.2e} of elements differ (limit {differ_lim:.2e})")
            err = float((ok[0].float() - orf[0].float()).abs().max())
        return err, said

    # ---- 19a. both bodies at the main path's rows, E-step and WF, frozen and live
    max_abs = {}
    for fast in (True, False):
        for wf in (False, True):
            for var_rw in (0.0, mc.var_rw):
                steps = budget(wf) if var_rw == 0.0 else (6, 6)
                what = (f"{body(fast)} body, {'frozen' if var_rw == 0.0 else 'live'} "
                        f"{'WF' if wf else 'E-step'} segment, {steps[0]}+{steps[1]} steps")
                err, said = held(enh.mats, x2_r, vb_r, g_r, z_r, fast, wf, var_rw, steps, what)
                if var_rw == 0.0:
                    max_abs[fast, wf] = err
                log(f"phase 19: fast_stats, {what} at {rows} rows: {said}")

    # ---- 19b. the lean layout: the bf16 body at 512 512 in WF mode
    wide = extract_decoder_mlp(
        init_xavier_(VAE(f, l, (512, 512)), torch.Generator().manual_seed(SEED)).to(dev), l)
    check(chain_layout(wide, f, l, True, True) == "lean", "512 512 WF runs the lean layout")
    for var_rw in (0.0, mc.var_rw):
        what = f"bf16 body 512 512 (lean layout), {'frozen' if var_rw == 0.0 else 'live'} WF"
        _, said = held(wide, x2_r, vb_r, g_r, z_r, True, True, var_rw, (6, 6), what, 1024)
        log(f"phase 19: fast_stats, {what} segment, 6+6 steps at {rows} rows: {said}")

    # ---- 19c. pmcem's segments at R x the rows (the R copies of bf16 planes)
    r = mc.pmcem_chains
    x2_p, vb_p, g_p = x2_r.repeat(r, 1), vb_r.repeat(r, 1), g_r.repeat(r)
    z_p = z_r.repeat(r, 1) + math.sqrt(mc.var_rw) * torch.randn(
        (r * rows, l), generator=gen, device=dev)
    pm_steps = {False: (mc.pmcem_steps - 1, 1),
                True: (mc.pmcem_wf_burn, -(-mc.nsamples_wf // r))}
    for wf in (False, True):
        for var_rw in (0.0, mc.var_rw):
            what = (f"pmcem {'frozen' if var_rw == 0.0 else 'live'} {'WF' if wf else 'E-step'} "
                    f"segment, {pm_steps[wf][0]}+{pm_steps[wf][1]} steps")
            _, said = held(enh.mats, x2_p, vb_p, g_p, z_p, True, wf, var_rw, pm_steps[wf], what)
            log(f"phase 19: fast_stats, bf16 body, {what} at {r * rows} rows: {said}")
    del x2_p, vb_p, g_p, z_p

    # ---- 19d. the frozen-chain config at fast_stats, kernel vs plain, phase 3's
    # limits but the bf16 body's masks: its Vs differs from the plain chain's
    # by up to ~1e-3 in a few rows, and where that puts the two sides of a bf16
    # boundary a sample, then an R-sum, moves by one bf16 ulp (~0.4-0.8%) in
    # every EM iteration: measured 2.656e-3 here (NVIDIA H100 80GB HBM3, 700 W)
    # against 1.2e-4 at phase 3's f32 planes
    for fast in (True, False):
        frozen_vs_plain(model, McemConfig(var_rw=0.0, fast_decoder=fast), wavs, batch, frames,
                        plain_chain, f"fast_stats {body(fast)}", 19,
                        mask_limit=FAST_STATS_BF16_MASK if fast else 1e-3)

    # ---- 19e. enhance_batch at the full budget, fast_stats True and False
    stft_cfg = StftConfig()
    nfft, hop = stft_cfg.nfft, stft_cfg.hop

    def partition_err(out):
        worst = 0.0
        for (s_, n_), x, fr in zip(out, wavs, frames):
            core = slice(nfft, min(len(x), (fr - 1) * hop + nfft) - nfft)
            worst = max(worst, float(np.abs(s_ + n_ - x)[core].max()) / float(np.abs(x).max()))
        return worst

    enhancers = {stats: Enhancer(model, EnhancerConfig(mcem=McemConfig(fast_stats=stats)))
                 for stats in (True, False)}
    seen_main, peak_gib = {}, {}
    for stats, e in enhancers.items():
        sync()
        torch.cuda.reset_peak_memory_stats()
        mh_chain.launches = mh_chain.launches_mma = mh_chain.launches_resident = 0
        with chain_calls() as seen:
            out = e.enhance_batch(wavs, seed=SEED)
        peak_gib[stats] = torch.cuda.max_memory_allocated() / 2**30
        n_all, n_mma, n_res = mh_chain.launches, mh_chain.launches_mma, mh_chain.launches_resident
        want = [(rows, False)] * mc.niter + [(rows, True)]
        part = partition_err(out)
        finite = (all(np.isfinite(s_).all() and np.isfinite(n_).all() for s_, n_ in out)
                  and np.isfinite(e.last_cost).all())
        log(f"phase 19: enhance_batch B={b} fast_stats={stats}: {n_all} mh_chain launches "
            f"({n_mma} of the bf16 body, {n_res} in the resident layout; expected niter + 1 = "
            f"{mc.niter + 1}, niter E-step segments resident at fast_stats), cost "
            f"{e.last_cost[0]:.5f} -> {e.last_cost[-1]:.5f}, outputs finite: {finite}, Wiener "
            f"partition {part:.3e} (limit 1e-4); peak device memory {peak_gib[stats]:.3f} GiB "
            f"{tag}")
        check(n_all == n_mma == mc.niter + 1 and seen == want
              and n_res == (mc.niter if stats else 0), f"fast_stats={stats}: launches")
        check(finite and part < 1e-4, f"fast_stats={stats}: finite outputs, partition")
        seen_main[stats] = seen
    walls = {True: [], False: []}
    for _ in range(3):
        for stats, e in enhancers.items():
            sync()
            t0 = time.perf_counter()
            e.enhance_batch(wavs, seed=SEED)
            walls[stats].append(time.perf_counter() - t0)
    wall = {stats: float(np.median(v)) for stats, v in walls.items()}

    pm = Enhancer(model, EnhancerConfig(engine="pmcem"))
    mh_chain.launches = mh_chain.launches_mma = 0
    with chain_calls() as seen_pm:
        out = pm.enhance_batch(wavs, seed=SEED)
    n_pm = mh_chain.launches_mma
    check(n_pm == mh_chain.launches == mc.niter + 1
          and seen_pm == [(r * rows, False)] * mc.niter + [(r * rows, True)], "pmcem launches")
    part = partition_err(out)
    check(all(np.isfinite(s_).all() for s_, _ in out) and part < 1e-4, "pmcem outputs")
    log(f"phase 19: enhance_batch B={b} pmcem at fast_stats: {n_pm} bf16-body launches at "
        f"{r * rows} rows, Wiener partition {part:.3e} (limit 1e-4)")

    # ---- 19f. times: B1's segments and the M-step at both settings, beside the bounds
    seg = {}
    for fast, wf, stats in ((True, False, True), (True, False, False), (True, True, True),
                            (True, True, False), (False, False, True)):
        steps = budget(wf)
        noise = make_chain_noise(sum(steps), rows, l, gen, dev)
        x2s, vbs = planes(x2_r, vb_r, wf) if stats else (x2_r, vb_r)
        args = (enh.mats, x2s, vbs, g_r, z_r, None, noise, *steps, mc.var_rw, wf, fast)
        k_ms = cuda_ms(lambda: run_mh_chain(*args, fast_stats=stats), reps=10, warm=2)
        p_ms = cuda_ms(lambda: mh_chain_reference(*args, fast_stats=stats), reps=3)
        work = chain_work(rows, f, l, enh.mats.widths, *steps, wf, stats)
        b_ms, b_by = chain_bound_ms(work, fast)
        seg[fast, wf, stats] = (k_ms, p_ms, b_ms, b_by)
        log(f"phase 19: mh_chain {body(fast)} body, {'WF' if wf else 'E-step'} segment "
            f"fast_stats={stats}, rows={rows} steps={steps[0]}+{steps[1]}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({work[3] / 1e6:.1f} MB), "
            f"kernel at {100 * b_ms / k_ms:.2f}% of bound {tag}")
    pm_steps_e = pm_steps[False]
    x2_p, vb_p = (t.repeat(r, 1) for t in planes(x2_r, vb_r, False))
    g_p, z_p = g_r.repeat(r), z_r.repeat(r, 1)
    noise = make_chain_noise(sum(pm_steps_e), r * rows, l, gen, dev)
    args = (enh.mats, x2_p, vb_p, g_p, z_p, None, noise, *pm_steps_e, mc.var_rw, False, True)
    pk_ms = cuda_ms(lambda: run_mh_chain(*args, fast_stats=True), reps=10, warm=2)
    pp_ms = cuda_ms(lambda: mh_chain_reference(*args, fast_stats=True), reps=3)
    fargs = (*args[:9], 0.0, False, True)
    _, sk = run_mh_chain(*fargs, fast_stats=True)
    _, sr = mh_chain_reference(*fargs, fast_stats=True)
    pm_abs = float((sk.float() - sr.float()).abs().max())
    pwork = chain_work(r * rows, f, l, enh.mats.widths, *pm_steps_e, False, True)
    pb_ms, pb_by = chain_bound_ms(pwork, True)
    log(f"phase 19: mh_chain bf16 body, pmcem E-step segment fast_stats, rows={r * rows} "
        f"steps={pm_steps_e[0]}+{pm_steps_e[1]}: kernel {pk_ms:.4f} ms, plain {pp_ms:.4f} ms, "
        f"bound {pb_ms:.4f} ms by {pb_by} ({pwork[3] / 1e6:.1f} MB) {tag}")
    del x2_p, vb_p, g_p, z_p, noise, args, fargs, sk, sr

    m_ms = {}
    for stats in (True, False):
        vs_s = (torch.rand((mc.nsamples_e_step, b, n_pad, f), generator=gen, device=dev) + 0.05
                ).to(half if stats else torch.float32)
        m_ms[stats] = cuda_ms(lambda: nmf_m_step(x2b, vs_s, w, h, g, maskb, mc.eps), reps=5)
        fl, nbytes = m_step_work(mc.nsamples_e_step, b, n_pad, f, 2 if stats else 4)
        mb_ms, mb_by = bound_ms(fl, nbytes)
        log(f"phase 19: nmf_m_step R={mc.nsamples_e_step} B={b} N={n_pad} on "
            f"{'bf16' if stats else 'f32'} samples: {m_ms[stats]:.4f} ms, bound {mb_ms:.4f} ms "
            f"by {mb_by} ({nbytes / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP), at "
            f"{100 * mb_ms / m_ms[stats]:.2f}% of bound {tag}")
        del vs_s
    for stats in (True, False):
        chain_s = (mc.niter * seg[True, False, stats][0] + seg[True, True, stats][0]) / 1e3
        m_s = mc.niter * m_ms[stats] / 1e3
        log(f"phase 19: enhance_batch B={b} fast_stats={stats} wall "
            f"{', '.join(f'{t:.4f}' for t in walls[stats])} s (median {wall[stats]:.4f} s, "
            f"{b / wall[stats]:.2f} utt/s); chain (bf16 body) {chain_s:.4f} s "
            f"({100 * chain_s / wall[stats]:.1f}%), M-step {m_s:.4f} s "
            f"({100 * m_s / wall[stats]:.1f}%), rest {wall[stats] - chain_s - m_s:.4f} s; peak "
            f"device memory {peak_gib[stats]:.3f} GiB {tag}")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s in all")

    def entry(name, launches, t, err):
        k_ms, p_ms, b_ms, b_by = t
        return {"name": name, "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": launches,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    def estep(seen):
        return sum(not wf for _, wf in seen)

    n_e = estep(seen_main[True])
    return [entry("mh_chain (fast_stats, E-step)", n_e, seg[True, False, True],
                  max_abs[True, False]),
            entry("mh_chain (fast_stats, WF)", len(seen_main[True]) - n_e,
                  seg[True, True, True], max_abs[True, True]),
            entry("mh_chain (fast_stats, pmcem E-step)", estep(seen_pm),
                  (pk_ms, pp_ms, pb_ms, pb_by), pm_abs)]


# phase 20's decoders (as --h-dim takes them; the decoder's hidden widths
# are their reverse): the kernel against its plain chain in each body
# (the f32 body's 128 128, 640, 640 x 9 and 1024 + 64 x 8, whose table
# lists two widths, and the bf16 body's 128 128 complete the layouts x
# modes x decoder routes of the others), the Enhancer end to end, the CLI
ANY_F32 = ((), (128,) * 9, (64,) * 16, (1024,), (1024, 1024, 1024), (128, 128), (640,),
           (640,) * 9, (1024,) + (64,) * 8)
ANY_BF16 = ((128, 128), (1024, 1024), (2048, 2048))
ANY_E2E = ((), (128,) * 9, (1024,), (1024, 1024))
ANY_CLI = (1024, 1024)


def decoder_route(widths: tuple, fast: bool) -> str:
    """Where B1 reads a decoder's hidden layers: its kernel arguments carry
    1 to 8 (MAX_HIDDEN in csrc/mh_chain.cu); the f32 body reads any other
    depth, 0 too, from a table in device memory."""
    return "arguments" if fast or 1 <= len(widths) <= 8 else "table"


def any_decoder_phase(wavs, batch, frames, cuda_ms, plain_chain, agree, tag: str,
                      work: str) -> list:
    """Phase 20 on the card: B1 at decoders of no hidden layer, more than 8
    hidden layers and widths past 512 (ROADMAP A10b), in the shared, lean
    and wide layouts of both bodies and both of the f32 body's decoder
    routes; the CLI alone on the card, after the times. ``batch`` is the
    phase-3 batch as the engines see it (x2, mask) and ``frames`` its frame
    counts. Returns the kernels-line entries of the end-to-end shapes."""
    import torch

    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.mh_chain import (
        LAYOUTS,
        chain_layout,
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
        wide_scratch_bytes,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import init_xavier_

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t_phase = time.perf_counter()
    x2b, maskb = batch
    b, n_pad, f = x2b.shape
    l, rows = 16, b * n_pad
    mc = McemConfig()
    norm = power_norm(x2b, maskb)
    shapes = [(h, False) for h in ANY_F32] + [(h, True) for h in ANY_BF16]

    def model_of(h_dim):
        return init_xavier_(VAE(f, l, h_dim), torch.Generator().manual_seed(SEED))

    def body(fast):
        return "bf16" if fast else "f32"

    def hd(h_dim):
        return " ".join(map(str, h_dim)) or "(none)"

    # ---- 20a. each shape against its plain chain at the phase-3 batch's rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    x2 = torch.rand((rows, f), generator=gen, device=dev) + 0.05
    vb = torch.rand((rows, f), generator=gen, device=dev) + 0.05
    g = torch.rand((rows,), generator=gen, device=dev) + 0.5
    z0 = 0.1 * torch.randn((rows, l), generator=gen, device=dev)
    max_abs, seen = {}, set()

    def kernel_vs_plain(mats, fast, wf, units, what, y=None):
        """Frozen (2 + 3 steps) and live (6 + 6) segments, kernel against
        plain; returns the printed comparisons."""
        noise = make_chain_noise(5, rows, l, gen, dev)
        args = (mats, x2, vb, g, z0, y, noise, 2, 3, 0.0, wf, fast)
        zk, *ok = run_mh_chain(*args)
        zr, *orf = mh_chain_reference(*args)
        sync()
        check(torch.equal(zk, z0), f"{what}: the frozen chain moved")
        said = [agree(a, b_, fast, 1e-5, f"frozen {what}", units) for a, b_ in zip(ok, orf)]
        frozen_abs = float((ok[0].float() - orf[0].float()).abs().max())
        noise = make_chain_noise(12, rows, l, gen, dev)
        args = (mats, x2, vb, g, z0, y, noise, 6, 6, 0.01, wf, fast)
        zk, *ok = run_mh_chain(*args)
        zr, *orf = mh_chain_reference(*args)
        sync()
        same = (zk - zr).abs().amax(-1) < 1e-4
        share, moved = float(same.float().mean()), float((zk != z0).any(-1).float().mean())
        check(share > 0.99 and moved > 0.5, f"live {what}: rows that end at the same z")
        said += [agree(a[..., same, :], b_[..., same, :], fast, 1e-4, f"live {what}", units)
                 for a, b_ in zip(ok, orf)]
        n = len(ok)
        return (f"frozen {'; '.join(said[:n])}; live {share:.4f} of rows end at the same z "
                f"(limit 0.99), {moved:.3f} moved, on them {'; '.join(said[n:])}"), frozen_abs

    for h_dim, fast in shapes:
        mats = extract_decoder_mlp(model_of(h_dim).to(dev), l)
        for wf in (False, True):
            layout = chain_layout(mats, f, l, wf, fast)
            route = decoder_route(mats.widths, fast)
            seen.add((layout, fast, wf, route))
            said, frozen_abs = kernel_vs_plain(mats, fast, wf, sum(h_dim),
                                               f"{hd(h_dim)} {body(fast)} WF={wf}")
            if not wf:
                max_abs[h_dim, fast] = frozen_abs
            log(f"phase 20: {body(fast)} body, --h-dim {hd(h_dim)} (decoder widths "
                f"{mats.widths}), {'WF' if wf else 'E-step'} segments at {rows} rows, "
                f"{layout} layout, layers from the {route}: {said}")
    # an M2 decoder (dec_only, y_dim 1) with no hidden layer: the label's
    # product and b_out folded into an output row bias (rows, F)
    mats0 = extract_decoder_mlp(model_of(()).to(dev), l)
    cmats = mats0._replace(w1y=0.3 * torch.randn((1, f), generator=gen, device=dev))
    y = torch.rand((rows, 1), generator=gen, device=dev)
    for wf in (False, True):
        said, _ = kernel_vs_plain(cmats, False, wf, 256, f"depth 0, y_dim 1, WF={wf}", y)
        log(f"phase 20: f32 body, no hidden layer with a conditioned output row bias "
            f"(rows, {f}) from y_dim 1, {'WF' if wf else 'E-step'} segments at {rows} rows, "
            f"{chain_layout(cmats, f, l, wf, False)} layout: {said}")
    want = {(lay, fast, wf, route) for lay in LAYOUTS for fast in (False, True)
            for wf in (False, True) for route in ("arguments", "table")
            if not (fast and route == "table")}
    check(seen == want, f"layouts x bodies x modes x decoder routes run: missing "
          f"{sorted(want - seen)}")
    log(f"phase 20: every layout ({', '.join(LAYOUTS)}) x body x mode x decoder route "
        f"(the f32 body's layers from its arguments or the device table) ran against the "
        f"plain chain ({len(seen)} of {len(want)})")

    # ---- 20b. pmcem's E-step segment at R x the rows, (2048, 2048) in the wide layout
    wide = extract_decoder_mlp(model_of((2048, 2048)).to(dev), l)
    r = mc.pmcem_chains
    steps = (mc.pmcem_steps - 1, 1)
    x2r = x2.to(torch.bfloat16).repeat(r, 1)
    vbr = vb.to(torch.bfloat16).repeat(r, 1)
    gr, zr0 = g.repeat(r), z0.repeat(r, 1)
    noise = make_chain_noise(sum(steps), r * rows, l, gen, dev)
    args = (wide, x2r, vbr, gr, zr0, None, noise, *steps, mc.var_rw, False, True, True)
    scratch = [wide_scratch_bytes(wide, n, f, l, False, True, True, dev)
               for n in (rows, r * rows)]
    check(scratch[0] == scratch[1] > 0, f"pmcem wide scratch {scratch} grows with the rows")
    sync()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zk, sk = run_mh_chain(*args)
    sync()
    peak = torch.cuda.max_memory_allocated()
    pm_ms = cuda_ms(lambda: run_mh_chain(*args), reps=2)
    zp, sp = mh_chain_reference(*args)
    sync()
    same = (zk - zp).abs().amax(-1) < 1e-4
    check(float(same.float().mean()) > 0.99, "pmcem (2048, 2048): rows that end at the same z")
    rel, differ, rel_lim, share_lim = emitted_agreement(sk[:, same], sp[:, same], True, 4096)
    check(rel < rel_lim and differ <= share_lim, "pmcem (2048, 2048): emission")
    pm_work = chain_work(r * rows, f, l, wide.widths, *steps, False, True)
    pm_b, pm_by = chain_bound_ms(pm_work, True)
    log(f"phase 20: pmcem E-step segment at (2048, 2048), {r} x {rows} = {r * rows} rows, "
        f"{steps[0]}+{steps[1]} steps, bf16 planes, {chain_layout(wide, f, l, False, True)} "
        f"layout: scratch {scratch[0] / 2**20:.2f} MiB at {rows} and at {r * rows} rows; "
        f"peak device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above "
        f"the {held / 2**30:.3f} GiB held before the launch); kernel {pm_ms:.4f} ms, bound "
        f"{pm_b:.4f} ms by {pm_by} ({100 * pm_b / pm_ms:.2f}%); against the plain chain "
        f"{float(same.float().mean()):.4f} of rows end at the same z, their samples max rel "
        f"{rel:.3e} (limit {rel_lim:.3e}), {differ:.2e} of elements differ (limit "
        f"{share_lim:.2e}) {tag}")
    del x2r, vbr, gr, zr0, noise, args, zk, sk, zp, sp

    # ---- 20c. the M1 Enhancer at B = 32 and the full budget, each end-to-end shape
    launches = {}
    for h_dim in ANY_E2E:
        model = model_of(h_dim)
        fast = len(h_dim) == 2
        cfg = EnhancerConfig(norm=None if h_dim else norm)
        enh = Enhancer(model, cfg)
        mh_chain.launches = mh_chain.launches_mma = 0
        t0 = time.perf_counter()
        with no_plain_chain():
            out = enh.enhance_batch(wavs, seed=SEED)
        sync()
        wall = time.perf_counter() - t0
        n_all, n_mma = mh_chain.launches, mh_chain.launches_mma
        launches[h_dim] = n_all
        finite = all(np.isfinite(s_).all() and np.isfinite(n_).all() and len(s_) == len(x)
                     for (s_, n_), x in zip(out, wavs)) and np.isfinite(enh.last_cost).all()
        log(f"phase 20: enhance_batch B={B} --h-dim {hd(h_dim)}, default config"
            f"{' with std-normalized input' if not h_dim else ''}: {n_all} mh_chain "
            f"launches, {n_mma} of the bf16 body (expected niter + 1 = {mc.niter + 1} of the "
            f"{body(fast)} body), no plain chain; cost {enh.last_cost[0]:.5f} -> "
            f"{enh.last_cost[-1]:.5f}; outputs finite: {finite}; {wall:.3f} s {tag}")
        check(n_all == mc.niter + 1 and n_mma == (n_all if fast else 0),
              f"{h_dim}: launches of the {body(fast)} body")
        check(finite, f"{h_dim}: finite outputs")
        enc_in = x2b if h_dim else (x2b - torch.from_numpy(norm[0]).to(dev)) / (
            torch.from_numpy(norm[1]).to(dev) + cfg.norm_eps)
        with torch.inference_mode():
            z0b = enh.model.encode(enc_in, sample=False)[1]
        # a frozen chain at a cut budget: every step accepts, so ten EM
        # iterations show what a hundred would
        frozen_vs_plain(model, McemConfig(niter=10, var_rw=0.0, fast_stats=False), wavs,
                        (x2b, z0b, maskb), frames, plain_chain,
                        f"--h-dim {hd(h_dim)} {body(fast)}", 20, norm=cfg.norm)

    # ---- 20d. times at the phase-3 batch's rows, each beside its bound
    w_, h_, g_ = init_nmf(torch.Generator(device=dev).manual_seed(SEED), b, n_pad, f,
                          mc.nmf_rank, mc.eps, device=dev)
    planes = (x2b.reshape(rows, f), compute_vb(w_, h_).reshape(rows, f).contiguous(),
              g_.reshape(rows).contiguous())
    entries = []
    for h_dim, fast in shapes:
        mats = extract_decoder_mlp(model_of(h_dim).to(dev), l)
        times = {}
        for wf in (False, True):
            n_burn = mc.burnin_wf if wf else mc.burnin_e_step
            n_samp = mc.nsamples_wf if wf else mc.nsamples_e_step
            noise = make_chain_noise(n_burn + n_samp, rows, l, gen, dev)
            args = (mats, *planes, z0, None, noise, n_burn, n_samp, mc.var_rw, wf, fast)
            k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=2)
            p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=1)
            work_ = chain_work(rows, f, l, mats.widths, n_burn, n_samp, wf)
            b_ms, b_by = chain_bound_ms(work_, fast)
            times[wf] = (k_ms, p_ms, b_ms, b_by)
            log(f"phase 20: mh_chain {body(fast)} body, --h-dim {hd(h_dim)}, "
                f"{'WF' if wf else 'E-step'} segment rows={rows} steps={n_burn}+{n_samp}, "
                f"{chain_layout(mats, f, l, wf, fast)} layout, layers from the "
                f"{decoder_route(mats.widths, fast)}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({work_[0] / 1e9:.2f} GFLOP of "
                f"products, {work_[3] / 1e6:.1f} MB), kernel at {100 * b_ms / k_ms:.2f}% of "
                f"bound {tag}")
        if h_dim in launches and fast == (len(h_dim) == 2):
            k_ms, p_ms, b_ms, b_by = times[False]  # the E-step segment
            entries.append({
                "name": f"mh_chain{'' if fast else '_f32'} (--h-dim {hd(h_dim)})",
                "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": launches[h_dim],
                "max_abs_err": max_abs[h_dim, fast], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # ---- 20e. evaluate_ntcd_m1 --h-dim 1024 1024 as a process, alone on the
    # card, from a .pt of seeded random weights
    pt = os.path.join(work, "m1_hdim_1024_1024.pt")
    torch.save(model_of(ANY_CLI).state_dict(), pt)
    noisy = sweep_tree(work, 16, SEED + 11)
    sync()
    t_cli = time.perf_counter()
    cli = spawn_module("dvae_tpu_torch.cli.evaluate_ntcd_m1",
                       ["--data-root", os.path.join(work, "data"), "--snr", "all",
                        "--batch-size", "16", "--checkpoint", pt, "--h-dim", *map(str, ANY_CLI),
                        "--output-dir", os.path.join(work, "eval")], count_chain=True)
    _, (n_chain, n_mma) = collect_module(cli, "evaluate_ntcd_m1 --h-dim 1024 1024",
                                         count_chain=True)
    wall = time.perf_counter() - t_cli
    files = sorted(os.path.relpath(os.path.join(d, x), os.path.join(work, "eval"))
                   for d, _, xs in os.walk(os.path.join(work, "eval")) for x in xs)
    want = sorted(f"{os.path.splitext(p_)[0]}{k}.wav" for p_ in noisy for k in ("_s_est", "_n_est"))
    batches = -(-len(noisy) // 16)
    log(f"phase 20: evaluate_ntcd_m1 --h-dim {hd(ANY_CLI)} from a .pt of seeded random weights "
        f"over {len(noisy)} utterances of phase 10's sweep tree ({wall:.1f} s from spawn to "
        f"exit, alone on the card): {len(files)} files, {n_chain} mh_chain launches, "
        f"{n_mma} of the bf16 body (expected {batches} batches x (niter + 1) = "
        f"{batches * (mc.niter + 1)}) {tag}")
    check(files == want and n_chain == n_mma == batches * (mc.niter + 1),
          "evaluate_ntcd_m1 --h-dim 1024 1024: outputs and bf16-body launches")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s in all")
    return entries


def m_step_phase(x2b, maskb, mc, cuda_ms, tag: str, launches: int) -> dict:
    """Phase 4's M-step: the fused kernel (``csrc/nmf_mstep.cu``) against
    ``nmf_m_step_reference`` on the same card tensors at the main path's
    shapes (R = ``mc.nsamples_e_step``, B of the phase-3 batch and the
    served 8, its first utterances; N as ``enhance_batch`` padded it; K =
    ``mc.nmf_rank``), on bf16 and f32 samples: three launches a call, and
    the relative L2 per utterance of W, H, g and Vb within 1e-4 (bf16) or
    1e-5 (f32); then each call timed (CUDA events) beside the plain body
    and ``m_step_work``'s bound. Returns the kernels-line entry of the
    offline cells' call (the whole batch, bf16 samples) with ``launches``,
    the main path's count per ``enhance_batch``."""
    import torch

    from dvae_tpu_torch.enhance import nmf

    def rel_l2(a, b):
        a, b = a.double().flatten(1), b.double().flatten(1)
        d, n = (a - b).norm(dim=1), b.norm(dim=1)
        return float(torch.where(n > 0, d / n.clamp_min(1e-300), d).max())

    dev = x2b.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    r, (b_all, n, f) = mc.nsamples_e_step, x2b.shape
    got = {}
    for b in (b_all, 8):
        x2, mask = x2b[:b].contiguous(), maskb[:b].contiguous()
        w, h, g = nmf.init_nmf(gen, b, n, f, mc.nmf_rank, mc.eps, device=dev)
        for dtype, tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-5)):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            vs = (torch.rand((r, b, n, f), generator=gen, device=dev) + 0.05).to(dtype)
            args = (x2, vs, w, h, g, mask, mc.eps)
            before = nmf.launches
            kernel = nmf.nmf_m_step(*args)
            per_call = nmf.launches - before
            plain = nmf.nmf_m_step_reference(*args)
            rel = max(rel_l2(a, p) for a, p in zip(kernel, plain))
            abs_err = max(float((a - p).abs().max()) for a, p in zip(kernel, plain))
            check(per_call == 3, f"M-step B={b} {name}: {per_call} kernel launches, expected 3")
            check(all(bool(torch.isfinite(a).all()) for a in kernel) and rel <= tol,
                  f"M-step B={b} {name}: kernel vs plain, relative L2 {rel:.3e} (limit {tol:g})")
            k_ms = cuda_ms(lambda: nmf.nmf_m_step(*args), reps=30, warm=2)
            p_ms = cuda_ms(lambda: nmf.nmf_m_step_reference(*args), reps=5)
            b_ms, b_by = bound_ms(*m_step_work(r, b, n, f, vs.element_size()))
            log(f"phase 4: nmf_m_step R={r} B={b} N={n} F={f} K={mc.nmf_rank} on {name} "
                f"samples: relative L2 {rel:.3e} (limit {tol:g}), max abs err {abs_err:.3e}; "
                f"kernel {k_ms:.4f} ms ({per_call} launches), plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}, kernel at {100 * b_ms / k_ms:.2f}% of bound {tag}")
            got[b, name] = {"max_abs_err": abs_err, "max_rel_l2": rel, "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            del vs, args, kernel, plain
    return {"name": "nmf_mstep", "route": "cuda", "source": "dvae_tpu_torch/csrc/nmf_mstep.cu",
            "replaces": None, "launches": launches, **got[b_all, "bf16"], "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvae_tpu_torch.enhance import mcem, mh_chain, nmf
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.mh_chain import (
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf
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

    def agree(a, b, fast, rtol, what, units=256):
        """Kernel vs plain of its precision: rtol for the f32 body, the bf16
        rule for the tensor-core body (its share limit for a decoder of
        ``units`` hidden units, :func:`bf16_share_limit`). Returns the
        printed comparison."""
        if not fast:
            err = rel_err(a, b)
            check(err < rtol, what)
            return f"max rel err {err:.3e} (limit {rtol:g})"
        worst, share = bf16_rule(a, b)
        limit = bf16_share_limit(units)
        check(worst < BF16_MAX_REL and share >= limit, what)
        return (f"max rel err {worst:.3e} (limit {BF16_MAX_REL:g}), {share:.5f} of "
                f"elements within {BF16_REL:g} (limit {limit:g})")

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
    cmats = mats._replace(w1y=w1y)
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
    mh_chain.launches = mh_chain.launches_mma = mh_chain.launches_resident = nmf.launches = 0
    t0 = time.perf_counter()
    out = enh.enhance_batch(wavs, seed=SEED)
    t_first = time.perf_counter() - t0
    launches, launches_mma, launches_m = mh_chain.launches, mh_chain.launches_mma, nmf.launches
    launches_res = mh_chain.launches_resident
    want = cfg.mcem.niter + 1
    log(f"phase 3: enhance_batch B={B} ran {launches_mma} launches of the bf16 "
        f"tensor-core body, {launches_res} of them in the resident layout (expected the "
        f"niter = {cfg.mcem.niter} E-step segments, not the WF one), {launches} mh_chain "
        f"launches in all (expected niter + 1 = {want}), {launches_m} launches of the fused "
        f"M-step (expected 3 niter = {3 * cfg.mcem.niter}), first call {t_first:.3f} s")
    check(launches_mma == launches == want, f"{launches_mma} bf16 body launches of "
          f"{launches}, expected {want}")
    check(launches_res == cfg.mcem.niter, f"{launches_res} resident-layout launches, expected "
          f"{cfg.mcem.niter}")
    check(launches_m == 3 * cfg.mcem.niter, f"{launches_m} M-step kernel launches, expected "
          f"{3 * cfg.mcem.niter}")
    check(len(out) == B and all(len(s) == len(x) == len(n) for (s, n), x in zip(out, wavs)),
          "output count and lengths")
    check(all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out), "finite outputs")
    cost = enh.last_cost
    check(cost.shape == (cfg.mcem.niter,) and np.isfinite(cost).all(), "finite cost trajectory")
    log(f"phase 3: cost {cost[0]:.5f} -> {cost[-1]:.5f}, outputs finite")

    enh32 = Enhancer(model, EnhancerConfig(mcem=McemConfig(fast_decoder=False)))
    mh_chain.launches = mh_chain.launches_mma = mh_chain.launches_resident = 0
    out32 = enh32.enhance_batch(wavs, seed=SEED)
    launches_f32 = mh_chain.launches - mh_chain.launches_mma
    log(f"phase 3: enhance_batch with fast_decoder=False ran {launches_f32} launches of "
        f"the f32 body ({mh_chain.launches_mma} of the bf16 body, "
        f"{mh_chain.launches_resident} in the resident layout); cost "
        f"{enh32.last_cost[0]:.5f} -> {enh32.last_cost[-1]:.5f}")
    check(launches_f32 == want and mh_chain.launches_mma == mh_chain.launches_resident == 0,
          "f32 body launch count")
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
        frozen_vs_plain(model, McemConfig(var_rw=0.0, fast_decoder=fast, fast_stats=False), wavs,
                        (x2b, z0b, maskb), frames, plain_chain, "bf16" if fast else "f32", 3)
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
            work = chain_work(rows_main, f, l, enh.mats.widths, n_burn, n_samp, wf)
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

    m_step_entry = m_step_phase(x2b, maskb, mc, cuda_ms, tag, launches_m)
    m_ms = m_step_entry["ms"]

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as keep:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
            labelled_entries, m2_vad = labelled_training_phase(wavs, cleans, cuda_ms, agree,
                                                               tag, work, keep)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
            cli_entries, kept = cli_chain_phase(wavs, cleans, cuda_ms, agree, tag, work, keep)
        said_f1 = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as tree:
            audio_entries = audio_vad_phase(m2_vad, cuda_ms, agree, tag, tree, said_f1)
            video_entries = video_vad_phase(m2_vad, cuda_ms, agree, tag, tree, said_f1)
            scoring_entries = scoring_phase(dict(kept, m2=m2_vad), said_f1, cuda_ms, tag, tree)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
                depth_entries = depth_phase(wavs, cleans, (x2b, maskb), frames, cuda_ms,
                                            plain_chain, agree, tag, work, kept["vad_npz"])
            k_ms, p_ms, b_ms, b_by = times[True, False]
            with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
                parallel_entries = parallel_phase(
                    model, wavs, cuda_ms, tag, work, tree, kept["vad_npz"],
                    {"batch": (x2b, z0b, maskb), "k_ms": k_ms, "p_ms": p_ms, "b_ms": b_ms,
                     "b_by": b_by, "max_abs": max_abs[True]})
    fast_stats_entries = fast_stats_phase(model, wavs, (x2b, z0b, maskb), frames, cuda_ms,
                                          plain_chain, agree, tag)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        any_entries = any_decoder_phase(wavs, (x2b, maskb), frames, cuda_ms, plain_chain, agree,
                                        tag, work)
    peem_profile(enh.mats, (x2b, z0b, maskb), cfg.mcem, tag)

    def m1_chain_entry(name, fast, n):
        k_ms, p_ms, b_ms, b_by = times[fast, False]  # the E-step segment
        return {"name": name, "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
                "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": n,
                "max_abs_err": max_abs[fast], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    log(json.dumps({"kernels": [m1_chain_entry("mh_chain", True, launches_mma),
                                m1_chain_entry("mh_chain_f32", False, launches_f32),
                                m_step_entry, *stft_entries, *cond_entries, *engine_entries,
                                *serving_entries, *labelled_entries, *cli_entries,
                                *audio_entries, *video_entries, *scoring_entries,
                                *depth_entries, *parallel_entries, *fast_stats_entries,
                                *any_entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kstep-profile"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(kstep_profile(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
