"""Frame-set builder core (port of the per-utterance part of
``dvae_tpu.data.builders.build_frame_dataset``).

:func:`build_frames` turns clean utterances into the linear-power frame
rows the VAE trainers consume, with the train statistics beside them and,
when asked, each row's VAD or IBM label (``_labels_for`` of the JAX
builder). The spectrogram runs on the device through
:mod:`dvae_tpu_torch.ops.stft_power` in one launch: each utterance gets its
own padding (the end-pad quirk depends on its own length), the padded
signals are zero-padded to the longest, and each row keeps only its own
frames, which lie inside its own padded length and so do not see the
shared zeros. The labels take each utterance's own frames the same way.
The NTCD catalog walk, the video trim and the HDF5 writer are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.ops.stft import StftConfig, frame_signal, pad_signal
from dvae_tpu_torch.ops.stft_power import power_spectrogram
from dvae_tpu_torch.ops.targets import ibm_from_db, vad_from_energy

DEFAULT_STFT = StftConfig(center=False)  # builder parametrization
LABELS = ("vad_labels", "ibm_labels")


def _empirical_std(sq_sum, mean, n):
    """Bessel-corrected std from accumulated sums, sqrt((sq_sum - n mean^2)
    / (n - 1)), as the reference builders compute it (create_train_set.py:
    204-207)."""
    return np.sqrt(np.maximum(sq_sum - n * mean**2, 0.0) / (n - 1))


class Frames(NamedTuple):
    x: np.ndarray       # (N, F) float32 linear power rows, utterance after utterance
    counts: list        # frames kept of each utterance
    mean: np.ndarray    # (F, 1) float32 train mean over the rows
    std: np.ndarray     # (F, 1) float32 empirical std over the rows
    y: np.ndarray | None = None  # (N, 1) VAD or (N, F) IBM float32 labels, or None


def padded_batch(wavs, cfg: StftConfig = DEFAULT_STFT):
    """Peak-normalize each utterance and pad it as ``cfg`` pads it alone,
    then zero-pad all to the longest -> ((B, T_pad) float32 CPU tensor,
    frames of each utterance)."""
    rows, frames = [], []
    for w in wavs:
        speech = np.asarray(w, np.float64)
        peak = np.max(np.abs(speech))
        if peak > 0:
            speech = speech / peak
        row = pad_signal(torch.from_numpy(speech.astype(np.float32)), cfg)
        rows.append(row)
        frames.append(max(0, 1 + (row.shape[0] - cfg.nfft) // cfg.hop))
    batch = torch.zeros((len(rows), max(r.shape[0] for r in rows)))
    for j, row in enumerate(rows):
        batch[j, :row.shape[0]] = row
    return batch, frames


def _frame_labels(labels: str, batch: torch.Tensor, spec: torch.Tensor,
                  own: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(B, frames, Yd) labels of the padded batch, each row's from its own
    frames (``own``, (B, frames) bool): the VAD's quietest frame and the
    IBM's loudest bin are taken over them alone, never over the zeros that
    pad a row to the batch's length."""
    if labels == "vad_labels":
        energy = torch.sum(frame_signal(batch, cfg.nfft, cfg.hop) ** 2, dim=-1)
        energy = torch.where(own, energy, torch.full_like(energy, float("inf")))
        return vad_from_energy(energy)[..., None]
    # |S| as sqrt of the kernel's power: the JAX builder takes |stft| of
    # the matmul DFT, so a bin within rounding of peak - 50 dB may flip
    db = 20.0 * torch.log10(torch.sqrt(spec) + 1e-8)
    peak = torch.where(own[..., None], db, torch.full_like(db, -float("inf")))
    return ibm_from_db(db, torch.amax(peak, dim=(-2, -1), keepdim=True))


def build_frames(wavs, cfg: StftConfig = DEFAULT_STFT, max_frames=None,
                 device=None, labels: str | None = None) -> Frames:
    """Peak-normalize each utterance, take its |STFT|^2 on ``device`` (CUDA
    unless ``device="cpu"``), keep at most ``max_frames[i]`` frames of it,
    and return the rows with their mean and empirical std.

    ``labels`` adds each row's label as ``Frames.y``: ``"vad_labels"``
    (N, 1), the energy VAD of the padded time signal, or ``"ibm_labels"``
    (N, F), the IBM of the same spectrogram as the rows (``sqrt`` of the
    power, so no second launch). The JAX builder takes the IBM from the
    complex matmul-DFT STFT instead, so a bin whose dB value lies within
    rounding of the utterance's peak - 50 dB may come out the other way.
    Each utterance's labels are computed over all its frames, then trimmed
    with its rows (``n = min(spec frames, label frames, max_frames)``)."""
    if labels is not None and labels not in LABELS:
        raise ValueError(f"unknown labels {labels!r}; expected one of {LABELS}")
    batch, frames = padded_batch(wavs, cfg)
    dev = resolve_device(device)
    # the rows are padded already: frame them as they stand
    framing = dataclasses.replace(cfg, center=False, pad_at_end=False)
    batch = batch.to(dev)
    spec = power_spectrogram(batch, framing)
    counts = frames if max_frames is None else [min(n, int(m)) for n, m in
                                                zip(frames, max_frames)]
    keep = torch.arange(spec.shape[1])[None, :] < torch.tensor(counts)[:, None]
    x = spec[keep.to(dev)]  # utterance after utterance
    y = None
    if labels is not None:
        own = torch.arange(spec.shape[1])[None, :] < torch.tensor(frames)[:, None]
        y = _frame_labels(labels, batch, spec, own.to(dev), framing)[keep.to(dev)]
        y = y.cpu().numpy()
    x64 = x.double()
    n_sum = x.shape[0]
    mean = (x64.sum(0) / n_sum).cpu().numpy()
    std = _empirical_std((x64 * x64).sum(0).cpu().numpy(), mean, n_sum)
    return Frames(x.cpu().numpy(), counts, mean[:, None].astype(np.float32),
                  std[:, None].astype(np.float32), y)
