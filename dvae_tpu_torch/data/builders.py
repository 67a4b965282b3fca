"""Frame-set builder core (port of the per-utterance part of
``dvae_tpu.data.builders.build_frame_dataset``).

:func:`build_frames` turns clean utterances into the linear-power frame
rows the VAE trainers consume, with the train statistics beside them. The
spectrogram runs on the device through :mod:`dvae_tpu_torch.ops.stft_power`
in one launch: each utterance gets its own padding (the end-pad quirk
depends on its own length), the padded signals are zero-padded to the
longest, and each row keeps only its own frames, which lie inside its own
padded length and so do not see the shared zeros. The NTCD catalog walk,
the labels and the HDF5 writer are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.ops.stft import StftConfig, pad_signal
from dvae_tpu_torch.ops.stft_power import power_spectrogram

DEFAULT_STFT = StftConfig(center=False)  # builder parametrization


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


def build_frames(wavs, cfg: StftConfig = DEFAULT_STFT, max_frames=None,
                 device=None) -> Frames:
    """Peak-normalize each utterance, take its |STFT|^2 on ``device`` (CUDA
    unless ``device="cpu"``), keep at most ``max_frames[i]`` frames of it,
    and return the rows with their mean and empirical std."""
    batch, frames = padded_batch(wavs, cfg)
    dev = resolve_device(device)
    # the rows are padded already: frame them as they stand
    framing = dataclasses.replace(cfg, center=False, pad_at_end=False)
    spec = power_spectrogram(batch.to(dev), framing)
    counts = frames if max_frames is None else [min(n, int(m)) for n, m in
                                                zip(frames, max_frames)]
    keep = torch.arange(spec.shape[1])[None, :] < torch.tensor(counts)[:, None]
    x = spec[keep.to(dev)]  # utterance after utterance
    x64 = x.double()
    n_sum = x.shape[0]
    mean = (x64.sum(0) / n_sum).cpu().numpy()
    std = _empirical_std((x64 * x64).sum(0).cpu().numpy(), mean, n_sum)
    return Frames(x.cpu().numpy(), counts, mean[:, None].astype(np.float32),
                  std[:, None].astype(np.float32))
