"""Label generators: voice activity (VAD) and ideal binary masks (IBM)
(port of ``dvae_tpu.ops.targets``).

* :func:`clean_speech_vad`: frame the time signal as the STFT frames it
  (the end-pad quirk, then the centre pad when ``cfg.center``), and mark a
  frame where its energy exceeds ``10**vad_threshold`` times the quietest
  frame's.
* :func:`clean_speech_ibm`: ``20 log10(|S| + eps) > max - ibm_threshold``
  over the whole utterance's spectrogram.
* :func:`noise_robust_clean_speech_ibm`: the IBM gated by the VAD.
* The legacy threshold family, kept for the library's surface:
  :func:`voiced_unvoiced_split_characteristic`, :func:`noise_aware_ibm`,
  :func:`threshold_ibm`.

Plain torch on any device (no kernel): ``unfold`` frames the signal, and
the IBM takes a magnitude or a complex spectrogram.
"""

from __future__ import annotations

import numpy as np
import torch

from dvae_tpu_torch.ops.stft import StftConfig, frame_signal, pad_signal


def vad_from_energy(power: torch.Tensor, vad_threshold: float = 1.70) -> torch.Tensor:
    """The VAD decision on frame energies (..., n_frames): above
    ``10**vad_threshold`` times the row's quietest frame -> float32."""
    floor = torch.amin(power, dim=-1, keepdim=True)
    return (power > (10.0 ** vad_threshold) * floor).to(torch.float32)


def clean_speech_vad(speech_t: torch.Tensor, cfg: StftConfig = StftConfig(),
                     vad_threshold: float = 1.70) -> torch.Tensor:
    """Time-domain energy VAD for a (..., T) signal -> (..., n_frames) float32.

    The minimum is per row: a batch of utterances zero-padded to a common
    length would lower it, so call this per utterance (or see
    ``data.builders.build_frames``, which masks each row's padded frames)."""
    frames = frame_signal(pad_signal(speech_t, cfg), cfg.nfft, cfg.hop)
    return vad_from_energy(torch.sum(frames * frames, dim=-1), vad_threshold)


def ibm_from_db(power_db: torch.Tensor, peak: torch.Tensor,
                ibm_threshold: float = 50.0) -> torch.Tensor:
    """The IBM decision: ``power_db > peak - ibm_threshold`` -> float32."""
    return (power_db > peak - ibm_threshold).to(torch.float32)


def clean_speech_ibm(speech_tf: torch.Tensor, eps: float = 1e-8,
                     ibm_threshold: float = 50.0) -> torch.Tensor:
    """IBM from a spectrogram (..., n_frames, n_bins) -> float32 mask.

    Takes the complex STFT or its magnitude (the magnitude is taken first,
    so the two are equivalent)."""
    power_db = 20.0 * torch.log10(torch.abs(speech_tf) + eps)
    peak = torch.amax(power_db, dim=(-2, -1), keepdim=True)
    return ibm_from_db(power_db, peak, ibm_threshold)


def noise_robust_clean_speech_ibm(speech_t: torch.Tensor, speech_tf: torch.Tensor,
                                  cfg: StftConfig = StftConfig(),
                                  vad_threshold: float = 1.70, eps: float = 1e-8,
                                  ibm_threshold: float = 50.0) -> torch.Tensor:
    """IBM gated by the time-domain VAD (robust to noise before and after
    the speech)."""
    vad = clean_speech_vad(speech_t, cfg, vad_threshold)
    ibm = clean_speech_ibm(speech_tf, eps, ibm_threshold)
    return ibm * vad[..., :, None]


# ---------------------------------------------------------------------------
# Legacy threshold-based IBM family (reference target.py:110-251): dead code
# in the reference's scripts, kept for the library's surface.
# ---------------------------------------------------------------------------


def voiced_unvoiced_split_characteristic(n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Frequency weighting curves splitting the bins into voiced and
    unvoiced regions, with the reference's slice conventions: the
    raised-cosine transition starts at index ``start - 1``, the low-edge
    fast transition overlaps the hard zero region by one bin, and the
    unvoiced curve's hard-zero low region overwrites the first transition
    bin."""
    split_bin, transition_width = 200, 99
    fast_transition_width, low_bin, high_bin = 5, 4, 500

    transition = 0.5 * (1.0 + np.cos(np.pi / (transition_width - 1)
                                     * np.arange(transition_width)))
    fast_transition = 0.5 * (1.0 + np.cos(np.pi / (fast_transition_width - 1)
                                          * np.arange(fast_transition_width)))
    start = int(split_bin - transition_width / 2)

    voiced = np.ones(n_bins)
    voiced[start - 1: start - 1 + transition_width] = transition
    voiced[start - 1 + transition_width:] = 0.0
    voiced[:low_bin] = 0.0
    voiced[low_bin - 1: low_bin - 1 + fast_transition_width] = 1.0 - fast_transition

    unvoiced = np.ones(n_bins)
    unvoiced[start - 1: start - 1 + transition_width] = 1.0 - transition
    unvoiced[:start] = 0.0
    unvoiced[high_bin - 1:] = 0.0
    unvoiced[high_bin - 1: high_bin - 1 + fast_transition_width] = fast_transition

    return voiced, unvoiced


def _threshold_psd(speech_tf, threshold_voiced, threshold_unvoiced, n_bins):
    """|X|^2 divided by the per-bin ``10**(threshold / 10)`` weighting (the
    weighting rounded to float32 first)."""
    voiced, unvoiced = voiced_unvoiced_split_characteristic(n_bins)
    threshold_db = threshold_voiced * voiced + threshold_unvoiced * unvoiced
    scale = torch.from_numpy(np.power(10.0, threshold_db / 10.0).astype(np.float32))
    return torch.abs(speech_tf) ** 2 / scale.to(speech_tf.device)


def _edge(n_bins: int, low_cut: int, high_cut: int, device) -> torch.Tensor:
    bins = torch.arange(n_bins, device=device)
    return (bins < low_cut - 1) | (bins >= high_cut)


def noise_aware_ibm(speech_tf: torch.Tensor, noise_tf: torch.Tensor,
                    threshold_unvoiced_speech: float = 5.0,
                    threshold_voiced_speech: float = 0.0,
                    threshold_unvoiced_noise: float = -10.0,
                    threshold_voiced_noise: float = -10.0,
                    low_cut: int = 5, high_cut: int = 500) -> tuple[torch.Tensor, torch.Tensor]:
    """(speech, noise) boolean masks from clean-speech and noise
    spectrograms, with the reference's asymmetric edges: the speech mask
    zeroes ``[0, low_cut - 1)`` and ``[high_cut, F)`` where the noise mask
    sets them, and the 0.005 PSD floor enters the speech mask with AND but
    the noise mask with OR."""
    n_bins = speech_tf.shape[-1]
    xpsd_s = _threshold_psd(speech_tf, threshold_voiced_speech,
                            threshold_unvoiced_speech, n_bins)
    xpsd_n = _threshold_psd(speech_tf, threshold_unvoiced_noise,
                            threshold_voiced_noise, n_bins)
    npsd = torch.abs(noise_tf) ** 2
    edge = _edge(n_bins, low_cut, high_cut, speech_tf.device)
    speech_mask = (xpsd_s > npsd) & (xpsd_s > 0.005) & ~edge
    noise_mask = (xpsd_n < npsd) | (xpsd_n < 0.005) | edge
    return speech_mask, noise_mask


def threshold_ibm(speech_tf: torch.Tensor, threshold_unvoiced_speech: float = 5.0,
                  threshold_voiced_speech: float = 0.0, low_cut: int = 5,
                  high_cut: int = 500, npsd: float = 10.0) -> torch.Tensor:
    """Boolean speech mask against a flat noise PSD (the reference's
    ``threshold_IBM``, whose noise PSD is the constant 10)."""
    n_bins = speech_tf.shape[-1]
    xpsd_s = _threshold_psd(speech_tf, threshold_voiced_speech,
                            threshold_unvoiced_speech, n_bins)
    edge = _edge(n_bins, low_cut, high_cut, speech_tf.device)
    return (xpsd_s > npsd) & (xpsd_s > 0.005) & ~edge
