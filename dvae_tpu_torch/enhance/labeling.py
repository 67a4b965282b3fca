"""Labels for the conditional families when no oracle labels exist (port
of ``dvae_tpu.enhance.labeling``).

The constant ablations, or the model's own x -> y classifier run on the
noisy mixture's power spectrogram (a serving run has no clean side). The
spectrogram is :func:`dvae_tpu_torch.ops.stft_power.power_spectrogram`:
the STFT power kernel on a CUDA tensor, its plain version on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from dvae_tpu_torch import tracing
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from dvae_tpu_torch.ops.stft_power import power_spectrogram

#: model family -> the method that computes y from the input spectrogram.
#: m1 / m2 / m2v2 have no classifier.
CLASSIFY_METHOD = {"v3": "classify", "v4": "classify_from_x", "v5": "classify_from_x"}


def classify_method_of(model_class: str) -> str | None:
    """The self-labeling method name of a family, or None (m1/m2/m2v2)."""
    return CLASSIFY_METHOD.get(model_class)


def constant_labels(n_frames: int, y_dim: int, kind: str) -> np.ndarray:
    """The ``ones`` / ``zeros`` constant-label ablations as an
    (n_frames, y_dim) array."""
    if kind not in ("ones", "zeros"):
        raise ValueError(f"bad constant label kind {kind!r}")
    return np.full((n_frames, y_dim), 1.0 if kind == "ones" else 0.0, np.float32)


@torch.inference_mode()
def self_soft_labels(model, wavs, stft_cfg: StftConfig, y_dim: int, method: str,
                     norm=None, norm_eps: float = 1e-8) -> list[np.ndarray]:
    """y_hat_soft from the model's own classifier on the noisy mixtures.

    One batched call over the ragged ``wavs`` zero-padded to the longest
    (the STFT's own end pad is zeros, so every frame within an utterance's
    length is unchanged, and the classifier is frame-wise), on the device
    of the model's parameters. ``norm`` / ``norm_eps`` follow
    ``EnhancerConfig``: a std_norm model's classifier sees
    (x2 - mean) / (std + norm_eps). Returns one (n_frames, y_dim) array per
    utterance, n_frames its ``n_stft_frames_clamped``."""
    with tracing.span("labels", utterances=len(wavs)):
        dev = next(model.parameters()).device
        ns = [n_stft_frames_clamped(len(w), stft_cfg) for w in wavs]
        t_max = max(len(w) for w in wavs)
        batch = np.stack([np.pad(np.asarray(w, np.float32), (0, t_max - len(w))) for w in wavs])
        x2 = power_spectrogram(torch.from_numpy(batch).to(dev), stft_cfg)  # (B, n, bins)
        if norm is not None:
            mean, std = (torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=dev)
                         for a in norm)
            x2 = (x2 - mean) / (std + norm_eps)
        b, n, f = x2.shape
        y = getattr(model, method)(x2.reshape(b * n, f))
        y = y.float().cpu().numpy().reshape(b, n, -1)
        return [y[i, :ns[i]].reshape(-1, y_dim) for i in range(len(wavs))]
