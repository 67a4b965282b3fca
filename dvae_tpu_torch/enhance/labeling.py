"""Labels for the conditional families when no oracle labels exist (port
of ``dvae_tpu.enhance.labeling``).

The constant ablations, the model's own x -> y classifier run on the
noisy mixture's power spectrogram (a serving run has no clean side), or a
visual VAD network (``VideoVad``) over each utterance's lip video. The
spectrogram is :func:`dvae_tpu_torch.ops.stft_power.power_spectrogram`:
the STFT power kernel on a CUDA tensor, its plain version on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from dvae_tpu_torch import tracing
from dvae_tpu_torch.models.video_vad import SIDE
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


def check_clip(clip, n_frames: int) -> np.ndarray:
    """``clip`` as a (frames, 67, 67) uint8 array of at least ``n_frames``
    lip crops, one per STFT frame; ValueError otherwise."""
    clip = np.asarray(clip)
    if clip.dtype != np.uint8 or clip.ndim != 3 or clip.shape[1:] != (SIDE, SIDE):
        raise ValueError(f"video must be (frames, {SIDE}, {SIDE}) uint8, got "
                         f"{clip.shape} {clip.dtype}")
    if len(clip) < n_frames:
        raise ValueError(f"video has {len(clip)} frames, the audio {n_frames}")
    return clip


@torch.inference_mode()
def video_vad_labels(net, wavs, side: dict, stft_cfg: StftConfig, stats: dict | None,
                     frame_bucket: int = 64, rows: int | None = None) -> list[np.ndarray]:
    """Per-frame VAD probabilities of ``net`` (a ``VideoVad``) over each
    utterance's lip video, in one batched call on the network's device.

    ``side["video"]`` holds one (frames, 67, 67) uint8 clip per utterance,
    one crop per STFT frame (62.5 fps at the default STFT); frames past the
    audio's count are dropped, fewer raise ValueError. The clips are
    gathered into one uint8 host buffer, zero-padded in time to a multiple
    of ``frame_bucket`` (and, with ``rows``, in the batch to ``rows`` blank
    clips), uploaded in one copy as uint8, normalized on the device by
    ``stats["video"]`` (the pixels' mean and std; None leaves them raw)
    and run through ``net`` once. Every layer runs forward in time, so the
    padding never reaches a valid frame. Returns one
    (n_stft_frames_clamped, 1) float32 array per utterance."""
    ns = [n_stft_frames_clamped(len(w), stft_cfg) for w in wavs]
    if len(side["video"]) != len(ns):
        raise ValueError(f"{len(side['video'])} clips for {len(ns)} utterances")
    clips = [check_clip(c, n) for c, n in zip(side["video"], ns)]
    b = max(rows or 0, len(ns))
    t = -(-max(ns) // frame_bucket) * frame_bucket
    with tracing.span("labels.video", utterances=len(ns), frames=sum(ns), padded_frames=b * t,
                      clip_bytes=b * t * SIDE * SIDE):
        dev = next(net.parameters()).device
        with tracing.span("labels.upload"):
            buf = np.zeros((b, t, SIDE, SIDE), np.uint8)
            for i, (clip, n) in enumerate(zip(clips, ns)):
                buf[i, :n] = clip[:n]
            video = torch.from_numpy(buf).to(dev)
        with tracing.span("labels.net"):
            x = video.float()
            if stats is not None:
                mean, std = stats["video"]
                x = (x - mean) / std
            p = net(x).float().cpu().numpy()
        return [np.ascontiguousarray(p[i, :n, None]) for i, n in enumerate(ns)]
