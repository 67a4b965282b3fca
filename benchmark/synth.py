"""Speech-like mixtures, and lip video beside them, made from a seed, in
bulk, on the device.

The generator of the port's smoke run (harmonic "speech" with a drifting
pitch and a slow envelope, plus babble-like Gaussian noise), written as
one batched computation so that a pool of hundreds of utterances costs
milliseconds of set-up. Lengths come from a fixed grid, the same for every
seed (``length_grid``), so that a seed changes the audio and the order but
never the work.

``lip_video`` gives each mixture one 67x67 8-bit lip crop per STFT frame:
a mouth that opens as the speech's envelope swells, from a generator of
its own, so that the audio is the same with or without it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.weights import stream_seed

FS = 16000
#: the lip crop's side (the port's ``models.video_vad.SIDE``)
SIDE = 67
#: the video's generator stream (the weights' are 0 and up)
VIDEO_STREAM = 100
#: mixtures whose crops are drawn in one batch (bounds the device's memory)
VIDEO_CHUNK = 8


def length_grid(count: int, min_s: float, max_s: float, fs: int = FS) -> np.ndarray:
    """``count`` lengths in samples at the midpoints of ``count`` equal
    slices of [min_s, max_s]: a uniform draw's quantiles, in ascending
    order."""
    q = (np.arange(count) + 0.5) / count
    return np.round((min_s + (max_s - min_s) * q) * fs).astype(np.int64)


def speech(lengths, seed: int, device, fs: int = FS) -> tuple[list[np.ndarray], np.ndarray]:
    """One float32 mixture per entry of ``lengths`` (samples), from
    ``seed``, made on ``device`` and returned as host arrays, and each
    speech envelope's rate (Hz): the envelope is 0.5 + 0.5 sin^2(2 pi
    rate t)."""
    lengths = np.asarray(lengths, np.int64)
    n, t_max = len(lengths), int(lengths.max())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    u = torch.rand((n, 4), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(t_max, device=device, dtype=torch.float64)[None] / fs
    f0 = 110 + 60 * u[:, :1] + 20 * torch.sin(2 * torch.pi * 0.5 * t)
    phase = 2 * torch.pi * torch.cumsum(f0, -1) / fs
    rate = 1.5 + u[:, 1:2]
    env = 0.5 + 0.5 * torch.sin(2 * torch.pi * rate * t) ** 2
    voiced = sum(torch.sin(k * phase) / k for k in range(1, 12)) * env
    noise = torch.randn((n, t_max), generator=gen, device=device, dtype=torch.float32)
    mix = (0.2 * voiced).float() + noise * (0.1 + 0.2 * u[:, 2:3]).float()
    host = mix.cpu().numpy()
    return ([np.ascontiguousarray(host[i, :lengths[i]]) for i in range(n)],
            rate[:, 0].cpu().numpy())


def lip_video(frames, rates, seed: int, device, hop_s: float, wlen_s: float
              ) -> list[np.ndarray]:
    """One (frames[i], 67, 67) uint8 clip per mixture: frame k shows the
    mouth at the centre of STFT frame k (k hop_s + wlen_s / 2), a dark
    ellipse on a skin-toned gradient whose height follows the speech
    envelope's swell sin^2(2 pi rates[i] t), with the face's tone, the
    mouth's width and place and the pixel noise drawn from ``seed``'s
    video stream."""
    frames = [int(f) for f in frames]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, VIDEO_STREAM))
    look = torch.rand((len(frames), 5), generator=gen, device=device)
    axis = torch.arange(SIDE, device=device, dtype=torch.float32) - (SIDE - 1) / 2
    out = []
    for a in range(0, len(frames), VIDEO_CHUNK):
        n = frames[a:a + VIDEO_CHUNK]
        p = look[a:a + len(n)]
        k = torch.arange(max(n), device=device, dtype=torch.float64)
        t = k[None] * hop_s + wlen_s / 2
        rate = torch.as_tensor(np.asarray(rates[a:a + len(n)], np.float64), device=device)
        opening = (torch.sin(2 * torch.pi * rate[:, None] * t) ** 2).float()  # (n, frames)
        half_w = (14 + 6 * p[:, 0])[:, None, None, None]
        half_h = (1.5 + 9 * opening)[..., None, None]
        dy = axis[:, None] - 8 * (p[:, 1] - 0.5)[:, None, None, None]
        dx = axis[None, :] - 8 * (p[:, 2] - 0.5)[:, None, None, None]
        r = torch.sqrt((dx / half_w) ** 2 + (dy / half_h) ** 2)
        mouth = torch.sigmoid(6 * (1 - r))
        skin = (120 + 60 * p[:, 3])[:, None, None, None] + 0.4 * axis[:, None]
        dark = (20 + 40 * p[:, 4])[:, None, None, None]
        img = skin + (dark - skin) * mouth
        img = img + 6 * torch.randn(img.shape, generator=gen, device=device)
        clip = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        out += [np.ascontiguousarray(clip[i, :n[i]]) for i in range(len(n))]
    return out
