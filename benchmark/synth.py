"""Speech-like mixtures made from a seed, in bulk, on the device.

The generator of the port's smoke run (harmonic "speech" with a drifting
pitch and a slow envelope, plus babble-like Gaussian noise), written as
one batched computation so that a pool of hundreds of utterances costs
milliseconds of set-up. Lengths come from a fixed grid, the same for every
seed (``length_grid``), so that a seed changes the audio and the order but
never the work.
"""

from __future__ import annotations

import numpy as np
import torch

FS = 16000


def length_grid(count: int, min_s: float, max_s: float, fs: int = FS) -> np.ndarray:
    """``count`` lengths in samples at the midpoints of ``count`` equal
    slices of [min_s, max_s]: a uniform draw's quantiles, in ascending
    order."""
    q = (np.arange(count) + 0.5) / count
    return np.round((min_s + (max_s - min_s) * q) * fs).astype(np.int64)


def mixtures(lengths, seed: int, device, fs: int = FS) -> list[np.ndarray]:
    """One float32 mixture per entry of ``lengths`` (samples), from
    ``seed``, made on ``device`` and returned as host arrays."""
    lengths = np.asarray(lengths, np.int64)
    n, t_max = len(lengths), int(lengths.max())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    u = torch.rand((n, 4), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(t_max, device=device, dtype=torch.float64)[None] / fs
    f0 = 110 + 60 * u[:, :1] + 20 * torch.sin(2 * torch.pi * 0.5 * t)
    phase = 2 * torch.pi * torch.cumsum(f0, -1) / fs
    env = 0.5 + 0.5 * torch.sin(2 * torch.pi * (1.5 + u[:, 1:2]) * t) ** 2
    speech = sum(torch.sin(k * phase) / k for k in range(1, 12)) * env
    noise = torch.randn((n, t_max), generator=gen, device=device, dtype=torch.float32)
    mix = (0.2 * speech).float() + noise * (0.1 + 0.2 * u[:, 2:3]).float()
    host = mix.cpu().numpy()
    return [np.ascontiguousarray(host[i, :lengths[i]]) for i in range(n)]
