"""Lip-ROI video preprocessing of NTCD-TIMIT's matlab DCT frames (port of
``dvae_tpu.ops.video``).

Each 67x67 frame is stored as 2-D DCT coefficients. Preprocessing takes a
2-D type-II IDCT (scipy.fftpack's unnormalized convention), normalizes
globally to [0, 255] over all frames of the utterance, clips to the 8-bit
range and rotates by 270 degrees (reference video.py:5-23 and
create_video_train_files.py:146-172).

:func:`idct2` is two products with the (n, n) basis, in float32 on the
tensor's device (TF32 is off package-wide), as the JAX package computes it
with x64 off. :func:`preprocess_utterance` runs on ``device`` (the card
unless ``device="cpu"``) and returns host float32. :func:`upsample_frames`
is host numpy: the 30 -> 62.5 fps nearest-timestamp duplication that
stands in for the reference's ffmpeg round-trip.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device


@functools.lru_cache(maxsize=None)
def _idct2_matrix(n: int) -> np.ndarray:
    """Unnormalized type-II IDCT matrix M with idct(x) = M @ x
    (scipy.fftpack.idct(x, type=2, norm=None):
    y[k] = x[0] + 2 sum_{j>=1} x[j] cos(pi j (2k+1) / (2n)))."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
    m[:, 0] = 1.0
    return m


def idct2(frames: torch.Tensor) -> torch.Tensor:
    """2-D unnormalized type-II IDCT over the last two axes, in the dtype
    and on the device of ``frames``: the reference's ``idct(idct(r).T).T``,
    the last axis first."""
    h, w = frames.shape[-2], frames.shape[-1]
    mw = torch.as_tensor(_idct2_matrix(w), dtype=frames.dtype, device=frames.device)
    mh = torch.as_tensor(_idct2_matrix(h), dtype=frames.dtype, device=frames.device)
    out = torch.einsum("...hw,kw->...hk", frames, mw)
    return torch.einsum("...hk,mh->...mk", out, mh)


def preprocess_ntcd_matlab(matlab_frames, frame: int, width: int, height: int,
                           y_hat_hard=None) -> np.ndarray:
    """One preprocessed RGB lip frame (height, width, 3), as video.py:5-23.

    The frame gets a true 2-D IDCT (float32, on the CPU). The normalizer
    keeps the reference's provisional form: A is the double idct along the
    last axis with no transpose (not a 2-D IDCT), offset = A.min() over all
    frames, scale = the largest row-wise max - min. A frame whose hard
    label is 1 gets the white 9x9 VAD square in its corner."""
    from scipy.fftpack import idct as _idct

    frames = np.asarray(matlab_frames, dtype=np.float64).reshape(-1, width, height)
    idct_df = idct2(torch.from_numpy(frames[frame].astype(np.float32))).numpy()
    a_norm = _idct(_idct(frames))  # double idct along the last axis
    scale = (a_norm.max(axis=-1) - a_norm.min(axis=-1)).max()
    normalized = (idct_df - a_norm.min()) / scale * 255.0
    rotated = np.rot90(normalized, 3)
    if y_hat_hard is not None and y_hat_hard[frame] == 1:
        rotated = rotated.copy()
        rotated[-9:, -9:] = 255.0  # white square VAD overlay (video.py:18-19)
    return np.stack([rotated] * 3, axis=-1)


def preprocess_utterance(matlab_frames, width: int, height: int, device=None) -> np.ndarray:
    """All frames of an utterance -> (n_frames, height, width) float32 in
    [0, 255] (the builder's path, create_video_train_files.py:158-172, one
    channel), computed in float32 on ``device``: the IDCT, the global
    offset A.min(), the scale max over frames of (max - min), the clip to
    [0, 255] (the reference's codec round-trip clamps there) and the
    rotation."""
    dev = resolve_device(device)
    frames = torch.as_tensor(np.asarray(matlab_frames, dtype=np.float64).reshape(
        -1, width, height), dtype=torch.float32).to(dev)
    a = idct2(frames)
    flat = a.reshape(a.shape[0], -1)
    scale = (flat.amax(-1) - flat.amin(-1)).amax()
    normalized = torch.clamp((a - a.amin()) / scale * 255.0, 0.0, 255.0)
    return torch.rot90(normalized, 3, dims=(-2, -1)).contiguous().cpu().numpy()


def upsample_frames(frames: np.ndarray, fps_in: float, fps_out: float,
                    n_out: int | None = None) -> np.ndarray:
    """Nearest-timestamp frame duplication (ffmpeg's fps filter for pure
    upsampling), ties rounded to even as ``np.round`` does. ``frames``:
    (n_frames, ...)."""
    n_in = frames.shape[0]
    if n_out is None:
        n_out = int(round(n_in * fps_out / fps_in))
    t_out = np.arange(n_out) / fps_out
    idx = np.clip(np.round(t_out * fps_in).astype(int), 0, n_in - 1)
    return frames[idx]
