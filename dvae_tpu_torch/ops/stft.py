"""Matmul-DFT STFT / masked ISTFT on tensors (port of ``dvae_tpu.ops.stft``).

Semantics follow the reference frontend (librosa parametrization): frame
count and the end-pad float quirk of :func:`padded_length`, periodic Hann
window, and a windowed overlap-add ISTFT whose squared-window normalizer is
derived from a frame mask so a ragged, padded batch reconstructs each
utterance as a per-utterance ISTFT would.

Layout is (..., frames, bins), as in the JAX package. The DFT is a pair of
f32 matmuls against cos/-sin bases with the window folded in; the bases are
built once with numpy and moved to each device once.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as nnf


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT parametrization; defaults are the reference's production config."""

    fs: int = 16000
    wlen_sec: float = 64e-3
    hop_percent: float = 0.25
    window: str = "hann"
    center: bool = False
    pad_mode: str = "reflect"
    pad_at_end: bool = True

    @property
    def nfft(self) -> int:
        wlen = self.wlen_sec * self.fs
        if wlen != int(wlen):
            raise ValueError("STFT window length in samples is not an integer.")
        return int(wlen)

    @property
    def hop(self) -> int:
        return int(self.hop_percent * self.nfft)

    @property
    def n_bins(self) -> int:
        return self.nfft // 2 + 1


def get_window(name: str, nfft: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window in float64."""
    if name != "hann":
        raise ValueError(f"unsupported window: {name!r}")
    n = np.arange(nfft)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft)


def padded_length(n_samples: int, cfg: StftConfig) -> int:
    """Length after the reference's end-padding rule.

    The reference pads ``hop`` zeros unless ``len/fs / wlen_sec /
    hop_percent`` is an exact float integer; 64e-3 is not binary-exact, so
    this sometimes pads even when ``n_samples % hop == 0``. The float
    expression is reproduced exactly so frame counts match everywhere.
    """
    if not cfg.pad_at_end:
        return n_samples
    utt_len = n_samples / cfg.fs
    q = utt_len / cfg.wlen_sec / cfg.hop_percent
    if math.ceil(q) != int(q):
        return n_samples + cfg.hop
    return n_samples


def n_stft_frames(n_samples: int, cfg: StftConfig) -> int:
    """Frames the reference produces for ``n_samples`` samples (<= 0 for a
    signal shorter than one analysis frame)."""
    t = padded_length(n_samples, cfg)
    if cfg.center:
        t = t + 2 * (cfg.nfft // 2)
    return 1 + (t - cfg.nfft) // cfg.hop


def n_stft_frames_clamped(n_samples: int, cfg: StftConfig) -> int:
    """``n_stft_frames`` floored at 1: a sub-frame wav still occupies one
    zero-padded frame in a batched layout."""
    return max(1, n_stft_frames(n_samples, cfg))


def samples_for_frames(n_frames: int, cfg: StftConfig) -> int:
    """Samples a signal needs to yield (or the ISTFT synthesizes from)
    ``n_frames`` frames."""
    t = (n_frames - 1) * cfg.hop + cfg.nfft
    if cfg.center:
        t = max(t - 2 * (cfg.nfft // 2), 1)
    return t


@functools.lru_cache(maxsize=None)
def _dft_matrices_np(nfft: int, window: str):
    n_bins = nfft // 2 + 1
    n = np.arange(nfft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    w = get_window(window, nfft)[:, None]
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _idft_matrices_np(nfft: int):
    n_bins = nfft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(nfft)[None, :]
    ang = 2.0 * np.pi * k * n / nfft
    c = np.full((n_bins, 1), 2.0)
    c[0, 0] = 1.0
    if nfft % 2 == 0:
        c[-1, 0] = 1.0
    return ((np.cos(ang) * c / nfft).astype(np.float32),
            (-np.sin(ang) * c / nfft).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _dft_matrices(nfft: int, window: str, device: torch.device):
    """(cos, -sin) analysis bases with the window folded in, (nfft, nbins),
    on ``device``:  X[k] = (xw @ C)[k] + i (xw @ S)[k]."""
    return tuple(torch.from_numpy(m).to(device) for m in _dft_matrices_np(nfft, window))


@functools.lru_cache(maxsize=8)
def _idft_matrices(nfft: int, device: torch.device):
    """Inverse-rFFT bases (nbins, nfft) on ``device``:
    x[n] = Re(X) @ Cr + Im(X) @ Ci."""
    return tuple(torch.from_numpy(m).to(device) for m in _idft_matrices_np(nfft))


@functools.lru_cache(maxsize=8)
def _window(window: str, nfft: int, device: torch.device):
    """(window, squared window) as f32 tensors on ``device``."""
    w = get_window(window, nfft)
    return (torch.from_numpy(w.astype(np.float32)).to(device),
            torch.from_numpy((w ** 2).astype(np.float32)).to(device))


def frame_signal(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """(..., T) -> overlapping frames (..., n_frames, nfft), as a view."""
    return x.unfold(-1, nfft, hop)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` samples of reflection on both ends of the last axis, as
    ``jnp.pad`` / ``np.pad`` with ``mode="reflect"`` give them: a signal of
    ``pad`` samples or fewer is reflected again and again (torch's own
    reflect pad refuses it)."""
    n = x.shape[-1]
    if n == 0:
        raise ValueError("cannot reflect-pad an empty signal")
    offset = 1 if n > 1 else 0
    for before in (True, False):
        left = pad
        while left > 0:
            cur = min(left, n - offset)
            left -= cur
            t = x.shape[-1]
            piece = x[..., offset:offset + cur] if before else x[..., t - cur - offset:t - offset]
            piece = piece.flip(-1)
            x = torch.cat([piece, x] if before else [x, piece], dim=-1)
    return x


def pad_signal(x: torch.Tensor, cfg: StftConfig = StftConfig()) -> torch.Tensor:
    """(..., T) float signal -> the float32 (..., T_pad) signal that is cut
    into frames: the end-pad quirk of :func:`padded_length`, then, when
    ``cfg.center``, ``nfft // 2`` samples of ``cfg.pad_mode`` on each end."""
    n_samples = x.shape[-1]
    x = x.to(torch.float32)
    t = padded_length(n_samples, cfg)
    if t != n_samples:
        x = nnf.pad(x, (0, t - n_samples))
    if cfg.center:
        half = cfg.nfft // 2
        if cfg.pad_mode == "reflect":
            return _reflect_pad(x, half)
        lead = x.shape[:-1]
        x = nnf.pad(x.reshape(-1, 1, x.shape[-1]), (half, half), mode=cfg.pad_mode)
        x = x.reshape(*lead, -1)
    return x


def stft_realimag(x: torch.Tensor, cfg: StftConfig = StftConfig()):
    """STFT of a (..., T) float signal -> (re, im), each (..., frames, bins)."""
    x = pad_signal(x, cfg)
    frames = frame_signal(x, cfg.nfft, cfg.hop)
    cos, msin = _dft_matrices(cfg.nfft, cfg.window, x.device)
    return torch.matmul(frames, cos), torch.matmul(frames, msin)


def power_spectrogram(x: torch.Tensor, cfg: StftConfig = StftConfig()) -> torch.Tensor:
    """|STFT|^2 of a (..., T) signal -> (..., frames, bins)."""
    re, im = stft_realimag(x, cfg)
    return re * re + im * im


def log_power_spectrogram(x: torch.Tensor, cfg: StftConfig = StftConfig(),
                          eps: float = 1e-12) -> torch.Tensor:
    """log(|STFT|^2 + eps): the noisy-speech input of the VAD trainers."""
    return torch.log(power_spectrogram(x, cfg) + eps)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (..., n_frames, nfft) -> (..., (n_frames-1)*hop + nfft)."""
    *lead, n_frames, nfft = frames.shape
    out_len = (n_frames - 1) * hop + nfft
    if nfft % hop == 0:
        # split frames into hop-sized chunks and add `ratio` shifted copies
        ratio = nfft // hop
        chunks = frames.reshape(*lead, n_frames, ratio, hop)
        out = frames.new_zeros((*lead, n_frames + ratio - 1, hop))
        for k in range(ratio):
            out[..., k:k + n_frames, :] += chunks[..., :, k, :]
        return out.reshape(*lead, -1)[..., :out_len]
    out = frames.new_zeros((*lead, out_len))
    for i in range(n_frames):
        out[..., i * hop:i * hop + nfft] += frames[..., i, :]
    return out


def istft_realimag_masked(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                          cfg: StftConfig = StftConfig()) -> torch.Tensor:
    """Batched ISTFT over a padded utterance batch.

    The squared-window OLA normalizer is the overlap-add of the mask-gated
    squared window, ``wss_b[t] = sum_i mask[b,i] w^2[t - i*hop]``: for every
    valid sample it equals the per-utterance normalizer, and masked frames
    contribute zero.

    Args:
        re, im: (B, N, bins) spectrogram parts (padded frames zero).
        mask: (B, N) 1.0 for valid frames.
    Returns:
        (B, T) float32 waveforms.
    """
    *_, n_frames, n_bins = re.shape
    nfft = cfg.nfft
    if n_bins != nfft // 2 + 1:
        raise ValueError(f"expected {nfft // 2 + 1} bins, got {n_bins}")
    cr, ci = _idft_matrices(nfft, re.device)
    frames = torch.matmul(re, cr) + torch.matmul(im, ci)
    win, w2 = _window(cfg.window, nfft, re.device)
    m = mask.to(torch.float32)[..., None]
    x = _overlap_add(frames * win * m, cfg.hop)
    wss = _overlap_add(w2.expand(frames.shape) * m, cfg.hop)
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.where(wss > tiny, x / wss.clamp_min(1e-37), x)
    if cfg.center:
        half = nfft // 2
        x = x[..., half:-half]
    return x
