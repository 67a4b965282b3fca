"""(Log-)power spectrogram: CUDA kernel wrapper and plain version (port of
``dvae_tpu.ops.pallas_stft``).

:func:`power_spectrogram` and :func:`log_power_spectrogram` take a (..., T)
signal and return (..., frames, bins). The wrapper applies the end-pad
quirk and, when ``cfg.center``, the reflect pad in torch, then hands the
contiguous padded (B, T_pad) waveform to the kernel ``csrc/stft_power.cu``
(built with ``nvcc`` at first use), which cuts the frames itself and takes
each frame's real FFT as a half-size complex Stockham FFT plus a real
split (:func:`fft_plan`), from the f32 tables of :func:`fft_tables_np`.
CPU tensors take :func:`stft_power_reference`, the matmul-DFT of
``ops/stft.py``; any other device raises. There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dvae_tpu_torch.build import load_library
from dvae_tpu_torch.ops import stft as _plain
from dvae_tpu_torch.ops.stft import StftConfig, get_window, pad_signal

# dynamic shared memory one H100 block may use
_MAX_SMEM = 232448
# the frame sizes the kernel is built for, and its warps per block (one
# frame per warp at a time): csrc/stft_power.cu's launch switch and WARPS
_NFFTS = (256, 512, 1024, 2048)
_WARPS = 8

# kernel launches since the last reset (only the launch in _launch counts)
launches = 0


def stft_power_reference(x: torch.Tensor, cfg: StftConfig = StftConfig(),
                         log_eps: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: the matmul-DFT power spectrogram of
    ``ops/stft.py``, its log ``log(p + log_eps)`` when ``log_eps`` is given
    (any device)."""
    if log_eps is None:
        return _plain.power_spectrogram(x, cfg)
    return _plain.log_power_spectrogram(x, cfg, log_eps)


def fft_plan(nfft: int) -> list[tuple[int, int]]:
    """(radix, stride) of each Stockham pass of the kernel's nfft/2-point
    complex FFT: radix 8 while 8 points remain, then 4 or 2."""
    n, ns, plan = nfft // 2, 1, []
    while ns < n:
        r = 8 if n // ns >= 8 else n // ns
        plan.append((r, ns))
        ns *= r
    return plan


@functools.lru_cache(maxsize=None)
def fft_tables_np(nfft: int, window: str):
    """The kernel's tables, computed in float64 and rounded to float32:
    the window (nfft,); the twiddles of the Stockham passes after the
    first, (n, 2) as (re, im), pass after pass, each laid out [r - 1][m]
    with m < stride, entry W_N^(m r N / (stride radix)) for N = nfft/2 and
    W_N = exp(-2 pi i / N); and the real split's W_nfft^k, k < N, (N, 2)."""
    n = nfft // 2
    tw = np.concatenate([
        np.exp(-2j * np.pi * np.outer(np.arange(1, r), np.arange(ns)) / (ns * r)).ravel()
        for r, ns in fft_plan(nfft) if ns > 1])
    split = np.exp(-2j * np.pi * np.arange(n) / nfft)
    pairs = [np.stack([t.real, t.imag], -1).astype(np.float32) for t in (tw, split)]
    return (get_window(window, nfft).astype(np.float32), *pairs)


@functools.lru_cache(maxsize=8)
def _fft_tables(nfft: int, window: str, device: torch.device):
    """:func:`fft_tables_np` on ``device``, moved there once."""
    return tuple(torch.from_numpy(t).to(device) for t in fft_tables_np(nfft, window))


def _smem_bytes(nfft: int, hop: int, frames_per_block: int) -> int:
    """Shared memory of one block: a float2 FFT buffer of nfft/2 per warp
    and the frames' waveform stretch (``smem_bytes`` of the kernel)."""
    return 4 * (_WARPS * nfft + (frames_per_block - 1) * hop + nfft)


@functools.cache
def build_library() -> ctypes.CDLL:
    """Compile ``csrc/stft_power.cu`` for sm_90a into ``build/`` (once per
    source version), load it and declare its C interface (once per
    process)."""
    lib = load_library("stft_power.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_power_launch.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, p]
    lib.stft_power_launch.restype = i
    lib.stft_power_smem_bytes.argtypes = [i, i, i]
    lib.stft_power_smem_bytes.restype = ctypes.c_longlong
    lib.stft_power_warps.argtypes = []
    lib.stft_power_warps.restype = i
    return lib


@functools.cache
def _check_framing(nfft: int, hop: int) -> None:
    """Raise unless the kernel can take this framing: nfft one of
    ``_NFFTS`` and, at one frame per warp, the block's shared memory within
    the card's (checked once each, without the library)."""
    if nfft not in _NFFTS:
        raise ValueError(f"the kernel takes nfft in {_NFFTS}, got {nfft}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    smem = _smem_bytes(nfft, hop, _WARPS)
    if smem > _MAX_SMEM:
        raise ValueError(f"nfft={nfft} hop={hop} need {smem} B of shared memory per "
                         f"block (> {_MAX_SMEM})")


def _launch(xp: torch.Tensor, cfg: StftConfig, log_eps: float | None) -> torch.Tensor:
    """Kernel on a padded (B, T_pad) float32 CUDA waveform -> (B, N, bins)."""
    global launches
    nfft, hop, n_bins = cfg.nfft, cfg.hop, cfg.n_bins
    batch, t_pad = xp.shape
    n_frames = max(0, 1 + (t_pad - nfft) // hop)
    if not (xp.dtype == torch.float32 and xp.is_contiguous()):
        raise ValueError("the kernel takes a contiguous float32 waveform")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535 waveforms")
    _check_framing(nfft, hop)
    lib = build_library()
    win, tw, tw_split = _fft_tables(nfft, cfg.window, xp.device)
    out = torch.empty((batch, n_frames, n_bins), device=xp.device)
    if out.numel() == 0:  # a signal shorter than one frame, as the plain version gives it
        return out
    with torch.cuda.device(xp.device):
        err = lib.stft_power_launch(
            xp.data_ptr(), win.data_ptr(), tw.data_ptr(), tw_split.data_ptr(), out.data_ptr(),
            batch, t_pad, n_frames, nfft, hop, int(log_eps is not None),
            0.0 if log_eps is None else log_eps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stft_power kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _dispatch(x: torch.Tensor, cfg: StftConfig, log_eps: float | None) -> torch.Tensor:
    if x.device.type == "cpu":
        return stft_power_reference(x, cfg, log_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xp = pad_signal(x, cfg)
    lead = xp.shape[:-1]
    out = _launch(xp.reshape(-1, xp.shape[-1]).contiguous(), cfg, log_eps)
    return out.reshape(*lead, *out.shape[1:])


def power_spectrogram(x: torch.Tensor, cfg: StftConfig = StftConfig()) -> torch.Tensor:
    """|STFT|^2 of a (..., T) signal -> (..., frames, bins)."""
    return _dispatch(x, cfg, None)


def log_power_spectrogram(x: torch.Tensor, cfg: StftConfig = StftConfig(),
                          eps: float = 1e-12) -> torch.Tensor:
    """log(|STFT|^2 + eps) of a (..., T) signal -> (..., frames, bins)."""
    return _dispatch(x, cfg, eps)
