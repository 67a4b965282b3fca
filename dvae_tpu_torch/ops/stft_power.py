"""(Log-)power spectrogram: CUDA kernel wrapper and plain version (port of
``dvae_tpu.ops.pallas_stft``).

:func:`power_spectrogram` and :func:`log_power_spectrogram` take a (..., T)
signal and return (..., frames, bins). The wrapper applies the end-pad
quirk and, when ``cfg.center``, the reflect pad in torch, then hands the
contiguous padded (B, T_pad) waveform to the kernel ``csrc/stft_power.cu``
(built with ``nvcc`` at first use), which cuts the frames itself. CPU
tensors take :func:`stft_power_reference`, the matmul-DFT of
``ops/stft.py``; any other device raises. There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvae_tpu_torch.build import load_library
from dvae_tpu_torch.ops import stft as _plain
from dvae_tpu_torch.ops.stft import StftConfig, _dft_matrices, pad_signal

# dynamic shared memory one H100 block may use
_MAX_SMEM = 232448

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


@functools.cache
def build_library() -> ctypes.CDLL:
    """Compile ``csrc/stft_power.cu`` for sm_90a into ``build/`` (once per
    source version), load it and declare its C interface (once per
    process)."""
    lib = load_library("stft_power.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_power_launch.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_float, p]
    lib.stft_power_launch.restype = i
    lib.stft_power_smem_bytes.argtypes = [i, i]
    lib.stft_power_smem_bytes.restype = ctypes.c_longlong
    lib.stft_power_k_tile.argtypes = []
    lib.stft_power_k_tile.restype = i
    return lib


@functools.cache
def _check_framing(nfft: int, hop: int) -> None:
    """Raise unless the kernel can take this framing (checked once each)."""
    lib = build_library()
    if nfft % lib.stft_power_k_tile() or hop % 4:
        raise ValueError(f"the kernel needs nfft a multiple of {lib.stft_power_k_tile()} "
                         f"and hop a multiple of 4, got nfft={nfft} hop={hop}")
    smem = lib.stft_power_smem_bytes(nfft, hop)
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
    cos, msin = _dft_matrices(nfft, cfg.window, xp.device)
    out = torch.empty((batch, n_frames, n_bins), device=xp.device)
    if out.numel() == 0:  # a signal shorter than one frame, as the plain version gives it
        return out
    with torch.cuda.device(xp.device):
        err = lib.stft_power_launch(
            xp.data_ptr(), cos.data_ptr(), msin.data_ptr(), out.data_ptr(),
            batch, t_pad, n_frames, nfft, hop, n_bins, int(log_eps is not None),
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
