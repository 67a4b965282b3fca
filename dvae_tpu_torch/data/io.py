"""Host-side wav I/O (port of ``dvae_tpu.data.io``, scipy only).

Reads return float64 in [-1, 1) (PCM scaled by 1/2**(bits-1)); writes store
16-bit PCM from float input (libsndfile-style scale by 32768 and clip).
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

_PCM_SCALE = {np.dtype(np.int16): 1.0 / 32768.0, np.dtype(np.int32): 1.0 / 2147483648.0}


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float64 samples in [-1, 1), sample rate)."""
    fs, data = wavfile.read(path)
    if data.dtype in _PCM_SCALE:
        data = data.astype(np.float64) * _PCM_SCALE[data.dtype]
    elif data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    else:  # float32/float64 wavs
        data = data.astype(np.float64)
    return data, int(fs)


def pcm16(data: np.ndarray) -> np.ndarray:
    """Float samples -> int16 PCM: scale by 32768, round to nearest (ties to
    even) and clip, as libsndfile's float -> PCM_16 conversion does."""
    x = np.asarray(data, dtype=np.float64)
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def write_wav(path, data: np.ndarray, fs: int) -> None:
    """Write float samples as 16-bit PCM (quantized by :func:`pcm16`)."""
    wavfile.write(path, fs, pcm16(data))
