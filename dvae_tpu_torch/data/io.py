"""Host-side wav I/O (port of ``dvae_tpu.data.io``, scipy only).

Reads return float64 in [-1, 1) (PCM scaled by 1/2**(bits-1)); writes store
16-bit PCM from float input (libsndfile-style scale by 32768 and clip).
"""

from __future__ import annotations

import struct
from math import gcd

import numpy as np
from scipy.io import wavfile

_PCM_SCALE = {np.dtype(np.int16): 1.0 / 32768.0, np.dtype(np.int32): 1.0 / 2147483648.0}


def wav_sample_rate(path) -> int:
    """Sample rate from the RIFF header alone (no data read), so a caller
    can reject a rate mismatch across many inputs before any decode. Walks
    the chunk list to the ``fmt `` chunk (LIST or JUNK chunks may come
    first)."""
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no fmt chunk found")
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                return struct.unpack("<HHI", f.read(min(size, 16))[:8])[2]
            f.seek(size + (size & 1), 1)  # chunks are word-aligned


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


def resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Polyphase resample ``x`` from ``fs_in`` to ``fs_out`` Hz
    (``scipy.signal.resample_poly`` at the reduced up/down ratio)."""
    from scipy.signal import resample_poly

    if fs_in == fs_out:
        return x
    g = gcd(int(fs_in), int(fs_out))
    return resample_poly(x, int(fs_out) // g, int(fs_in) // g)


def pcm16(data: np.ndarray) -> np.ndarray:
    """Float samples -> int16 PCM: scale by 32768, round to nearest (ties to
    even) and clip, as libsndfile's float -> PCM_16 conversion does."""
    x = np.asarray(data, dtype=np.float64)
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def write_wav(path, data: np.ndarray, fs: int) -> None:
    """Write float samples as 16-bit PCM (quantized by :func:`pcm16`)."""
    wavfile.write(path, fs, pcm16(data))
