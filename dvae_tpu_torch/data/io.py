"""Host-side file I/O: wavs (port of ``dvae_tpu.data.io``, scipy only) and
the builders' per-utterance and statistics arrays.

Wav reads return float64 in [-1, 1) (PCM scaled by 1/2**(bits-1)); writes
store 16-bit PCM from float input (libsndfile-style scale by 32768 and
clip).

Arrays go to a file by its suffix: ``.h5`` is the JAX builders' HDF5 file
(one dataset per name, written and read with ``h5py``, imported where a file
is opened); ``.npz`` holds the same arrays under the same names and needs
no ``h5py``, the route on a machine without it. Opening an ``.h5`` there is
an error that names the ``.npz`` route, never a skipped file. Three kinds
of file use it: label files (``Y``, (y_dim, frames) float32), statistics
files (``X_train_mean`` / ``X_train_std``, (F, 1) float32) and processed lip
videos (``X``, (H, W, frames)), whose frame count :func:`video_frames`
reads.
"""

from __future__ import annotations

import os
import struct
import zipfile
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


ARRAY_SUFFIXES = (".h5", ".npz")  # the JAX builders' file first


def need_h5py(path):
    """``h5py``, for the HDF5 file ``path``; where it is missing, an error
    that names the ``.npz`` route."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(
            f"{path}: an HDF5 file needs h5py, which this machine lacks; use the .npz "
            "of the same arrays (the builders' fmt='npz', the CLIs' --format npz)") from None
    return h5py


def _suffix(path) -> str:
    ext = os.path.splitext(str(path))[1]
    if ext not in ARRAY_SUFFIXES:
        raise ValueError(f"{path}: expected one of {ARRAY_SUFFIXES}")
    return ext


def save_arrays(path, arrays: dict) -> None:
    """Write ``arrays`` (name -> array) to ``path``: datasets of an ``.h5``
    (``h5py``), or an ``.npz`` written to a temporary name and renamed, so
    that a killed write leaves no truncated file."""
    if _suffix(path) == ".h5":
        with need_h5py(path).File(path, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v)
        return
    path = str(path)
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **{k: np.ascontiguousarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)


def load_arrays(path, *names) -> tuple:
    """The arrays ``names`` of an ``.h5`` or ``.npz`` file."""
    if _suffix(path) == ".h5":
        with need_h5py(path).File(path, "r") as f:
            return tuple(f[k][()] for k in names)
    with np.load(path) as f:
        return tuple(f[k] for k in names)


def write_labels(path, y: np.ndarray) -> None:
    """A per-utterance label file: ``Y``, (y_dim, frames) float32."""
    save_arrays(path, {"Y": np.asarray(y, np.float32)})


def read_labels(path) -> np.ndarray:
    """``Y`` of a label file, (y_dim, frames) float32, as stored."""
    return np.asarray(load_arrays(path, "Y")[0], np.float32)


def _npz_shape(path, name: str) -> tuple:
    """The shape of ``name`` in an ``.npz`` from its header, without reading
    the array."""
    with zipfile.ZipFile(path) as z, z.open(name + ".npy") as fh:
        major, _ = np.lib.format.read_magic(fh)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        return read(fh)[0]


def array_file(path):
    """The file that ``path`` names with either suffix: the ``.h5`` where it
    exists, else the ``.npz``; None where neither does."""
    base = os.path.splitext(str(path))[0]
    for ext in ARRAY_SUFFIXES:
        if os.path.exists(base + ext):
            return base + ext
    return None


def video_frames(path, legacy: bool = False):
    """Frames of the processed lip video ``<utt>_upsampled.h5`` or
    ``<utt>_upsampled.npz`` (``X``, (H, W, frames)) that ``path`` names with
    either suffix (:func:`array_file`); None where neither exists.
    ``legacy`` takes ``shape[0]``, the image height, as the reference's
    frame-set builder does (create_train_set.py:181-186)."""
    p = array_file(path)
    if p is None:
        return None
    if p.endswith(".h5"):
        with need_h5py(p).File(p, "r") as f:
            shape = f["X"].shape
    else:
        shape = _npz_shape(p, "X")
    return int(shape[0] if legacy else shape[-1])
