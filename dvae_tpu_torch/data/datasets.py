"""Training datasets (port of ``dvae_tpu.data.datasets``).

* :class:`FrameDataset`: frame-level (x, y) rows from the builders'
  consolidated frame set (``X_<split>`` (F, N), ``Y_<split>``, the train
  statistics), an ``.h5`` or an ``.npz`` with the same arrays, or given as
  arrays. ``.npz`` needs no ``h5py``: the route on a machine without it.
  An ``.h5`` can also be streamed (``in_memory=False``).
* :class:`UtteranceDataset`: whole peak-normalized waveforms with their
  per-utterance label files (``.h5`` or ``.npz``), for the sequence
  trainers. Any sequence of ``(wav, labels)`` pairs serves the same role in
  memory.
"""

from __future__ import annotations

import pathlib

import numpy as np

from dvae_tpu_torch.data.io import read_labels, read_wav


def index_batches(n: int, batch_size: int, rng: np.random.Generator | None = None,
                  drop_last: bool = False):
    """Yield index batches: arange -> rng.shuffle -> contiguous slices. The
    one batch-composition rule of the host-fed and device-resident training
    paths."""
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        yield idx[s:s + batch_size]


def _read_transposed(dset) -> np.ndarray:
    """(F, N) h5 dataset -> contiguous (N, F) array, read in ~64 MB column
    blocks (peak memory one block above the result, not twice it)."""
    f_dim, n = dset.shape
    out = np.empty((n, f_dim), dtype=dset.dtype)
    step = max(1, (1 << 26) // max(1, f_dim * dset.dtype.itemsize))
    for s in range(0, n, step):
        out[s:s + step] = dset[:, s:s + step].T
    return out


class FrameDataset:
    """Frame-level (x (N, F), y (N, Yd)) rows of one split of a frame set.

    ``path`` is an ``.npz`` (always read into memory) or an ``.h5``, read
    with ``h5py``: into memory by default, or with ``in_memory=False``
    left on disk and streamed, each batch read as its sorted columns (then
    :attr:`arrays` raises, as the device-resident path needs the whole
    split)."""

    def __init__(self, path, split: str = "train", in_memory: bool = True):
        self.path = str(path)
        self.split = split
        self.in_memory = in_memory
        self._mean_std = None
        self._file = None
        if self.path.endswith(".npz"):
            if not in_memory:
                raise ValueError(f"{self.path}: an .npz frame set is read into memory; "
                                 "streaming (in_memory=False) needs the .h5")
            with np.load(self.path) as f:
                self._x = np.ascontiguousarray(f[f"X_{split}"].T)
                self._y = np.ascontiguousarray(f[f"Y_{split}"].T)
                if "X_train_mean" in f.files:
                    self._mean_std = (f["X_train_mean"], f["X_train_std"])
            return
        import h5py

        f = h5py.File(self.path, "r")
        if in_memory:
            with f:
                self._x = _read_transposed(f[f"X_{split}"])
                self._y = _read_transposed(f[f"Y_{split}"])
        else:
            self._file = f
            self._x, self._y = f[f"X_{split}"], f[f"Y_{split}"]  # (F, N) on disk

    def close(self) -> None:
        """Release the h5 handle of a streamed split."""
        if self._file is not None:
            self._file.close()
            self._file = None

    @classmethod
    def from_arrays(cls, x: np.ndarray, y: np.ndarray | None = None,
                    mean: np.ndarray | None = None, std: np.ndarray | None = None):
        """A dataset over in-memory rows: x (N, F); y (N, Yd) or None for an
        unconditional model; the train statistics (F, 1) for ``mean_std``."""
        ds = cls.__new__(cls)
        ds.path, ds.split, ds.in_memory, ds._file = None, None, True, None
        ds._x = np.ascontiguousarray(x, np.float32)
        ds._y = None if y is None else np.ascontiguousarray(y, np.float32)
        ds._mean_std = None if mean is None else (np.asarray(mean), np.asarray(std))
        return ds

    @property
    def x_dim(self) -> int:
        return self._x.shape[1] if self.in_memory else self._x.shape[0]

    @property
    def arrays(self):
        """The full (x (N, F), y (N, Yd) or None) arrays: the upload source of
        the device-resident training path."""
        if not self.in_memory:
            raise ValueError("arrays needs in_memory=True (device-resident "
                             "training uploads the whole split once)")
        return self._x, self._y

    @property
    def mean_std(self):
        """The train statistics, each (F, 1) (``X_train_mean`` /
        ``X_train_std`` of the h5, or the arrays given)."""
        if self._mean_std is not None:
            return self._mean_std
        if self.path is None or self.path.endswith(".npz"):
            raise ValueError("this dataset has no train statistics")
        import h5py

        with h5py.File(self.path, "r") as f:
            return f["X_train_mean"][:], f["X_train_std"][:]

    def __len__(self):
        return self._x.shape[0] if self.in_memory else self._x.shape[1]

    def batches(self, batch_size: int, rng: np.random.Generator | None = None,
                drop_last: bool = False):
        """Yield (x (B, F), y (B, Yd) or None) numpy batches; shuffles when
        ``rng`` is given."""
        for sel in index_batches(len(self), batch_size, rng, drop_last):
            if self.in_memory:
                yield self._x[sel], None if self._y is None else self._y[sel]
            else:
                cols = np.sort(sel)
                yield self._x[:, cols].T, self._y[:, cols].T


class UtteranceDataset:
    """Whole utterances: (waveform, per-frame labels) pairs.

    ``pairs`` is a list of (wav_path, label_path | None); audio is
    peak-normalized like the reference loader (data_handling.py:123). The
    label file holds ``Y`` as (y_dim, frames): an ``.h5`` (read with
    ``h5py``) or an ``.npz`` (``data.io.read_labels``).
    """

    def __init__(self, pairs, fs: int = 16000, peak_normalize: bool = True):
        self.pairs = [(pathlib.Path(w), pathlib.Path(l) if l else None) for w, l in pairs]
        self.fs = fs
        self.peak_normalize = peak_normalize

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        wav_path, label_path = self.pairs[i]
        x, fs = read_wav(wav_path)
        if fs != self.fs:
            raise ValueError(f"{wav_path}: fs={fs}, expected {self.fs}")
        if self.peak_normalize:
            peak = np.max(np.abs(x))
            if peak > 0:
                x = x / peak
        y = None
        if label_path is not None:
            y = np.ascontiguousarray(read_labels(label_path).T)  # (n_frames, y_dim)
        return x.astype(np.float32), y
