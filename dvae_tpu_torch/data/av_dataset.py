"""Lip-video and audio-visual sequence datasets (port of
``dvae_tpu.data.av_dataset``): per utterance, the 62.5 fps upsampled lip
video (``X`` (H, W, frames) of ``<utt>_upsampled.{h5,npz}``), the per-frame
labels (``Y`` (y_dim, frames)) and, for the audio-visual set, the noisy
waveform, peak-normalized. Video and labels are trimmed to the common frame
count, as the reference's AV loader trims them (data_handling.py:321-324).
The spectrogram is taken on the device by the batcher
(``train/sequence.py::batch_av_utterances``).

Files are read through ``data/io.py``: an ``.h5`` with ``h5py``, an
``.npz`` anywhere; a file that cannot be read raises. In memory, any
sequence of (video, labels) pairs or (wav, video, labels) triples serves
the batchers in place of a dataset, as sequences of (wav, labels) pairs
serve in place of ``UtteranceDataset``.
"""

from __future__ import annotations

import pathlib

import numpy as np

from dvae_tpu_torch.data.io import load_arrays, read_labels, read_wav


def read_video(path) -> np.ndarray:
    """``X`` (H, W, frames) of a lip-video file -> (frames, H, W) float32."""
    v = load_arrays(path, "X")[0]
    return np.ascontiguousarray(np.moveaxis(v, -1, 0), dtype=np.float32)


def _labels_t(path) -> np.ndarray:
    return np.ascontiguousarray(read_labels(path).T)  # (n_frames, y_dim)


class VideoDataset:
    """Per-utterance (video (N, H, W), labels (N, y_dim)) pairs, trimmed to
    the common frame count: the video-only VAD training set. ``pairs`` is a
    list of (video file, label file) paths."""

    def __init__(self, pairs):
        self.pairs = [(pathlib.Path(v), pathlib.Path(lab)) for v, lab in pairs]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        video_path, label_path = self.pairs[i]
        v, y = read_video(video_path), _labels_t(label_path)
        n = min(v.shape[0], y.shape[0])
        return v[:n], y[:n]


class AudioVisualDataset:
    """Per-utterance (waveform, video (N, H, W), labels (N, y_dim) or None)
    triples. ``triples`` is a list of (wav, video file, label file | None)
    paths.

    Video and labels are trimmed to the common frame count with the audio's
    ``1 + max(0, len - nfft) // hop`` frames; the waveform is returned
    whole, zero-padded up to ``(n - 1) * hop + nfft`` samples where it is
    shorter. The batcher slices and masks the spectrogram frames to the
    label length."""

    def __init__(self, triples, fs: int = 16000, peak_normalize: bool = True,
                 hop: int = 256, nfft: int = 1024):
        self.triples = [(pathlib.Path(w), pathlib.Path(v), pathlib.Path(lab) if lab else None)
                        for w, v, lab in triples]
        self.fs = fs
        self.peak_normalize = peak_normalize
        self.hop = hop
        self.nfft = nfft

    def __len__(self):
        return len(self.triples)

    def __getitem__(self, i):
        wav_path, video_path, label_path = self.triples[i]
        x, fs = read_wav(wav_path)
        if fs != self.fs:
            raise ValueError(f"{wav_path}: fs={fs}, expected {self.fs}")
        if self.peak_normalize:
            peak = np.max(np.abs(x))
            if peak > 0:
                x = x / peak
        v = read_video(video_path)
        y = None if label_path is None else _labels_t(label_path)
        n_audio = 1 + max(0, (len(x) - self.nfft)) // self.hop
        n = min(v.shape[0], n_audio, *(() if y is None else (y.shape[0],)))
        v = v[:n]
        if y is not None:
            y = y[:n]
        t_min = (n - 1) * self.hop + self.nfft
        if len(x) < t_min:
            x = np.pad(x, (0, t_min - len(x)))
        return x.astype(np.float32), v, y
