"""QUT-NOISE catalog and preprocessing helpers (port copy of
``dvae_tpu.data.catalog.qut``, the reference's qut_database.py without
librosa: resampling uses scipy's polyphase resampler). Host-only numpy.
"""

from __future__ import annotations

import os
from glob import glob
from pathlib import Path

import numpy as np

TEST_FILENAMES = {
    "cafe": "CAFE-CAFE-1.wav",
    "car": "CAR-WINDOWNB-1.wav",
    "home": "HOME-KITCHEN-1.wav",
    "street": "STREET-CITY-1.wav",
}


def noise_list(input_noise_dir, dataset_type="test"):
    """{noise_type -> relative wav path} for the test noise set
    (qut_database.py:20-61)."""
    if dataset_type != "test":
        raise NotImplementedError(f"QUT {dataset_type} split not defined")
    paths = glob(os.path.join(input_noise_dir, "**/*.wav"), recursive=True)
    paths = [os.path.relpath(p, input_noise_dir) for p in paths]
    out = {}
    for p in paths:
        for key, fname in TEST_FILENAMES.items():
            if fname in p:
                out[key] = p
    return out


def preprocess_noise(noise_audio: np.ndarray, key: str, fs_noise: int, fs: int) -> np.ndarray:
    """First channel, resample to fs, trim the car recording to 1.5-43 min
    (qut_database.py:63-83)."""
    if noise_audio.ndim > 1:
        noise_audio = noise_audio[:, 0]
    if fs != fs_noise:
        from scipy.signal import resample_poly  # imported here: it is slow to import

        noise_audio = resample_poly(noise_audio, fs, fs_noise)
    if key == "car":
        noise_audio = noise_audio[int(1.5 * 60 * fs) : int(43 * 60 * fs)]
    return noise_audio


def noise_list_preprocessed(preprocessed_noise_dir, dataset_type="test"):
    """{stem -> path} of preprocessed noise wavs (qut_database.py:85-101)."""
    d = os.path.join(preprocessed_noise_dir, dataset_type)
    paths = glob(os.path.join(d, "**", "*.wav"), recursive=True)
    return {Path(p).stem: p for p in paths}


def noise_segment(noise_audios: dict, noise_type: str, speech: np.ndarray,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Random speech-length crop of the chosen noise (qut_database.py:103-114)."""
    if noise_type not in noise_audios:
        raise KeyError(f"unknown noise type {noise_type!r}")
    noise_audio = noise_audios[noise_type]
    rng = rng or np.random.default_rng()
    start = int(rng.integers(len(noise_audio) - len(speech)))
    return noise_audio[start : start + len(speech)]
