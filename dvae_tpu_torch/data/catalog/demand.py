"""DEMAND noise-database catalog (port copy of
``dvae_tpu.data.catalog.demand``, the reference's demand_database.py with
its stale import fixed). Train/validation environment maps per
demand_database.py:37-54. Host-only numpy.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

FOLDER_NAMES = {
    "train": {
        "domestic": "DWASHING",
        "nature": "NRIVER",
        "office": "OOFFICE",
        "transportation": "TMETRO",
    },
    "validation": {
        "nature": "NFIELD",
        "office": "OHALLWAY",
        "public": "PSTATION",
        "transportation": "TBUS",
    },
}


def noise_list(input_noise_dir, dataset_type="train"):
    """{noise_type -> {sample_id -> relative wav path}} for the split's
    environments — the reference's exact return shape
    (demand_database.py:61-70: sample_id is the int of all digits in the
    relative path, e.g. ``DWASHING/ch01.wav`` -> 1)."""
    if dataset_type not in FOLDER_NAMES:
        raise NotImplementedError(f"DEMAND {dataset_type} split not defined")
    folders = FOLDER_NAMES[dataset_type]
    paths = glob(os.path.join(input_noise_dir, "**/*.wav"), recursive=True)
    paths = [os.path.relpath(p, input_noise_dir) for p in paths]
    out = {}
    for p in paths:
        for key, folder in folders.items():
            if folder in p:
                sample_id = int("".join(filter(str.isdigit, p)) or 0)
                out.setdefault(key, {})[sample_id] = p
    return out


def preprocess_noise(noise_audio: np.ndarray, fs_noise: int, fs: int) -> np.ndarray:
    """First channel + resample to fs."""
    if noise_audio.ndim > 1:
        noise_audio = noise_audio[:, 0]
    if fs != fs_noise:
        from scipy.signal import resample_poly  # imported here: it is slow to import

        noise_audio = resample_poly(noise_audio, fs, fs_noise)
    return noise_audio


_PREPROCESSED_SPLIT_DIRS = {"train": "si_tr_s", "validation": "si_dt_05"}


def noise_list_preprocessed(preprocessed_noise_dir, dataset_type="train"):
    """{wav stem -> path} over the split's preprocessed tree
    (demand_database.py:87-115; its 'test' branch prints 'Not implemented'
    and then globs the unsplit root — here an undefined split raises, like
    the other noise catalogs)."""
    if dataset_type not in _PREPROCESSED_SPLIT_DIRS:
        raise NotImplementedError(
            f"DEMAND preprocessed {dataset_type} split not defined")
    data_dir = os.path.join(preprocessed_noise_dir,
                            _PREPROCESSED_SPLIT_DIRS[dataset_type])
    paths = glob(os.path.join(data_dir, "**/*.wav"), recursive=True)
    return {os.path.splitext(os.path.basename(p))[0]: p for p in sorted(paths)}


def noise_segment(noise_audios: dict, noise_type: str, speech: np.ndarray,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Random speech-length crop of the chosen noise."""
    noise_audio = noise_audios[noise_type]
    rng = rng or np.random.default_rng()
    start = int(rng.integers(len(noise_audio) - len(speech)))
    return noise_audio[start : start + len(speech)]
