"""A synthetic NTCD-TIMIT processed tree for the port's sweep tests.

``make_tree(root)`` writes ``root/data/subset/processed/ntcd_timit/``:
clean wavs and their per-utterance label h5s (``Y`` of shape (y_dim,
n_frames), VAD and IBM) under ``Clean/test/<spk>/``, and the noisy mixtures
of the subset grid (Babble and LR at -5 dB) under ``Noisy/``; with
``video`` also lip-video h5s (``X`` with fewer frames than the audio, so
the sweep trims) under ``matlab_raw/test/<spk>/``. Returns the utterances
as ``{(spk, utt): n_samples}``.
"""

import numpy as np

from dvae_tpu_torch.data.io import write_wav
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped

UTTS = {("spk01", "sa1"): 9000, ("spk01", "sx2"): 14000, ("spk02", "si3"): 6000,
        ("spk02", "sa1"): 11000, ("spk03", "sx9"): 7500}
NOISES = ("Babble", "LR")


def make_tree(root, utts=UTTS, video=False, seed=0):
    import h5py

    rng = np.random.default_rng(seed)
    proc = root / "data" / "subset" / "processed" / "ntcd_timit"
    for (spk, utt), n in utts.items():
        clean_dir = proc / "Clean" / "test" / spk
        clean_dir.mkdir(parents=True, exist_ok=True)
        t = np.arange(n) / 16000
        clean = 0.3 * np.sin(2 * np.pi * (150 + 40 * rng.random()) * t) * (t % 0.5 < 0.3)
        write_wav(clean_dir / f"{utt}.wav", clean, 16000)
        frames = n_stft_frames_clamped(n, StftConfig())
        with h5py.File(clean_dir / f"{utt}_vad_labels_upsampled.h5", "w") as f:
            f["Y"] = (rng.uniform(size=(1, frames)) > 0.4).astype(np.float32)
        with h5py.File(clean_dir / f"{utt}_ibm_labels_upsampled.h5", "w") as f:
            f["Y"] = (rng.uniform(size=(513, frames)) > 0.5).astype(np.float32)
        if video:
            vdir = proc / "matlab_raw" / "test" / spk
            vdir.mkdir(parents=True, exist_ok=True)
            with h5py.File(vdir / f"{utt}_upsampled.h5", "w") as f:
                f["X"] = np.zeros((4, frames - 3), np.float32)
        for noise in NOISES:
            noisy_dir = proc / "Noisy" / noise / "-5" / "test" / spk
            noisy_dir.mkdir(parents=True, exist_ok=True)
            write_wav(noisy_dir / f"{utt}.wav", clean + 0.1 * rng.standard_normal(n), 16000)
    return utts
