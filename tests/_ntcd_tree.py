"""Synthetic NTCD-TIMIT trees for the port's tests.

``make_tree(root)`` writes ``root/data/subset/processed/ntcd_timit/``:
clean wavs and their per-utterance label h5s (``Y`` of shape (y_dim,
n_frames), VAD and IBM) under ``Clean/test/<spk>/``, and the noisy mixtures
of the subset grid (Babble and LR at -5 dB) under ``Noisy/``; with
``video`` also lip-video h5s (``X`` with fewer frames than the audio, so
the sweep trims) under ``matlab_raw/test/<spk>/``. Returns the utterances
as ``{(spk, utt): n_samples}``. ``make_raw_tree(raw)`` writes a raw tree
for the builders (clean wavs, ``.mat`` placeholders, optionally raw noisy
mixtures), ``write_videos(proc)`` processed lip videos, ``.h5`` or ``.npz``,
and ``write_lip_mats(raw)`` the raw tree's lip videos as matlab v7.3-style
``.mat`` files (HDF5, written with h5py) of DCT frames.
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


RAW_UTTS = {"train": {("spk01", "sa1"): 16000, ("spk01", "sx2"): 22400, ("spk02", "si3"): 11200},
            "validation": {("spk03", "sa1"): 14400, ("spk03", "sx9"): 19200}}
# lip-video frame counts (X is (height, width, frames)) of the utterances
# that have one: fewer frames than the audio, and a height below both, so
# the trim and the legacy trim (to the height) each cut
RAW_VIDEOS = {("train", "spk01", "sx2"): (20, 3, 40), ("validation", "spk03", "sa1"): (30, 3, 25)}
SPLIT_DIRS = {"train": "train", "validation": "dev", "test": "test"}
# a lip video for every train utterance, as the audio builder's noisy
# statistics need: two trim the audio, one is longer than it
AUDIO_VIDEOS = {("train", "spk01", "sa1"): (20, 3, 50), ("train", "spk01", "sx2"): (20, 3, 40),
                ("train", "spk02", "si3"): (20, 3, 100)}
NOISY_DIR = "ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT"


def make_raw_tree(raw, proc=None, utts=RAW_UTTS, videos=RAW_VIDEOS, seed=0, noisy=()):
    """A raw NTCD-TIMIT tree for the builders under ``raw``: the clean
    utterances as ``ntcd_timit/Clean/volunteers/<spk>/straightcam/
    <utt>.wav`` (tones in bursts over a little noise) and a placeholder
    ``ntcd_timit/matlab_raw/<split dir>/<spk>/<utt>.mat`` for each (the
    catalog lists the .mat files); with ``noisy``, a list of (noise type,
    SNR), each utterance's raw mixture under ``<NOISY_DIR>/<noise>/<snr>/
    volunteers/<spk>/straightcam/<utt>.wav``; with ``proc``, the processed
    lip-video h5s of ``videos`` (:func:`write_videos`)."""
    rng = np.random.default_rng(seed)
    cleans = {}
    for split, entries in utts.items():
        for (spk, utt), n in entries.items():
            mat = raw / "ntcd_timit" / "matlab_raw" / SPLIT_DIRS[split] / spk / f"{utt}.mat"
            mat.parent.mkdir(parents=True, exist_ok=True)
            mat.write_bytes(b"")
            wav = raw / "ntcd_timit" / "Clean" / "volunteers" / spk / "straightcam" / f"{utt}.wav"
            wav.parent.mkdir(parents=True, exist_ok=True)
            t = np.arange(n) / 16000
            tone = np.sin(2 * np.pi * (120 + 200 * rng.random()) * t) * (t % 0.4 < 0.25)
            cleans[spk, utt] = 0.3 * tone + 0.01 * rng.standard_normal(n)
            write_wav(wav, cleans[spk, utt], 16000)
    noise_rng = np.random.default_rng(seed + 1)
    for noise, snr in noisy:
        for (spk, utt), clean in cleans.items():
            wav = raw / NOISY_DIR / noise / snr / "volunteers" / spk / "straightcam" / f"{utt}.wav"
            wav.parent.mkdir(parents=True, exist_ok=True)
            mix = clean + 0.05 * noise_rng.standard_normal(len(clean))
            write_wav(wav, mix / np.abs(mix).max() * 0.9, 16000)
    if proc is not None:
        write_videos(proc, videos)


def write_videos(proc, videos=RAW_VIDEOS, fmt="h5"):
    """The processed lip videos ``videos`` ({(split, spk, utt): shape of
    X}) under ``proc/ntcd_timit/matlab_raw/<split dir>/<spk>/
    <utt>_upsampled.<fmt>``: ``h5`` (h5py) or ``npz``."""
    for (split, spk, utt), shape in videos.items():
        path = proc / "ntcd_timit" / "matlab_raw" / SPLIT_DIRS[split] / spk / \
            f"{utt}_upsampled.{fmt}"
        path.parent.mkdir(parents=True, exist_ok=True)
        if fmt == "npz":
            np.savez(path, X=np.zeros(shape, np.float32))
            continue
        import h5py

        with h5py.File(path, "w") as f:
            f["X"] = np.zeros(shape, np.float32)


def write_lip_mats(raw, utts=RAW_UTTS, seed=0, side=67):
    """Replace each placeholder ``.mat`` of ``make_raw_tree(raw, utts=utts)``
    by a matlab v7.3-style file, HDF5 with one dataset: (frames, side *
    side) DCT coefficients at 30 fps for the utterance's duration, large at
    low orders and decaying with the order, their lowest coefficient
    following the utterance's bursts. Returns {(split, spk, utt): frames}."""
    import h5py

    rng = np.random.default_rng(seed)
    decay = np.exp(-np.add.outer(np.arange(side), np.arange(side)) / 8.0).ravel()
    frames = {}
    for split, entries in utts.items():
        for (spk, utt), n in entries.items():
            count = int(np.ceil(n / 16000 * 30))
            dct = rng.standard_normal((count, side * side)) * decay * 300.0
            dct[:, 0] += 2000.0 * ((np.arange(count) / 30.0) % 0.4 < 0.25)
            mat = raw / "ntcd_timit" / "matlab_raw" / SPLIT_DIRS[split] / spk / f"{utt}.mat"
            with h5py.File(mat, "w") as f:
                f["dctFeat"] = dct
            frames[split, spk, utt] = count
    return frames
