"""Batched enhancement sweeps over the NTCD-TIMIT noisy test set (port copy
of ``dvae_tpu.enhance.evaluate``).

Utterances are grouped into batches, each batch runs through the
``Enhancer``, and outputs are written in the reference's layout
(``<output_dir>/<relative noisy path>_s_est.wav`` / ``_n_est.wav``), with
the reference's idempotent resume-by-skip. Oracle labels and lip videos
(for the frame counts) are ``.h5`` files, read with ``h5py``, or the
``.npz`` of the same arrays, read without it (``data/io.py``): a machine
without ``h5py`` sweeps a tree of ``.npz`` files.
"""

from __future__ import annotations

import glob
import os
import pathlib

import numpy as np

from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import read_labels, read_wav, video_frames, write_wav


def load_oracle_labels(label_path) -> np.ndarray:
    """(n_frames, y_dim) oracle labels from a builder's label file, ``.h5``
    or ``.npz`` (its ``Y`` is (y_dim, n_frames))."""
    return np.ascontiguousarray(read_labels(label_path).T)


def classifier_label_candidates(classifier_dir, speaker, utt,
                                rel_dir: str | None = None) -> list[str]:
    """Ordered direct-layout candidate paths for ``<utt>_y_hat_hard.{pt,npy}``:
    the condition-mirrored layout ``<dir>/<rel_dir>/`` first, then the
    reference's ``<dir>/<spk>/``; .pt before .npy in each."""
    candidates = []
    if rel_dir is not None:
        candidates += [os.path.join(classifier_dir, rel_dir, f"{utt}_y_hat_hard{ext}")
                       for ext in (".pt", ".npy")]
    candidates += [os.path.join(classifier_dir, speaker, f"{utt}_y_hat_hard{ext}")
                   for ext in (".pt", ".npy")]
    return candidates


def find_classifier_labels(classifier_dir, speaker, utt, y_dim: int | None = None,
                           rel_dir: str | None = None) -> np.ndarray:
    """Locate and load ``<utt>_y_hat_hard.{pt,npy}`` for a speaker: the
    candidates of :func:`classifier_label_candidates` in order (an
    utterance is conditioned on the labels predicted from its own mixture
    when a condition-mirrored file exists), then a recursive search for
    either extension under any subdirectory, sorted (.pt first) so that
    every machine of a sharded sweep picks the same file. ``y_dim``
    resolves a 2-D array's orientation (:func:`load_classifier_labels`)."""
    for direct in classifier_label_candidates(classifier_dir, speaker, utt, rel_dir):
        if os.path.exists(direct):
            return load_classifier_labels(direct, y_dim)
    hits = sorted(glob.glob(os.path.join(classifier_dir, "**", speaker,
                                         utt + "_y_hat_hard.*"), recursive=True),
                  key=lambda p: (not p.endswith(".pt"), p))
    if hits:
        return load_classifier_labels(hits[0], y_dim)
    raise FileNotFoundError(
        f"no {utt}_y_hat_hard.pt/.npy for speaker {speaker} under {classifier_dir}")


def load_classifier_labels(pt_or_npy_path, y_dim: int | None = None) -> np.ndarray:
    """Pre-computed classifier outputs, a tensor saved as ``.pt`` (read with
    ``torch.load(weights_only=True)``) or a ``.npy`` array, as
    ``(n_frames, y_dim)``. Pass ``y_dim`` (1 for VAD, 513 for IBM masks)
    to resolve the orientation exactly; without it a 2-D array is taken
    frames-last when its first dim is the smaller."""
    p = str(pt_or_npy_path)
    if p.endswith(".pt"):
        import torch

        y = torch.load(p, map_location="cpu", weights_only=True)
        y = y.numpy() if hasattr(y, "numpy") else np.asarray(y)
    else:
        y = np.load(p)
    y = np.asarray(y, dtype=np.float32)
    if y_dim is not None and y_dim > 1:
        if y.ndim == 1:
            return y[None, :] if len(y) == y_dim else y[:, None]
        if y.shape[-1] == y_dim:
            return y
        if y.shape[0] == y_dim:
            return y.T
        raise ValueError(f"{pt_or_npy_path}: shape {y.shape} has no axis of "
                         f"size y_dim={y_dim}")
    if y.ndim == 1:
        return y[:, None]
    if 1 in y.shape:
        return y.reshape(-1, 1)
    if y.shape[0] < y.shape[1]:
        y = y.T
    return y


def clean_audio_rel(clean_rel: str, labels: str) -> str:
    """Label-h5 rel path -> clean audio rel path (the reference's rewrite)."""
    rel = clean_rel.replace("_" + labels, "").replace("_upsampled", "")
    return os.path.splitext(rel)[0] + ".wav"


def video_frame_counts(processed_dir, clean_rel_paths, labels: str):
    """Per-utterance video frame counts (the reference trims the
    spectrogram to the video length), from the lip video ``.h5`` or
    ``.npz`` beside each label file's path; None where neither exists."""
    return [video_frames(os.path.join(
        processed_dir, rel.replace("Clean", "matlab_raw").replace("_" + labels, "")))
        for rel in clean_rel_paths]


def shard_slice(items, shard: tuple[int, int] | None):
    """The k-th of n contiguous ``np.array_split``-sized chunks of ``items``;
    ``items`` itself when ``shard`` is None. Shared by the sweep and any
    per-utterance pre-pass, so that every stage of one invocation covers
    the same utterances."""
    if shard is None:
        return items
    k, n = shard
    if not 0 <= k < n:
        raise ValueError(f"shard index {k} out of range for {n} shards")
    q, r = divmod(len(items), n)
    start = k * q + min(k, r)
    return items[start: start + q + (1 if k < r else 0)]


def evaluate_sweep(enhancer, processed_dir, output_dir, dataset_type: str = "test",
                   dataset_size: str = "complete", labels: str = "vad_labels",
                   upsampled: bool = True, snr_filter: str | None = "10",
                   batch_size: int = 16, y_loader=None, suffix: str = "",
                   skip_existing: bool = True, seed: int = 0, log=print,
                   shard: tuple[int, int] | None = None) -> int:
    """Run the enhancement sweep over the catalog's noisy test utterances.

    Args:
        enhancer: a bound ``dvae_tpu_torch.enhance.pipeline.Enhancer``.
        y_loader: optional ``(noisy_rel, clean_rel) -> (n_frames, y_dim)``
            labels for conditional models.
        snr_filter: keep only this SNR (the reference keeps '10'); None
            keeps all.
        suffix: inserted in output names (e.g. '_y_hat_hard' ->
            ``*_s_est_y_hat_hard.wav``).
        seed: integer seed of the enhancer's random streams.
        shard: optional ``(k, n)``: take the k-th contiguous chunk of the
            (SNR-filtered, pre-skip) utterance list, sized as
            ``np.array_split``, before the skip-existing filter, so that
            shard membership is stable across restarts.

    Under a clean-z ablation (``enhancer.cfg.ablation``) the clean
    waveforms are read beside the mixtures and the output names carry the
    reference's golden prefix (``<utt>_clean_z_nomcem_s_est<suffix>.wav``).
    Pending utterances are sorted by mixture file size (then path), so each
    batch holds utterances of similar length. Each ``n_est`` is written
    before its ``s_est``: resume-by-skip keys on ``s_est``, so the skip
    marker is the last file written. Returns the number of utterances
    enhanced.
    """
    ablation = enhancer.cfg.ablation
    prefix = "" if ablation == "none" else "_" + ablation
    pairs = ntcd_timit.proc_noisy_clean_pair_dict(
        str(processed_dir) + "/", dataset_type, dataset_size, labels, upsampled)
    items = list(pairs.items())
    if snr_filter is not None:
        items = [it for it in items if it[0].split("/")[-4] == str(snr_filter)]
    items = shard_slice(items, shard)

    todo = []
    for noisy_rel, clean_rel in items:
        out_base = pathlib.Path(output_dir) / pathlib.Path(noisy_rel).with_suffix("")
        s_path = out_base.parent / (out_base.name + f"{prefix}_s_est{suffix}.wav")
        if skip_existing and s_path.exists():
            continue
        todo.append((noisy_rel, clean_rel, out_base))
    todo.sort(key=lambda t: (os.path.getsize(os.path.join(processed_dir, t[0])), t[0]))
    chunks = [todo[s: s + batch_size] for s in range(0, len(todo), batch_size)]

    def batches():
        # reading batch k + 1 overlaps the device's work on batch k
        for chunk in chunks:
            wavs, ys, cleans = [], [], []
            for noisy_rel, clean_rel, _ in chunk:
                x, _ = read_wav(os.path.join(processed_dir, noisy_rel))
                wavs.append(x.astype(np.float32))
                if y_loader is not None:
                    ys.append(y_loader(noisy_rel, clean_rel))
                if ablation != "none":
                    s, _ = read_wav(os.path.join(processed_dir,
                                                 clean_audio_rel(clean_rel, labels)))
                    cleans.append(s.astype(np.float32))
            counts = video_frame_counts(processed_dir, [c for _, c, _ in chunk], labels)
            mf = [c if c is not None else 10**9 for c in counts]
            yield (wavs, ys if y_loader else None, mf,
                   cleans if ablation != "none" else None)

    n_done = 0
    fs = enhancer.cfg.stft.fs
    for chunk, out in zip(chunks, enhancer.enhance_stream(batches(), seed=seed)):
        for (_, _, out_base), (s_hat, n_hat) in zip(chunk, out):
            out_base.parent.mkdir(parents=True, exist_ok=True)
            write_wav(out_base.parent / (out_base.name + f"{prefix}_n_est{suffix}.wav"),
                      n_hat, fs)
            write_wav(out_base.parent / (out_base.name + f"{prefix}_s_est{suffix}.wav"),
                      s_hat, fs)
            n_done += 1
        log(f"enhanced {n_done}/{len(todo)}")
    return n_done
