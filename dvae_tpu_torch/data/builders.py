"""Frame-set builder core (port of the per-utterance part of
``dvae_tpu.data.builders.build_frame_dataset``).

:func:`build_frames` turns clean utterances into the linear-power frame
rows the VAE trainers consume, with the train statistics beside them and,
when asked, each row's VAD or IBM label (``_labels_for`` of the JAX
builder). The spectrogram runs on the device through
:mod:`dvae_tpu_torch.ops.stft_power` in one launch: each utterance gets its
own padding (the end-pad quirk depends on its own length), the padded
signals are zero-padded to the longest, and each row keeps only its own
frames, which lie inside its own padded length and so do not see the
shared zeros. The labels take each utterance's own frames the same way.

:func:`build_frame_dataset` walks the NTCD catalog and writes the
consolidated frame set ``ntcd_timit/Clean_<labels>_upsampled.{h5,npz}``
from chunks of utterances, one launch each; :func:`frames_h5_to_npz` copies
an ``.h5`` frame set to the ``.npz`` that a machine without ``h5py`` reads.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.ops.stft import StftConfig, frame_signal, pad_signal
from dvae_tpu_torch.ops.stft_power import power_spectrogram
from dvae_tpu_torch.ops.targets import ibm_from_db, vad_from_energy

DEFAULT_STFT = StftConfig(center=False)  # builder parametrization
LABELS = ("vad_labels", "ibm_labels")


def _empirical_std(sq_sum, mean, n):
    """Bessel-corrected std from accumulated sums, sqrt((sq_sum - n mean^2)
    / (n - 1)), as the reference builders compute it (create_train_set.py:
    204-207)."""
    return np.sqrt(np.maximum(sq_sum - n * mean**2, 0.0) / (n - 1))


class Frames(NamedTuple):
    x: np.ndarray       # (N, F) float32 linear power rows, utterance after utterance
    counts: list        # frames kept of each utterance
    mean: np.ndarray    # (F, 1) float32 train mean over the rows
    std: np.ndarray     # (F, 1) float32 empirical std over the rows
    y: np.ndarray | None = None  # (N, 1) VAD or (N, F) IBM float32 labels, or None


def padded_batch(wavs, cfg: StftConfig = DEFAULT_STFT):
    """Peak-normalize each utterance and pad it as ``cfg`` pads it alone,
    then zero-pad all to the longest -> ((B, T_pad) float32 CPU tensor,
    frames of each utterance)."""
    rows, frames = [], []
    for w in wavs:
        speech = np.asarray(w, np.float64)
        peak = np.max(np.abs(speech))
        if peak > 0:
            speech = speech / peak
        row = pad_signal(torch.from_numpy(speech.astype(np.float32)), cfg)
        rows.append(row)
        frames.append(max(0, 1 + (row.shape[0] - cfg.nfft) // cfg.hop))
    batch = torch.zeros((len(rows), max(r.shape[0] for r in rows)))
    for j, row in enumerate(rows):
        batch[j, :row.shape[0]] = row
    return batch, frames


def _frame_labels(labels: str, batch: torch.Tensor, spec: torch.Tensor,
                  own: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(B, frames, Yd) labels of the padded batch, each row's from its own
    frames (``own``, (B, frames) bool): the VAD's quietest frame and the
    IBM's loudest bin are taken over them alone, never over the zeros that
    pad a row to the batch's length."""
    if labels == "vad_labels":
        energy = torch.sum(frame_signal(batch, cfg.nfft, cfg.hop) ** 2, dim=-1)
        energy = torch.where(own, energy, torch.full_like(energy, float("inf")))
        return vad_from_energy(energy)[..., None]
    # |S| as sqrt of the kernel's power: the JAX builder takes |stft| of
    # the matmul DFT, so a bin within rounding of peak - 50 dB may flip
    db = 20.0 * torch.log10(torch.sqrt(spec) + 1e-8)
    peak = torch.where(own[..., None], db, torch.full_like(db, -float("inf")))
    return ibm_from_db(db, torch.amax(peak, dim=(-2, -1), keepdim=True))


def build_frames(wavs, cfg: StftConfig = DEFAULT_STFT, max_frames=None,
                 device=None, labels: str | None = None) -> Frames:
    """Peak-normalize each utterance, take its |STFT|^2 on ``device`` (CUDA
    unless ``device="cpu"``), keep at most ``max_frames[i]`` frames of it,
    and return the rows with their mean and empirical std.

    ``labels`` adds each row's label as ``Frames.y``: ``"vad_labels"``
    (N, 1), the energy VAD of the padded time signal, or ``"ibm_labels"``
    (N, F), the IBM of the same spectrogram as the rows (``sqrt`` of the
    power, so no second launch). The JAX builder takes the IBM from the
    complex matmul-DFT STFT instead, so a bin whose dB value lies within
    rounding of the utterance's peak - 50 dB may come out the other way.
    Each utterance's labels are computed over all its frames, then trimmed
    with its rows (``n = min(spec frames, label frames, max_frames)``)."""
    if labels is not None and labels not in LABELS:
        raise ValueError(f"unknown labels {labels!r}; expected one of {LABELS}")
    batch, frames = padded_batch(wavs, cfg)
    dev = resolve_device(device)
    # the rows are padded already: frame them as they stand
    framing = dataclasses.replace(cfg, center=False, pad_at_end=False)
    batch = batch.to(dev)
    spec = power_spectrogram(batch, framing)
    counts = frames if max_frames is None else [min(n, int(m)) for n, m in
                                                zip(frames, max_frames)]
    keep = torch.arange(spec.shape[1])[None, :] < torch.tensor(counts)[:, None]
    x = spec[keep.to(dev)]  # utterance after utterance
    y = None
    if labels is not None:
        own = torch.arange(spec.shape[1])[None, :] < torch.tensor(frames)[:, None]
        y = _frame_labels(labels, batch, spec, own.to(dev), framing)[keep.to(dev)]
        y = y.cpu().numpy()
    x64 = x.double()
    n_sum = x.shape[0]
    mean = (x64.sum(0) / n_sum).cpu().numpy()
    std = _empirical_std((x64 * x64).sum(0).cpu().numpy(), mean, n_sum)
    return Frames(x.cpu().numpy(), counts, mean[:, None].astype(np.float32),
                  std[:, None].astype(np.float32), y)


def _video_frames(video_path: pathlib.Path, legacy_video_trim: bool):
    """Frames of the utterance's processed lip video, or None without one.
    ``legacy_video_trim`` takes ``shape[0]`` of the stored (67, 67, frames)
    video, the image height, as the reference builder does
    (create_train_set.py:181-186). Reading the h5 needs ``h5py``: where it
    is missing, an existing video is an error, never a skipped trim."""
    if not video_path.exists():
        return None
    import h5py

    with h5py.File(video_path, "r") as vf:
        vshape = vf["X"].shape
    return vshape[0] if legacy_video_trim else vshape[-1]


def _split_frames(input_dir: str, proc_video_dir: str, split: str, labels: str,
                  legacy_video_trim: bool, chunk: int, dev):
    """Yield (x (n, F), y (n, Yd)) float32 frame blocks of one split in the
    catalog's order, ``chunk`` utterances per launch."""
    clean_in, _ = ntcd_timit.speech_list(input_dir + "/", split)
    mats = ntcd_timit.video_list(input_dir + "/", split)
    for s in range(0, len(clean_in), chunk):
        wavs, limits = [], []
        for in_rel, mat_rel in zip(clean_in[s:s + chunk], mats[s:s + chunk]):
            wavs.append(read_wav(os.path.join(input_dir, in_rel))[0])
            video = pathlib.Path(proc_video_dir) / pathlib.Path(mat_rel).with_suffix("")
            n_video = _video_frames(video.parent / (video.name + "_upsampled.h5"),
                                    legacy_video_trim)
            limits.append(np.iinfo(np.int64).max if n_video is None else n_video)
        fr = build_frames(wavs, max_frames=limits, device=dev, labels=labels)
        yield fr.x, fr.y


def build_frame_dataset(input_dir, output_dir, labels: str = "vad_labels",
                        dataset_types=("train", "validation"), proc_video_dir=None,
                        legacy_video_trim: bool = False, fmt: str = "h5",
                        chunk: int = 256, device=None) -> pathlib.Path:
    """The consolidated frame set (port of
    ``dvae_tpu.data.builders.build_frame_dataset``, create_train_set.py:
    91-218): ``<output_dir>/ntcd_timit/Clean_<labels>_upsampled.<fmt>``.

    For each split it walks the catalog of ``input_dir`` (the raw tree),
    takes each clean utterance's power frames and labels through
    :func:`build_frames` on ``device`` (CUDA unless ``device="cpu"``),
    ``chunk`` utterances per launch, and trims each utterance to its lip
    video's frames where ``<proc_video_dir>/...<utt>_upsampled.h5`` exists
    (default ``output_dir``; see :func:`_video_frames` for
    ``legacy_video_trim``). It writes ``X_<split>`` (513, N), ``Y_<split>``
    (Yd, N) and, from the train split, ``X_train_mean`` / ``X_train_std``
    (513, 1), all float32, the statistics from float64 sums over every
    chunk. ``fmt="h5"`` writes the JAX builder's layout (lzf, chunks (F,
    1)) with ``h5py``; ``fmt="npz"`` the same arrays under the same names,
    without it."""
    if fmt not in ("h5", "npz"):
        raise ValueError(f"fmt must be h5 or npz, got {fmt!r}")
    input_dir, output_dir = str(input_dir), str(output_dir)
    proc_video_dir = str(proc_video_dir) if proc_video_dir else output_dir
    dev = resolve_device(device)
    y_dim = 1 if labels == "vad_labels" else 513
    out_path = pathlib.Path(output_dir) / f"ntcd_timit/Clean_{labels}_upsampled.{fmt}"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}  # the .npz route's splits, (F, N) / (Yd, N)
    h5 = None
    if fmt == "h5":
        import h5py

        h5 = h5py.File(out_path, "w")
    try:
        for split in dataset_types:
            if h5 is not None:
                fx = h5.create_dataset(f"X_{split}", (513, 0), maxshape=(513, None),
                                       chunks=(513, 1), compression="lzf", dtype="float32")
                fy = h5.create_dataset(f"Y_{split}", (y_dim, 0), maxshape=(y_dim, None),
                                       chunks=(y_dim, 1), compression="lzf", dtype="float32")
            xs, ys = [], []
            n_sum, s_sum, sq_sum = 0, np.zeros(513), np.zeros(513)
            for x, y in _split_frames(input_dir, proc_video_dir, split, labels,
                                      legacy_video_trim, chunk, dev):
                if h5 is not None:
                    start = fx.shape[1]
                    fx.resize(start + len(x), axis=1)
                    fy.resize(start + len(x), axis=1)
                    fx[:, start:] = x.T
                    fy[:, start:] = y.T
                else:
                    xs.append(x)
                    ys.append(y)
                if split == "train":
                    x64 = x.astype(np.float64)
                    n_sum += len(x)
                    s_sum += x64.sum(0)
                    sq_sum += (x64 * x64).sum(0)
            if h5 is None:
                arrays[f"X_{split}"] = np.concatenate(xs or [np.zeros((0, 513), np.float32)]).T
                arrays[f"Y_{split}"] = np.concatenate(
                    ys or [np.zeros((0, y_dim), np.float32)]).T
            if split == "train" and n_sum:
                mean = s_sum / n_sum
                stats = {"X_train_mean": mean[:, None].astype(np.float32),
                         "X_train_std": _empirical_std(sq_sum, mean, n_sum)[:, None].astype(
                             np.float32)}
                for k, v in stats.items():
                    if h5 is not None:
                        h5.create_dataset(k, data=v)
                    else:
                        arrays[k] = v
    finally:
        if h5 is not None:
            h5.close()
    if h5 is None:
        _save_npz(out_path, arrays)
    return out_path


def _save_npz(path: pathlib.Path, arrays: dict) -> None:
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **{k: np.ascontiguousarray(v) for k, v in arrays.items()})
    tmp.replace(path)


def frames_h5_to_npz(h5_path, npz_path=None) -> pathlib.Path:
    """Copy every array of a consolidated frame-set ``.h5`` unchanged into
    one ``.npz`` (default: beside it, same stem): the route from a corpus
    built on a CPU host to a machine without ``h5py``. Returns its path."""
    import h5py

    h5_path = pathlib.Path(h5_path)
    npz_path = h5_path.with_suffix(".npz") if npz_path is None else pathlib.Path(npz_path)
    with h5py.File(h5_path, "r") as f:
        arrays = {k: f[k][()] for k in f.keys()}
    _save_npz(npz_path, arrays)
    return npz_path
