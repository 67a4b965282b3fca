"""Dataset builders (port of ``dvae_tpu.data.builders``): the reference's
create_* pipeline, host I/O around spectrograms taken on the device.

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
:func:`build_audio_train_set` copies the clean and noisy wavs into the
processed layout and writes each clean utterance's label file and the
noisy train mixtures' log-power statistics, again a chunk of utterances
per launch. :func:`build_video_files` walks the lip videos around the
per-utterance core :func:`build_video`: the IDCT preprocess on the device,
the clean utterance's labels, the 30 -> 62.5 fps upsample, and the train
split's pixel statistics. :func:`copy_ntcd_noisy_test` and
:func:`build_qut_test_set` are host-only (copies; QUT-noise mixtures).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import pathlib
import pickle
import shutil
from typing import NamedTuple

import numpy as np
import torch

from dvae_tpu_torch.data.catalog import ntcd_timit, qut
from dvae_tpu_torch.data.io import (
    need_h5py,
    read_wav,
    save_arrays,
    video_frames,
    write_labels,
    write_wav,
)
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.ops.stft import StftConfig, frame_signal, pad_signal
from dvae_tpu_torch.ops.stft_power import log_power_spectrogram, power_spectrogram
from dvae_tpu_torch.ops.targets import ibm_from_db, vad_from_energy
from dvae_tpu_torch.ops.video import preprocess_utterance, upsample_frames

DEFAULT_STFT = StftConfig(center=False)  # builder parametrization
# the frames of a waveform padded as DEFAULT_STFT pads it alone
_FRAMING = dataclasses.replace(DEFAULT_STFT, center=False, pad_at_end=False)
FS = 16000
LABELS = ("vad_labels", "ibm_labels")
FORMATS = ("h5", "npz")
NOISY_STATS = "ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics"
VIDEO_STATS = "ntcd_timit/matlab_raw/ntcd_timit_upsampled_statistics"
VISUAL_FPS_IN = 30.0
VISUAL_FPS_OUT = 62.5  # = 1 / (wlen_sec * hop_percent), create_video_train_files.py:57-58


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
    _check_labels(labels)
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
            n_video = video_frames(video.parent / (video.name + "_upsampled.h5"),
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
    video's frames where ``<proc_video_dir>/...<utt>_upsampled.{h5,npz}``
    exists (default ``output_dir``; see ``data.io.video_frames`` for
    ``legacy_video_trim``). It writes ``X_<split>`` (513, N), ``Y_<split>``
    (Yd, N) and, from the train split, ``X_train_mean`` / ``X_train_std``
    (513, 1), all float32, the statistics from float64 sums over every
    chunk. ``fmt="h5"`` writes the JAX builder's layout (lzf, chunks (F,
    1)) with ``h5py``; ``fmt="npz"`` the same arrays under the same names,
    without it."""
    _check_format(fmt)
    input_dir, output_dir = str(input_dir), str(output_dir)
    proc_video_dir = str(proc_video_dir) if proc_video_dir else output_dir
    dev = resolve_device(device)
    y_dim = 1 if labels == "vad_labels" else 513
    out_path = pathlib.Path(output_dir) / f"ntcd_timit/Clean_{labels}_upsampled.{fmt}"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}  # the .npz route's splits, (F, N) / (Yd, N)
    h5 = None
    if fmt == "h5":
        h5 = need_h5py(out_path).File(out_path, "w")
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
        save_arrays(out_path, arrays)
    return out_path


def _check_labels(labels) -> None:
    if labels is not None and labels not in LABELS:
        raise ValueError(f"unknown labels {labels!r}; expected one of {LABELS}")


def _check_format(fmt: str) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")


def frames_h5_to_npz(h5_path, npz_path=None) -> pathlib.Path:
    """Copy every array of a consolidated frame-set ``.h5`` unchanged into
    one ``.npz`` (default: beside it, same stem): the route from a corpus
    built on a CPU host to a machine without ``h5py``. Returns its path."""
    h5_path = pathlib.Path(h5_path)
    npz_path = h5_path.with_suffix(".npz") if npz_path is None else pathlib.Path(npz_path)
    with need_h5py(h5_path).File(h5_path, "r") as f:
        arrays = {k: f[k][()] for k in f.keys()}
    save_arrays(npz_path, arrays)
    return npz_path



def _copy_files(pairs, input_dir: str, output_dir: str, workers=None) -> list[pathlib.Path]:
    """Copy each ``(src_rel, dst_rel)`` from ``input_dir`` to ``output_dir``
    over a thread pool; returns the destinations in order."""
    def copy(pair):
        dst = pathlib.Path(output_dir) / pair[1]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(input_dir, pair[0]), dst)
        return dst

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(copy, pairs))


def _noisy_log_power_sums(wav_paths, clean_rels, output_dir: str, eps: float, chunk: int,
                          dev):
    """(n, sum, sum of squares) in float64 over the log-power frames of the
    noisy train mixtures ``wav_paths``, ``chunk`` per launch of the log
    epilogue, each mixture trimmed to the frames of its clean utterance's
    lip video (``clean_rels``) under ``output_dir``. A missing video raises,
    as in the reference: the train split has no untrimmed fallback."""
    n_sum, s_sum, sq_sum = 0, np.zeros(513), np.zeros(513)
    for s in range(0, len(wav_paths), chunk):
        wavs, limits = [], []
        for path, clean_rel in zip(wav_paths[s:s + chunk], clean_rels[s:s + chunk]):
            x, fs = read_wav(path)
            if fs != FS:  # reference create_audio_train_set.py:233
                raise ValueError(f"Unexpected sampling rate {fs} in {path}")
            video = pathlib.Path(output_dir) / pathlib.Path(
                clean_rel.replace("Clean", "matlab_raw")).with_suffix("")
            video = video.parent / (video.name + "_upsampled.h5")
            n_video = video_frames(video)
            if n_video is None:
                raise FileNotFoundError(f"no lip video {video} (or its .npz): the noisy train "
                                        "statistics trim each mixture to its video's frames")
            wavs.append(x)
            limits.append(n_video)
        batch, frames = padded_batch(wavs, DEFAULT_STFT)
        logp = log_power_spectrogram(batch.to(dev), _FRAMING, eps)
        counts = torch.tensor([min(n, m) for n, m in zip(frames, limits)])
        keep = torch.arange(logp.shape[1])[None, :] < counts[:, None]
        x64 = logp[keep.to(dev)].double()
        n_sum += x64.shape[0]
        s_sum += x64.sum(0).cpu().numpy()
        sq_sum += (x64 * x64).sum(0).cpu().numpy()
    return n_sum, s_sum, sq_sum


def build_audio_train_set(input_dir, output_dir, dataset_types=("train", "validation", "test"),
                          labels: str = "vad_labels", dataset_size: str = "complete",
                          upsampled: bool = True, workers=None, eps: float = 1e-8,
                          fmt: str = "h5", chunk: int = 256, device=None):
    """The audio training set (port of
    ``dvae_tpu.data.builders.build_audio_train_set``,
    create_audio_train_set.py). For each split of ``input_dir`` (the raw
    tree):

    * each clean wav is copied to the processed layout under ``output_dir``
      and gets a label file ``<utt>_<labels>_upsampled.<fmt>`` (``Y``,
      (y_dim, frames) float32) over all of its frames, untrimmed, from
      :func:`build_frames` on ``device`` (CUDA unless ``device="cpu"``),
      ``chunk`` utterances per launch;
    * each noisy wav of the pair grid (``noisy_clean_pair_dict``) is copied
      to its place on the copy grid (``noisy_speech_dict``); a pair outside
      the copy grid (the 15 dB wavs) or without its source wav is skipped;
    * from the train split's copies, the mixtures' log power
      ``log(|STFT|^2 + eps)`` (the builder's eps, through the kernel's log
      epilogue), each trimmed to its clean utterance's lip-video frames,
      gives ``X_train_mean`` / ``X_train_std`` (513, 1) float32 from float64
      sums (the JAX builder sums in float32), written to
      ``ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.<fmt>``.

    A sample rate other than 16 kHz and a missing video in the train split
    raise. ``fmt="h5"`` writes the JAX builder's files with ``h5py``,
    ``fmt="npz"`` the same arrays without it. Copies fan out over ``workers``
    threads. Returns the statistics file's path, or None when no train
    mixture was copied."""
    _check_format(fmt)
    input_dir, output_dir = str(input_dir), str(output_dir)
    if fmt == "h5":
        need_h5py(output_dir)
    dev = resolve_device(device)
    suffix = f"_{labels}_upsampled.{fmt}" if upsampled else f"_{labels}.{fmt}"
    stats = None
    for split in dataset_types:
        clean_in, clean_out = ntcd_timit.speech_list(input_dir + "/", split)
        dsts = _copy_files(list(zip(clean_in, clean_out)), input_dir, output_dir, workers)
        for s in range(0, len(dsts), chunk):
            part = dsts[s:s + chunk]
            fr = build_frames([read_wav(p)[0] for p in part], device=dev, labels=labels)
            for dst, y in zip(part, np.split(fr.y, np.cumsum(fr.counts)[:-1])):
                base = dst.with_suffix("")
                write_labels(base.parent / (base.name + suffix), y.T)

        out_map = ntcd_timit.noisy_speech_dict(input_dir + "/", split, dataset_size)
        pairs = [(noisy, clean) for noisy, clean in ntcd_timit.noisy_clean_pair_dict(
            input_dir + "/", split, dataset_size).items()
            if noisy in out_map and os.path.exists(os.path.join(input_dir, noisy))]
        dsts = _copy_files([(noisy, out_map[noisy]) for noisy, _ in pairs], input_dir,
                           output_dir, workers)
        if split != "train" or not dsts:
            continue
        n, s_sum, sq_sum = _noisy_log_power_sums(dsts, [c for _, c in pairs], output_dir, eps,
                                                 chunk, dev)
        if n:
            mean = s_sum / n
            stats = pathlib.Path(output_dir) / f"{NOISY_STATS}.{fmt}"
            stats.parent.mkdir(parents=True, exist_ok=True)
            save_arrays(stats, {"X_train_mean": mean[:, None].astype(np.float32),
                                "X_train_std": _empirical_std(sq_sum, mean, n)[:, None].astype(
                                    np.float32)})
    return stats


class Video(NamedTuple):
    x: np.ndarray  # (H, W, frames) float32 upsampled lip video in [0, 255]
    y: np.ndarray  # (y_dim, frames) float32 labels of the clean utterance


def utterance_labels(speech, labels: str = "vad_labels", device=None) -> np.ndarray:
    """(y_dim, frames) float32 labels of one clean utterance over all its
    frames, peak-normalized and padded as the builders pad it
    (``DEFAULT_STFT``): the VAD from the framed energy, or the IBM from the
    power spectrogram, one STFT power launch on the card. The labels
    :func:`build_frames` gives the same utterance."""
    _check_labels(labels)
    dev = resolve_device(device)
    batch, frames = padded_batch([speech], DEFAULT_STFT)
    batch = batch.to(dev)
    spec = power_spectrogram(batch, _FRAMING) if labels == "ibm_labels" else None
    own = torch.ones((1, frames[0]), dtype=torch.bool, device=dev)
    y = _frame_labels(labels, batch, spec, own, _FRAMING)[0, :frames[0]]
    return np.ascontiguousarray(y.T.cpu().numpy(), dtype=np.float32)


def build_video(dct_frames, speech, labels: str = "vad_labels", width: int = 67,
                height: int = 67, device=None) -> Video:
    """One utterance of :func:`build_video_files`: the lip video's DCT
    frames ((n, width * height) at 30 fps) preprocessed on ``device`` (CUDA
    unless ``device="cpu"``, ``ops/video.py``), the clean waveform's labels
    (:func:`utterance_labels`), and the video upsampled to 62.5 fps, one
    frame per label frame."""
    dev = resolve_device(device)
    video = preprocess_utterance(dct_frames, width, height, dev)  # (n, H, W)
    y = utterance_labels(speech, labels, dev)
    up = upsample_frames(video, VISUAL_FPS_IN, VISUAL_FPS_OUT, n_out=y.shape[-1])
    return Video(np.ascontiguousarray(np.moveaxis(up, 0, -1)), y)


def write_video(output_dir, mat_rel: str, labels: str, video: Video, fmt: str = "h5") -> None:
    """Write ``video`` where :func:`build_video_files` puts the lip video
    ``mat_rel`` (``ntcd_timit/matlab_raw/<split>/<spk>/<utt>.mat``):
    ``<utt>_upsampled.<fmt>`` beside where the ``.mat`` lies in the raw
    tree (``X``) and ``ntcd_timit/Clean/<split>/<spk>/
    <utt>_<labels>_upsampled.<fmt>`` (``Y``)."""
    base = pathlib.Path(output_dir) / pathlib.Path(mat_rel).with_suffix("")
    out = base.parent / (base.name + f"_upsampled.{fmt}")
    out.parent.mkdir(parents=True, exist_ok=True)
    save_arrays(out, {"X": np.asarray(video.x, np.float32)})
    lab = pathlib.Path(output_dir) / pathlib.Path(
        mat_rel.replace("matlab_raw", "Clean")).with_suffix("")
    lab = lab.parent / (lab.name + f"_{labels}_upsampled.{fmt}")
    lab.parent.mkdir(parents=True, exist_ok=True)
    write_labels(lab, video.y)


def save_video_statistics(output_dir, n: int, s_sum: float, sq_sum: float,
                          fmt: str = "h5") -> pathlib.Path:
    """``X_train_mean`` / ``X_train_std`` ((1, 1) float32, the std
    Bessel-corrected) of ``n`` train pixels with sum ``s_sum`` and sum of
    squares ``sq_sum``, written to ``<output_dir>/ntcd_timit/matlab_raw/
    ntcd_timit_upsampled_statistics.<fmt>``. Returns its path."""
    mean = s_sum / n
    path = pathlib.Path(output_dir) / f"{VIDEO_STATS}.{fmt}"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_arrays(path, {"X_train_mean": np.float32([[mean]]),
                       "X_train_std": np.float32([[_empirical_std(sq_sum, mean, n)]])})
    return path


def _read_mat_frames(path) -> np.ndarray:
    """The DCT frames of an NTCD lip ``.mat``: matlab v7.3, that is HDF5,
    its first dataset. Needs ``h5py``."""
    try:
        h5py = need_h5py(path)
    except RuntimeError:
        raise RuntimeError(
            f"{path}: NTCD's lip videos are matlab v7.3 (HDF5) files and need h5py, which "
            "this machine lacks; run create_video_train_files --format npz on a host that "
            "has it and copy the processed tree") from None
    with h5py.File(path, "r") as f:
        return np.array(f[next(iter(f.keys()))])


def build_video_files(input_dir, output_dir, dataset_types=("train", "validation", "test"),
                      labels: str = "vad_labels", width: int = 67, height: int = 67,
                      workers=None, fmt: str = "h5", device=None):
    """The lip-video training files (port of
    ``dvae_tpu.data.builders.build_video_files``,
    create_video_train_files.py): for each split of ``input_dir`` (the raw
    tree), each lip ``.mat`` and its clean utterance go through
    :func:`build_video` on ``device`` (CUDA unless ``device="cpu"``) and
    :func:`write_video`, over ``workers`` threads; the train split's pixels
    give ``X_train_mean`` / ``X_train_std`` (:func:`save_video_statistics`),
    summed in float64 (the JAX builder sums the pixels in float32).
    ``fmt="h5"`` writes the JAX builder's files with ``h5py``; ``fmt="npz"``
    the same arrays without it. Reading the ``.mat`` files needs ``h5py``
    either way. Returns the statistics file's path, or None when the train
    split has no video."""
    _check_format(fmt)
    _check_labels(labels)
    input_dir, output_dir = str(input_dir), str(output_dir)
    if fmt == "h5":
        need_h5py(output_dir)
    dev = resolve_device(device)
    n, s_sum, sq_sum = 0, 0.0, 0.0
    for split in dataset_types:
        mats = ntcd_timit.video_list(input_dir + "/", split)
        clean_in, _ = ntcd_timit.speech_list(input_dir + "/", split)

        def process(pair):
            mat_rel, clean_rel = pair
            speech, _ = read_wav(os.path.join(input_dir, clean_rel))
            video = build_video(_read_mat_frames(os.path.join(input_dir, mat_rel)), speech,
                                labels, width, height, dev)
            write_video(output_dir, mat_rel, labels, video, fmt)
            return video.x

        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            for x in ex.map(process, zip(mats, clean_in)):
                if split == "train":
                    x64 = x.astype(np.float64)
                    n += x64.size
                    s_sum += float(x64.sum())
                    sq_sum += float((x64 * x64).sum())
    return save_video_statistics(output_dir, n, s_sum, sq_sum, fmt) if n else None


def copy_ntcd_noisy_test(input_dir, output_dir, dataset_type: str = "test",
                         dataset_size: str = "complete") -> int:
    """Copy the pre-mixed Noisy_TCDTIMIT wavs of a split into the processed
    layout (port of ``dvae_tpu.data.builders.copy_ntcd_noisy_test``,
    create_audio_set_ntcd_noise.py:111-133); a missing source is skipped.
    Returns the number copied."""
    input_dir, output_dir = str(input_dir), str(output_dir)
    pairs = ntcd_timit.noisy_speech_dict(input_dir + "/", dataset_type, dataset_size)
    todo = [(src, dst) for src, dst in pairs.items()
            if os.path.exists(os.path.join(input_dir, src))]
    return len(_copy_files(todo, input_dir, output_dir))


def build_qut_test_set(input_speech_dir, noise_dir, output_dir, dataset_type: str = "test",
                       snrs=(-15.0, -10.0, -5.0, 0.0, 5.0), seed: int = 0, workers=None):
    """QUT-noise mixtures at a random noise type and SNR per utterance (port
    of ``dvae_tpu.data.builders.build_qut_test_set``, create_test_set.py:
    80-199): the power-ratio noise gain, the joint renormalization, the
    ``_s/_n/_x.wav`` triplets and the pickled SNR list. Draws as the
    reference does: numpy's global RNG seeded with ``seed`` picks every
    noise type and SNR, and ``default_rng(seed + i)`` crops utterance i's
    noise. A sample rate other than 16 kHz, no preprocessed noise, and a
    drawn noise type that is absent raise. Returns the SNRs drawn."""
    input_speech_dir, output_dir = str(input_speech_dir), str(output_dir)
    clean_in, clean_out = ntcd_timit.speech_list(input_speech_dir + "/", dataset_type)

    noise_paths = qut.noise_list_preprocessed(str(noise_dir) + "/", dataset_type)
    noise_audios = {}
    for k, p in noise_paths.items():
        if os.path.exists(p):
            audio, fs_noise = read_wav(p)
            if fs_noise != FS:  # reference create_test_set.py:159-160
                raise ValueError(
                    f"Unexpected sampling rate {fs_noise} in {p} (want {FS}); "
                    "preprocess the noise first (qut.preprocess_noise)")
            noise_audios[k] = audio
    if not noise_audios:
        raise FileNotFoundError(f"no preprocessed QUT noise under {noise_dir}")

    np.random.seed(seed)  # reference seeding (create_test_set.py:137)
    noise_types = ["cafe", "home", "street", "car"]
    noise_index = np.random.randint(len(noise_types), size=len(clean_in))
    snrs = list(snrs)
    snrs_index = np.random.randint(len(snrs), size=len(clean_in))
    all_snr_db = [snrs[i] for i in snrs_index]

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, dataset_type + "_snr_db.p"), "wb") as f:
        pickle.dump(all_snr_db, f, protocol=4)

    def process(i):
        speech, fs = read_wav(os.path.join(input_speech_dir, clean_in[i]))
        if fs != FS:  # reference create_test_set.py:98-99
            raise ValueError(f"Unexpected sampling rate {fs} in {clean_in[i]}")
        peak = np.max(np.abs(speech))
        if peak > 0:  # a digitally silent wav must not become all-NaN
            speech = speech / peak
        ntype = noise_types[noise_index[i] % len(noise_types)]
        if ntype not in noise_audios:
            raise KeyError(
                f"drawn noise type {ntype!r} not in the preprocessed noise dir "
                f"(available: {sorted(noise_audios)}); a silent substitution "
                f"would skew the test set's noise-type distribution")
        noise = qut.noise_segment(noise_audios, ntype, speech,
                                  rng=np.random.default_rng(seed + i))
        snr_db = all_snr_db[i]
        k = (np.sum(speech**2) * 10 ** (-snr_db / 10)) / np.sum(noise**2)
        noise = noise * np.sqrt(k)
        norm = np.max(np.abs(np.concatenate([speech, noise, speech + noise])))
        out_base = pathlib.Path(output_dir) / pathlib.Path(clean_out[i]).with_suffix("")
        out_base.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(out_base) + "_s.wav", speech / norm, fs)
        write_wav(str(out_base) + "_n.wav", noise / norm, fs)
        write_wav(str(out_base) + "_x.wav", (speech + noise) / norm, fs)

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(process, range(len(clean_in))))
    return all_snr_db
