"""Sequence-model training: the LSTM voice-activity classifier (port of the
audio part of ``dvae_tpu.train.sequence``).

Whole-utterance batches of noisy log-power spectrograms, padded to a
bucketed common length; per-frame BCE masked by true length; F1
statistics over the valid frames; Adam. The spectrogram is taken on the
device, through :mod:`dvae_tpu_torch.ops.stft_power` (one launch per
batch). ``nn.LSTM`` runs on cuDNN on the card, in float32: the package
switches cuDNN's TF32 off at import.

Under a :class:`~dvae_tpu_torch.parallel.Mesh` with a process group each
process batches its contiguous rows of every global batch (one STFT power
launch on its own rows), the batch padded to a multiple of the mesh with
fully masked zero rows, as JAX pads it. The masked BCE is the global
batch's: each process divides its masked sum by the count of valid frames
all-reduced over the group, and the gradients and the F1 counts are
summed over it. Only rank 0 writes checkpoints.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models.losses import f1_from_counts
from dvae_tpu_torch.parallel.distributed import allreduce_sum, grad_allreduce
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped, samples_for_frames
from dvae_tpu_torch.ops.stft_power import log_power_spectrogram
from dvae_tpu_torch.parallel.mesh import replicate
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.loop import _resume_checkpoint
from dvae_tpu_torch.train.steps import _normalizer


def _seq_normalizer(norm, eps, device=None) -> Callable:
    """``steps._normalizer`` extended to tuple inputs. ``norm`` is None,
    one (mean, std) pair for a tensor input, or a tuple of per-component
    pairs or Nones for a tuple input, e.g. ``((audio_mean, audio_std),
    (pixel_mean, pixel_std))`` for ``AVVad``'s (audio, video); a (1, 1)
    pixel statistic broadcasts over (B, T, H, W)."""
    if (norm is not None and isinstance(norm, tuple)
            and all(n is None or isinstance(n, tuple) for n in norm)):
        fns = [_normalizer(n, eps, device) for n in norm]
        return lambda xs: tuple(f(x) for f, x in zip(fns, xs, strict=True))
    return _normalizer(norm, eps, device)


def _masked_bce(p, y, mask, eps, mesh=None):
    """The masked mean BCE over the valid frames; under a group this
    process's masked sum over the valid frames of the whole global
    batch, so that the group's sum is the global mean."""
    bce = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
    count = allreduce_sum(torch.sum(mask).detach(), mesh)
    return torch.sum(bce * mask) / torch.clamp(count, min=1.0)


def _frame_metrics(loss, p, y, mask, mesh=None) -> dict:
    """bce and the F1 statistics of the valid frames; under a group the
    bce shares and the four counts are summed over it first. The mask
    keeps padded frames out of the counts, so they do not score as true
    negatives."""
    hard = (p > 0.5).to(torch.float32) * mask
    y_true, m = (y * mask).reshape(-1), mask.reshape(-1)
    y_pred = hard.reshape(-1)
    sums = torch.stack([loss.detach(), torch.sum(m * y_true * y_pred),
                        torch.sum(m * (1 - y_true) * (1 - y_pred)),
                        torch.sum(m * (1 - y_true) * y_pred),
                        torch.sum(m * y_true * (1 - y_pred))])
    bce, tp, tn, fp, fn = allreduce_sum(sums, mesh).unbind()
    acc, prec, rec, f1 = f1_from_counts(tp, tn, fp, fn)
    return {"bce": bce, "accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def _group_of(mesh):
    return None if mesh is None or mesh.group is None else mesh


def make_lstm_vad_step(model, opt: torch.optim.Optimizer, eps: float = 1e-8,
                       norm=None, mesh=None) -> Callable:
    """``step(x (B, T, F), y (B, T), mask (B, T)) -> metrics``: one Adam
    update on the masked BCE. ``norm``: the optional (mean, std) train
    statistics of the input; the model sees (x - mean) / (std + eps).
    ``x`` may be a tuple (the AV model), and ``norm`` then has the tuple
    form of :func:`_seq_normalizer`. Under ``mesh`` (with a process group)
    the batch is this process's rows, and the loss, the gradients (summed)
    and the metrics are the global batch's."""
    normalize = _seq_normalizer(norm, eps, next(model.parameters()).device)
    group = _group_of(mesh)
    hook = grad_allreduce(group, mean=False)

    def step(x, y, mask):
        model.train()
        opt.zero_grad(set_to_none=True)
        p = model(normalize(x))
        loss = _masked_bce(p, y, mask, eps, group)
        loss.backward()
        if hook is not None:
            hook(opt)
        opt.step()
        return _frame_metrics(loss, p.detach(), y, mask, group)

    step.mesh = mesh
    return step


def make_lstm_vad_eval(model, eps: float = 1e-8, norm=None, mesh=None) -> Callable:
    """``evaluate(x, y, mask) -> metrics``, without an update; ``x``,
    ``norm`` and ``mesh`` as in :func:`make_lstm_vad_step`."""
    normalize = _seq_normalizer(norm, eps, next(model.parameters()).device)
    group = _group_of(mesh)

    @torch.no_grad()
    def evaluate(x, y, mask):
        model.eval()
        p = model(normalize(x))
        return _frame_metrics(_masked_bce(p, y, mask, eps, group), p, y, mask, group)

    evaluate.mesh = mesh
    return evaluate


def make_lstm_vad_predict(model, eps: float = 1e-8, norm=None) -> Callable:
    """``predict(x (B, T, F)) -> p (B, T)``, the frame-VAD posterior; ``x``
    and ``norm`` as in :func:`make_lstm_vad_step`."""
    normalize = _seq_normalizer(norm, eps, next(model.parameters()).device)

    @torch.no_grad()
    def predict(x):
        model.eval()
        return model(normalize(x))

    return predict


def batch_utterances(ds, indices, stft_cfg: StftConfig, pad_to_multiple: int = 64,
                     device=None):
    """Assemble (x (B, T, F) log-power, y (B, T), mask (B, T)) on ``device``
    (CUDA unless ``device="cpu"``) from a dataset whose items are
    ``(wav, labels)``: an :class:`~dvae_tpu_torch.data.datasets.
    UtteranceDataset` or any sequence of such pairs."""
    dev = resolve_device(device)
    xb, yb, mb = pad_utterances(ds, indices, stft_cfg, pad_to_multiple)
    spec = log_power_spectrogram(torch.from_numpy(xb).to(dev), stft_cfg)[:, :yb.shape[1]]
    return spec.contiguous(), torch.from_numpy(yb).to(dev), torch.from_numpy(mb).to(dev)


def pad_utterances(ds, indices, stft_cfg: StftConfig, pad_to_multiple: int = 64):
    """The host half of :func:`batch_utterances`: the (B, T_pad) waveforms,
    (B, T) labels and (B, T) mask as float32 numpy arrays, T bucketed up to
    a multiple of ``pad_to_multiple``."""
    wavs, labels = [], []
    for i in indices:
        w, y = ds[i]
        wavs.append(w)
        labels.append(np.asarray(y).reshape(-1))

    # outer max: labels trimmed to zero frames still occupy one (masked) row
    frames = [max(1, min(n_stft_frames_clamped(len(w), stft_cfg), len(l)))
              for w, l in zip(wavs, labels)]
    n_max = _bucket(frames, pad_to_multiple)
    t_pad = samples_for_frames(n_max, stft_cfg)

    xb = np.zeros((len(wavs), t_pad), np.float32)
    yb = np.zeros((len(wavs), n_max), np.float32)
    mb = np.zeros((len(wavs), n_max), np.float32)
    for j, (w, l, n) in enumerate(zip(wavs, labels, frames)):
        # a wav longer than t_pad (its labels trim the frames below what its
        # samples give) keeps only the samples the frames use
        t_use = min(len(w), t_pad)
        xb[j, :t_use] = w[:t_use]
        # a zero-length label vector leaves its one-frame placeholder row
        # fully masked
        n_lab = min(n, len(l))
        yb[j, :n_lab] = l[:n_lab]
        mb[j, :n_lab] = 1.0
    return xb, yb, mb


def _bucket(frames, pad_to_multiple: int) -> int:
    return -(-max(frames) // pad_to_multiple) * pad_to_multiple


def pad_video_utterances(ds, indices, pad_to_multiple: int = 64):
    """The host half of :func:`batch_video_utterances`: (B, T, H, W) video,
    (B, T) labels and (B, T) mask as float32 numpy arrays, zero-padded to a
    multiple of ``pad_to_multiple`` frames."""
    vids, labels = [], []
    for i in indices:
        v, y = ds[i]
        vids.append(np.asarray(v, np.float32))
        labels.append(np.asarray(y, np.float32).reshape(-1))
    frames = [max(1, min(len(v), len(l))) for v, l in zip(vids, labels)]
    n_max = _bucket(frames, pad_to_multiple)
    vb = np.zeros((len(vids), n_max) + vids[0].shape[1:], np.float32)
    yb = np.zeros((len(vids), n_max), np.float32)
    mb = np.zeros((len(vids), n_max), np.float32)
    for j, (v, l, n) in enumerate(zip(vids, labels, frames)):
        n_lab = min(n, len(l), len(v))
        vb[j, :n_lab] = v[:n_lab]
        yb[j, :n_lab] = l[:n_lab]
        mb[j, :n_lab] = 1.0
    return vb, yb, mb


def batch_video_utterances(ds, indices, pad_to_multiple: int = 64, device=None):
    """(v (B, T, H, W), y (B, T), mask (B, T)) on ``device`` (CUDA unless
    ``device="cpu"``) from a :class:`~dvae_tpu_torch.data.av_dataset.
    VideoDataset` or any sequence of (video, labels) pairs."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 pad_video_utterances(ds, indices, pad_to_multiple))


def pad_av_utterances(ds, indices, stft_cfg: StftConfig, pad_to_multiple: int = 64):
    """The host half of :func:`batch_av_utterances`: the (B, T_pad)
    waveforms, (B, T, H, W) video, (B, T) labels and (B, T) mask as float32
    numpy arrays; T is each utterance's frames clamped to its audio's and
    bucketed up to a multiple of ``pad_to_multiple``."""
    wavs, vids, labels = [], [], []
    for i in indices:
        w, v, y = ds[i]
        if y is None:
            raise ValueError("AV training batches need labeled triples")
        wavs.append(w)
        vids.append(np.asarray(v, np.float32))
        labels.append(np.asarray(y, np.float32).reshape(-1))
    # the dataset trimmed video and labels to the common count already;
    # clamp to the audio's frames too (their count depends on the STFT flags)
    frames = [max(1, min(n_stft_frames_clamped(len(w), stft_cfg), len(v), len(l)))
              for w, v, l in zip(wavs, vids, labels)]
    n_max = _bucket(frames, pad_to_multiple)
    t_pad = samples_for_frames(n_max, stft_cfg)
    xb = np.zeros((len(wavs), t_pad), np.float32)
    vb = np.zeros((len(wavs), n_max) + vids[0].shape[1:], np.float32)
    yb = np.zeros((len(wavs), n_max), np.float32)
    mb = np.zeros((len(wavs), n_max), np.float32)
    for j, (w, v, l, n) in enumerate(zip(wavs, vids, labels, frames)):
        t_use = min(len(w), t_pad)
        xb[j, :t_use] = w[:t_use]
        vb[j, :n] = v[:n]
        yb[j, :n] = l[:n]
        mb[j, :n] = 1.0
    return xb, vb, yb, mb


def batch_av_utterances(ds, indices, stft_cfg: StftConfig, pad_to_multiple: int = 64,
                        device=None):
    """((spec (B, T, F), v (B, T, H, W)), y (B, T), mask (B, T)) on
    ``device`` (CUDA unless ``device="cpu"``) from an
    :class:`~dvae_tpu_torch.data.av_dataset.AudioVisualDataset` or any
    sequence of labelled (wav, video, labels) triples: the input of
    ``AVVad``. The log-power spectrogram is one launch of the STFT power
    kernel on the card."""
    dev = resolve_device(device)
    xb, vb, yb, mb = pad_av_utterances(ds, indices, stft_cfg, pad_to_multiple)
    spec = log_power_spectrogram(torch.from_numpy(xb).to(dev), stft_cfg)[:, :yb.shape[1]]
    return ((spec.contiguous(), torch.from_numpy(vb).to(dev)), torch.from_numpy(yb).to(dev),
            torch.from_numpy(mb).to(dev))


def _zero_rows(batch, rows: int):
    """``batch`` (x or a tuple of inputs, y, mask) with its last ``rows``
    rows zeroed: fully masked zero rows, the padding of a global batch."""
    if rows == 0:
        return batch

    def zero(t):
        if isinstance(t, tuple):
            return tuple(zero(a) for a in t)
        t = t.clone()
        t[t.shape[0] - rows:] = 0
        return t

    return tuple(zero(t) for t in batch)


def _my_rows(indices, mesh):
    """This process's rows of a global batch of ``indices`` padded to a
    multiple of the mesh: (its indices, how many of its last rows are
    padding). A padding row batches the global batch's first utterance
    and is then zeroed and fully masked (:func:`_zero_rows`)."""
    indices = list(indices)
    if mesh is None:
        return indices, 0
    per = -(-len(indices) // mesh.size) * len(mesh.devices)
    mine = indices[mesh.rank * per:(mesh.rank + 1) * per]
    return mine + [indices[0]] * (per - len(mine)), per - len(mine)


def fit_sequence(model, opt, step, evaluate, train_ds, valid_ds, batcher, model_dir, *,
                 prefix: str, seed: int = 0, start_epoch: int = 1, end_epoch: int = 500,
                 batch_size: int = 16, mesh=None, log=print) -> list:
    """Epoch loop of the sequence classifier: per-epoch permutation
    ``np.random.default_rng((seed, epoch))`` (a resumed run replays the
    uninterrupted one), weights and Adam state resumed from epoch
    ``start_epoch - 1``, a validation pass, and one checkpoint per epoch
    named by the validation BCE. ``batcher(ds, indices) -> (x, y, mask)``,
    ``x`` a tuple for the AV model;
    ``step`` / ``evaluate`` come from :func:`make_lstm_vad_step` /
    :func:`make_lstm_vad_eval` over ``model`` and ``opt``, built with the
    same ``mesh``. Under a mesh with a process group each process batches
    its rows of every global batch, padded with fully masked zero rows;
    the replicas start from rank 0's weights; only rank 0 writes
    checkpoints and logs. Returns the per-epoch history."""
    if mesh is not None:
        mesh.device  # one device per process: raises otherwise
        if getattr(step, "mesh", None) is not mesh or getattr(evaluate, "mesh", None) is not mesh:
            raise ValueError("fit_sequence(mesh=) needs step and evaluate built with the "
                             "same mesh (make_lstm_vad_step / make_lstm_vad_eval(mesh=))")
        replicate(model, mesh)
    writer = mesh is None or mesh.rank == 0
    if not writer:
        log = _silent
    if start_epoch > 1:
        resume = _resume_checkpoint(model_dir, prefix, start_epoch)
        ckpt.load_checkpoint(resume, model, opt)
        log(f"resumed from {resume}")

    def mean_of(totals, n):
        return {k: float(v) / max(n, 1) for k, v in totals.items()}

    def run(fn, ds, indices):
        mine, pad = _my_rows(indices, mesh)
        return fn(*_zero_rows(batcher(ds, mine), pad))

    history = []
    for epoch in range(start_epoch, end_epoch):
        order = np.random.default_rng((seed, epoch)).permutation(len(train_ds))
        totals, n_batches = {}, 0
        for s in range(0, len(order), batch_size):
            m = run(step, train_ds, order[s:s + batch_size])
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            n_batches += 1
        avg = mean_of(totals, n_batches)
        log(f"epoch {epoch}: " + "  ".join(f"{k}={v:.4f}" for k, v in avg.items()))

        vt, vn = {}, 0
        for s0 in range(0, len(valid_ds), batch_size):
            m = run(evaluate, valid_ds, range(s0, min(s0 + batch_size, len(valid_ds))))
            for k, v in m.items():
                vt[k] = vt.get(k, 0.0) + v.double()
            vn += 1
        vavg = mean_of(vt, vn)
        log("  valid: " + "  ".join(f"{k}={v:.4f}" for k, v in vavg.items()))
        name = ckpt.checkpoint_name(prefix, epoch, vavg.get("bce", avg["bce"]))
        if writer:
            ckpt.save_checkpoint(model_dir, name, model, opt,
                                 metadata={"epoch": epoch, **avg,
                                           **{f"valid_{k}": v for k, v in vavg.items()}})
        history.append({"epoch": epoch, "train": avg, "valid": vavg})
    return history


def _silent(msg) -> None:
    pass
