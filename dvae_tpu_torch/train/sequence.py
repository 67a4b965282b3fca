"""Sequence-model training: the LSTM voice-activity classifier (port of the
audio part of ``dvae_tpu.train.sequence``).

Whole-utterance batches of noisy log-power spectrograms, padded to a
bucketed common length; per-frame BCE masked by true length; F1
statistics over the valid frames; Adam. The spectrogram is taken on the
device, through :mod:`dvae_tpu_torch.ops.stft_power` (one launch per
batch). ``nn.LSTM`` runs on cuDNN on the card, in float32: the package
switches cuDNN's TF32 off at import.

Not ported yet: the video and audio-visual batchers and their models
(ROADMAP A12), multi-GPU training (A14).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models.losses import f1_loss
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped, samples_for_frames
from dvae_tpu_torch.ops.stft_power import log_power_spectrogram
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.loop import _resume_checkpoint
from dvae_tpu_torch.train.steps import _normalizer


def _seq_normalizer(norm, eps, device=None) -> Callable:
    """``steps._normalizer`` for the audio net's plain (mean, std) pair. The
    per-component tuples of the audio-visual net are not ported yet."""
    if (norm is not None and isinstance(norm, tuple)
            and all(n is None or isinstance(n, tuple) for n in norm)):
        raise NotImplementedError(
            "per-component normalization of tuple inputs (the AV classifier) "
            "is not ported yet (ROADMAP A12)")
    return _normalizer(norm, eps, device)


def _masked_bce(p, y, mask, eps):
    bce = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
    return torch.sum(bce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _frame_stats(p, y, mask) -> dict:
    # the mask keeps padded frames out of the counts, so they do not score
    # as true negatives
    hard = (p > 0.5).to(torch.float32) * mask
    acc, prec, rec, f1 = f1_loss(hard, y * mask, mask=mask)
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def make_lstm_vad_step(model, opt: torch.optim.Optimizer, eps: float = 1e-8,
                       norm=None) -> Callable:
    """``step(x (B, T, F), y (B, T), mask (B, T)) -> metrics``: one Adam
    update on the masked BCE. ``norm``: the optional (mean, std) train
    statistics of the noisy log-power spectrogram; the LSTM sees
    (x - mean) / (std + eps)."""
    normalize = _seq_normalizer(norm, eps, next(model.parameters()).device)

    def step(x, y, mask):
        model.train()
        opt.zero_grad(set_to_none=True)
        p = model(normalize(x))
        loss = _masked_bce(p, y, mask, eps)
        loss.backward()
        opt.step()
        return {"bce": loss.detach(), **_frame_stats(p.detach(), y, mask)}

    return step


def make_lstm_vad_eval(model, eps: float = 1e-8, norm=None) -> Callable:
    """``evaluate(x, y, mask) -> metrics``, without an update."""
    normalize = _seq_normalizer(norm, eps, next(model.parameters()).device)

    @torch.no_grad()
    def evaluate(x, y, mask):
        model.eval()
        p = model(normalize(x))
        return {"bce": _masked_bce(p, y, mask, eps), **_frame_stats(p, y, mask)}

    return evaluate


def make_lstm_vad_predict(model, eps: float = 1e-8, norm=None) -> Callable:
    """``predict(x (B, T, F)) -> p (B, T)``, the frame-VAD posterior."""
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
    n_max = -(-max(frames) // pad_to_multiple) * pad_to_multiple
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


def fit_sequence(model, opt, step, evaluate, train_ds, valid_ds, batcher, model_dir, *,
                 prefix: str, seed: int = 0, start_epoch: int = 1, end_epoch: int = 500,
                 batch_size: int = 16, mesh=None, log=print) -> list:
    """Epoch loop of the sequence classifier: per-epoch permutation
    ``np.random.default_rng((seed, epoch))`` (a resumed run replays the
    uninterrupted one), weights and Adam state resumed from epoch
    ``start_epoch - 1``, a validation pass, and one checkpoint per epoch
    named by the validation BCE. ``batcher(ds, indices) -> (x, y, mask)``;
    ``step`` / ``evaluate`` come from :func:`make_lstm_vad_step` /
    :func:`make_lstm_vad_eval` over ``model`` and ``opt``. Returns the
    per-epoch history."""
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported yet (ROADMAP A14)")
    if start_epoch > 1:
        resume = _resume_checkpoint(model_dir, prefix, start_epoch)
        ckpt.load_checkpoint(resume, model, opt)
        log(f"resumed from {resume}")

    def mean_of(totals, n):
        return {k: float(v) / max(n, 1) for k, v in totals.items()}

    history = []
    for epoch in range(start_epoch, end_epoch):
        order = np.random.default_rng((seed, epoch)).permutation(len(train_ds))
        totals, n_batches = {}, 0
        for s in range(0, len(order), batch_size):
            m = step(*batcher(train_ds, order[s:s + batch_size]))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            n_batches += 1
        avg = mean_of(totals, n_batches)
        log(f"epoch {epoch}: " + "  ".join(f"{k}={v:.4f}" for k, v in avg.items()))

        vt, vn = {}, 0
        for s0 in range(0, len(valid_ds), batch_size):
            m = evaluate(*batcher(valid_ds, range(s0, min(s0 + batch_size, len(valid_ds)))))
            for k, v in m.items():
                vt[k] = vt.get(k, 0.0) + v.double()
            vn += 1
        vavg = mean_of(vt, vn)
        log("  valid: " + "  ".join(f"{k}={v:.4f}" for k, v in vavg.items()))
        name = ckpt.checkpoint_name(prefix, epoch, vavg.get("bce", avg["bce"]))
        ckpt.save_checkpoint(model_dir, name, model, opt,
                             metadata={"epoch": epoch, **avg,
                                       **{f"valid_{k}": v for k, v in vavg.items()}})
        history.append({"epoch": epoch, "train": avg, "valid": vavg})
    return history
