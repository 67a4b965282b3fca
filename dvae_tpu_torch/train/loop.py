"""Epoch-driven frame-level training with reference-format logs and
checkpoints (port of ``dvae_tpu.train.loop`` on one device): ``fit_vae``
(M1, and M2 with ``conditional=True``), ``fit_semisup`` (M2v3) and
``fit_adversarial`` (M2-info and CVAE_v4).

Per-batch metrics go to ``output_batch.log`` every ``log_interval`` steps,
per-epoch train and validation lines to stdout and ``output_epoch.log``,
and one checkpoint per epoch named ``<prefix>_epoch_{e:03d}_vloss_{v:.2f}``
(see :mod:`dvae_tpu_torch.train.checkpoint`).

Every epoch's randomness is a pure function of ``(seed, epoch)``: the
shuffle is ``np.random.default_rng((seed, epoch))`` as in the JAX loop, and
the reparameterization noise comes from a ``torch.Generator`` seeded from
the same pair. A run resumed at ``start_epoch`` therefore replays the
uninterrupted run exactly.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from dvae_tpu_torch.data.datasets import index_batches
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models.blocks import init_xavier_
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.steps import (
    adam,
    init_adversarial_state,
    make_adversarial_eval_step,
    make_adversarial_step,
    make_eval_step,
    make_semisup_eval_step,
    make_semisup_step,
    make_train_step,
)


@dataclasses.dataclass
class LoopConfig:
    batch_size: int = 128
    learning_rate: float = 1e-4
    start_epoch: int = 1
    end_epoch: int = 500
    log_interval: int = 250
    seed: int = 0
    eps: float = 1e-8
    std_norm: bool = False
    drop_last: bool = False
    # K optimizer steps per dispatch; only 1 is ported (K > 1 would be a
    # CUDA graph over K steps here, ROADMAP A12.5)
    steps_per_dispatch: int = 1
    # upload each split (rows and labels) to the device once and gather each
    # batch by index there, instead of copying every batch from the host:
    # the same batches, the same noise, the same math
    device_data: bool = False


class _Logger:
    """Reference-format batch and epoch logs."""

    def __init__(self, model_dir, append: bool = False):
        self.dir = pathlib.Path(model_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        if not append:
            (self.dir / "output_batch.log").write_text("")
            (self.dir / "output_epoch.log").write_text("")

    def batch(self, msg):
        with open(self.dir / "output_batch.log", "a") as f:
            print(msg, file=f)

    def epoch(self, msg):
        print(msg)
        with open(self.dir / "output_epoch.log", "a") as f:
            print(msg, file=f)


def _resume_checkpoint(model_dir, prefix: str, start_epoch: int):
    """Path of the epoch-(start_epoch - 1) checkpoint, or None when
    ``start_epoch <= 1``. Raises when it is missing: silently restarting
    from scratch would discard the requested resume."""
    if start_epoch <= 1:
        return None
    # several files for one epoch (a crashed resume re-ran it): the newest
    hits = sorted(ckpt.checkpoints(model_dir, f"{prefix}_epoch_{start_epoch - 1:03d}_vloss_*.pt"),
                  key=lambda q: q.stat().st_mtime)
    if not hits:
        raise FileNotFoundError(
            f"start_epoch={start_epoch} but no epoch-{start_epoch - 1} checkpoint "
            f"under {model_dir}")
    return hits[-1]


def _fmt(metrics: dict) -> str:
    return "    ".join(f"{k}: {float(v):.3f}" for k, v in metrics.items())


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The sample-noise generator of one epoch, a pure function of
    ``(seed, epoch)`` (the tag keeps it apart from the init generator)."""
    state = np.random.SeedSequence([seed, 0x10F, epoch]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _host_rows(ds, device, labels: bool = False):
    """Batches copied from the host dataset, as (x (B, F), y (B, Yd) or
    None) tensors on ``device``."""
    def batches(batch_size, rng=None, drop_last=False):
        for x, y in ds.batches(batch_size, rng, drop_last):
            yield (torch.from_numpy(x).to(device),
                   torch.from_numpy(y).to(device) if labels else None)
    return batches


def _device_rows(ds, device, labels: bool = False):
    """The same batches gathered from one upload of the split, labels by the
    same index batches. The epoch's row order goes up once, so a step waits
    on no copy from the host."""
    x_all, y_all = ds.arrays
    x_all = torch.from_numpy(x_all).to(device)
    y_all = torch.from_numpy(y_all).to(device) if labels else None

    def batches(batch_size, rng=None, drop_last=False):
        sels = list(index_batches(len(ds), batch_size, rng, drop_last))
        if not sels:
            return
        order = torch.from_numpy(np.concatenate(sels)).to(device)
        start = 0
        for sel in sels:
            idx = order[start:start + len(sel)]
            yield x_all.index_select(0, idx), None if y_all is None else y_all.index_select(0, idx)
            start += len(sel)
    return batches


def _state_cpu(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix: str,
                cfg: LoopConfig, device, labels: bool, vloss_key: str):
    """The epoch loop of every fitter: the resume of ``cfg.start_epoch``,
    batches (with their labels when ``labels``) from the host or from
    device-resident splits, logging, per-epoch checkpoints (``opt``, one
    optimizer or a dict of them, goes into the ``.opt.pt``) and best-weights
    tracking by the validation metric ``vloss_key``. ``step`` / ``evaluate``
    take ``(x, y, generator=)``. Returns (best state_dict on the CPU,
    history)."""
    resume = _resume_checkpoint(model_dir, prefix, cfg.start_epoch)
    if resume is not None:
        ckpt.load_checkpoint(resume, model, opt)
        print(f"resumed from {resume}")
    rows = _device_rows if cfg.device_data else _host_rows
    train_rows, valid_rows = rows(train_ds, device, labels), rows(valid_ds, device, labels)
    log = _Logger(model_dir, append=resume is not None)
    history = []
    best = (np.inf, None)
    n_train = max(1, -(-len(train_ds) // cfg.batch_size))
    n_valid = max(1, -(-len(valid_ds) // cfg.batch_size))

    for epoch in range(cfg.start_epoch, cfg.end_epoch):
        rng = np.random.default_rng((cfg.seed, epoch))
        gen = epoch_generator(cfg.seed, epoch, device)
        t0 = time.perf_counter()
        totals, i = {}, 0
        for x, y in train_rows(cfg.batch_size, rng, cfg.drop_last):
            metrics = step(x, y, generator=gen)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            if i % cfg.log_interval == 0:
                log.batch(f"Train Epoch: {epoch:2d} [{i}/{n_train}]    {_fmt(metrics)}")
            i += 1
        # divide by the steps run: with drop_last the trailing batch never runs
        train_avg = {k: float(v) / max(i, 1) for k, v in totals.items()}

        totals = {}
        for x, y in valid_rows(cfg.batch_size):
            for k, v in evaluate(x, y, generator=gen).items():
                totals[k] = totals.get(k, 0.0) + v.double()
        valid_avg = {k: float(v) / n_valid for k, v in totals.items()}

        dt = time.perf_counter() - t0
        log.epoch(f"Epoch: {epoch} ({dt:.1f}s)")
        log.epoch(f"[Train]\t\t {_fmt(train_avg)}")
        log.epoch(f"[Validation]\t {_fmt(valid_avg)}")

        vloss = valid_avg[vloss_key]
        name = ckpt.checkpoint_name(prefix, epoch, vloss)
        ckpt.save_checkpoint(model_dir, name, model, opt,
                             metadata={"epoch": epoch, **valid_avg})
        history.append({"epoch": epoch, "train": train_avg, "valid": valid_avg})
        if vloss < best[0]:
            best = (vloss, _state_cpu(model))

    return (_state_cpu(model) if best[1] is None else best[1]), history


def _prepare(model, cfg: LoopConfig, mesh, init_state_dict, device) -> torch.device:
    """Refuse what is not ported, then start ``model``'s weights on the
    resolved device: Xavier-normal from a generator seeded by ``cfg.seed``,
    or ``init_state_dict``."""
    if cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 is not ported yet: a CUDA graph over K steps "
            "is its analogue (ROADMAP A12.5)")
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported yet (ROADMAP A14)")
    dev = resolve_device(device)
    model.to("cpu")
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    else:
        init_xavier_(model, torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    return dev


def _need_labels(ds, who: str) -> None:
    if ds.arrays[1] is None:
        raise ValueError(f"{who} needs a dataset with labels y")


def fit_vae(model, train_ds, valid_ds, model_dir, prefix: str, conditional: bool = False,
            cfg: LoopConfig = LoopConfig(), mesh=None, init_state_dict=None, device=None):
    """Train M1, or with ``conditional=True`` an M2 (``CVAE``, ``CVAE_v2``,
    ``CVAE_v3``) on the datasets' labels, on ``device`` (CUDA unless
    ``device="cpu"``). Returns (best state_dict, history).

    The weights start Xavier-normal from a generator seeded by ``cfg.seed``,
    or from ``init_state_dict``; ``start_epoch > 1`` then resumes weights and
    Adam state from the previous epoch's checkpoint in ``model_dir``.
    ``cfg.std_norm`` normalizes the encoder input by ``train_ds.mean_std``.
    Checkpoints are named by the validation ELBO.
    """
    if conditional:
        _need_labels(train_ds, "fit_vae(conditional=True)")
    dev = _prepare(model, cfg, mesh, init_state_dict, device)
    norm = train_ds.mean_std if cfg.std_norm else None
    opt = adam(model.parameters(), cfg.learning_rate)
    step = make_train_step(model, opt, conditional, cfg.eps, norm)
    evaluate = make_eval_step(model, conditional, cfg.eps, norm)
    return _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix,
                       cfg, dev, conditional, "elbo")


def fit_semisup(model, train_ds, valid_ds, model_dir, prefix: str, objective: str,
                alpha: float, y_cond: str = "soft", cfg: LoopConfig = LoopConfig(),
                mesh=None, init_state_dict=None, device=None):
    """Train a ``CVAE_v3`` on the semi-supervised objective (see
    ``steps.make_semisup_step``), the trainer behind the reference's
    ``ntcd_M2v3_VAD_{U,L}loss_alpha_*`` checkpoints. Checkpoints are named
    by the validation loss (objective - alpha * BCE). Returns (best
    state_dict, history)."""
    if cfg.std_norm:
        # the semisup step has no norm path (every such reference checkpoint
        # is 'nonorm'): refuse rather than train on unnormalized inputs
        raise ValueError("fit_semisup does not support std_norm")
    _need_labels(train_ds, "fit_semisup")
    dev = _prepare(model, cfg, mesh, init_state_dict, device)
    opt = adam(model.parameters(), cfg.learning_rate)
    step = make_semisup_step(model, opt, objective, alpha, y_cond, cfg.eps)
    evaluate = make_semisup_eval_step(model, objective, alpha, y_cond, cfg.eps)
    return _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix,
                       cfg, dev, True, "loss")


def fit_adversarial(model, train_ds, valid_ds, model_dir, prefix: str, alpha: float,
                    beta: float, gamma: float, cfg: LoopConfig = LoopConfig(), mesh=None,
                    init_state_dict=None, legacy_aux_coupling: bool = False,
                    use_y_hat_soft: bool = False, freeze_classifier: bool = False,
                    y_cond: str | None = None, enc_adversary: str = "bce", device=None):
    """Train M2-info (``DisentangledVAE``) or a ``CVAE_v4`` by the
    two-optimizer adversarial game (see ``steps.make_adversarial_step``):
    two Adams, the encoder group's and the auxiliary's, both in each
    epoch's ``.opt.pt`` and both restored on resume. ``init_state_dict``
    starts from given weights (a pretrained classifier, say).
    ``freeze_classifier`` keeps the x -> y classifier fixed. ``cfg.std_norm``
    normalizes every model input. Checkpoints are named by the validation
    encoder loss (training_M2_info_vad.py:280-281). Returns (best
    state_dict, history)."""
    _need_labels(train_ds, "fit_adversarial")
    dev = _prepare(model, cfg, mesh, init_state_dict, device)
    opt_enc, opt_aux = init_adversarial_state(model, cfg.learning_rate)
    norm = train_ds.mean_std if cfg.std_norm else None
    kw = dict(use_y_hat_soft=use_y_hat_soft, y_cond=y_cond, norm=norm,
              enc_adversary=enc_adversary)
    step = make_adversarial_step(
        model, opt_enc, opt_aux, alpha, beta, gamma, cfg.eps,
        legacy_aux_coupling=legacy_aux_coupling,
        freeze_substring="classifier" if freeze_classifier else None, **kw)
    evaluate = make_adversarial_eval_step(model, alpha, beta, gamma, cfg.eps, **kw)
    return _run_epochs(model, {"enc": opt_enc, "aux": opt_aux}, step, evaluate, train_ds,
                       valid_ds, model_dir, prefix, cfg, dev, True, "enc")
