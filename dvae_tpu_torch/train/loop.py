"""Epoch-driven VAE training with reference-format logs and checkpoints
(port of ``fit_vae`` of ``dvae_tpu.train.loop``, M1 on one device).

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
from dvae_tpu_torch.train.steps import adam, make_eval_step, make_train_step


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
    # CUDA graph over K steps here, ROADMAP A12)
    steps_per_dispatch: int = 1
    # upload each split to the device once and gather each batch's rows by
    # index there, instead of copying every batch from the host: the same
    # batches, the same noise, the same math
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


def _host_rows(ds, device):
    """Batches copied from the host dataset, as (B, F) tensors on ``device``."""
    def batches(batch_size, rng=None, drop_last=False):
        for x, _ in ds.batches(batch_size, rng, drop_last):
            yield torch.from_numpy(x).to(device)
    return batches


def _device_rows(ds, device):
    """The same batches gathered from one upload of the split. The epoch's
    row order goes up once, so a step waits on no copy from the host."""
    x_all = torch.from_numpy(ds.arrays[0]).to(device)

    def batches(batch_size, rng=None, drop_last=False):
        sels = list(index_batches(len(ds), batch_size, rng, drop_last))
        if not sels:
            return
        order = torch.from_numpy(np.concatenate(sels)).to(device)
        start = 0
        for sel in sels:
            yield x_all.index_select(0, order[start:start + len(sel)])
            start += len(sel)
    return batches


def _run_epochs(model, opt, train_rows, valid_rows, n_train_rows, n_valid_rows,
                model_dir, prefix: str, cfg: LoopConfig, device, run_step, run_eval,
                resumed: bool):
    """The epoch loop: logging, per-epoch checkpoints, best-weights
    tracking. Returns (best state_dict on the CPU, history)."""
    log = _Logger(model_dir, append=resumed)
    history = []
    best = (np.inf, None)
    n_train = max(1, -(-n_train_rows // cfg.batch_size))
    n_valid = max(1, -(-n_valid_rows // cfg.batch_size))

    for epoch in range(cfg.start_epoch, cfg.end_epoch):
        rng = np.random.default_rng((cfg.seed, epoch))
        gen = epoch_generator(cfg.seed, epoch, device)
        t0 = time.perf_counter()
        totals, i = {}, 0
        for x in train_rows(cfg.batch_size, rng, cfg.drop_last):
            metrics = run_step(x, gen)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            if i % cfg.log_interval == 0:
                log.batch(f"Train Epoch: {epoch:2d} [{i}/{n_train}]    {_fmt(metrics)}")
            i += 1
        # divide by the steps run: with drop_last the trailing batch never runs
        train_avg = {k: float(v) / max(i, 1) for k, v in totals.items()}

        totals = {}
        for x in valid_rows(cfg.batch_size):
            for k, v in run_eval(x, gen).items():
                totals[k] = totals.get(k, 0.0) + v.double()
        valid_avg = {k: float(v) / n_valid for k, v in totals.items()}

        dt = time.perf_counter() - t0
        log.epoch(f"Epoch: {epoch} ({dt:.1f}s)")
        log.epoch(f"[Train]\t\t {_fmt(train_avg)}")
        log.epoch(f"[Validation]\t {_fmt(valid_avg)}")

        vloss = valid_avg["elbo"]
        name = ckpt.checkpoint_name(prefix, epoch, vloss)
        ckpt.save_checkpoint(model_dir, name, model, opt,
                             metadata={"epoch": epoch, **valid_avg})
        history.append({"epoch": epoch, "train": train_avg, "valid": valid_avg})
        if vloss < best[0]:
            best = (vloss, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()})

    if best[1] is None:
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}, history
    return best[1], history


def fit_vae(model, train_ds, valid_ds, model_dir, prefix: str, conditional: bool = False,
            cfg: LoopConfig = LoopConfig(), mesh=None, init_state_dict=None, device=None):
    """Train M1 on ``device`` (CUDA unless ``device="cpu"``). Returns
    (best state_dict, history).

    The weights start Xavier-normal from a generator seeded by ``cfg.seed``,
    or from ``init_state_dict``; ``start_epoch > 1`` then resumes weights and
    Adam state from the previous epoch's checkpoint in ``model_dir``.
    ``cfg.std_norm`` normalizes the encoder input by ``train_ds.mean_std``.
    """
    if conditional:
        raise NotImplementedError("conditional (M2) training is not ported yet (ROADMAP A9)")
    if cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 is not ported yet: a CUDA graph over K steps "
            "is its analogue (ROADMAP A12)")
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported yet (ROADMAP A14)")
    dev = resolve_device(device)
    model.to("cpu")
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    else:
        init_xavier_(model, torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    norm = train_ds.mean_std if cfg.std_norm else None
    opt = adam(model.parameters(), cfg.learning_rate)

    resume = _resume_checkpoint(model_dir, prefix, cfg.start_epoch)
    if resume is not None:
        ckpt.load_checkpoint(resume, model, opt)
        print(f"resumed from {resume}")

    step = make_train_step(model, opt, conditional, cfg.eps, norm)
    evaluate = make_eval_step(model, conditional, cfg.eps, norm)
    rows = _device_rows if cfg.device_data else _host_rows
    return _run_epochs(
        model, opt, rows(train_ds, dev), rows(valid_ds, dev), len(train_ds), len(valid_ds),
        model_dir, prefix, cfg, dev,
        run_step=lambda x, g: step(x, generator=g),
        run_eval=lambda x, g: evaluate(x, generator=g),
        resumed=resume is not None)
