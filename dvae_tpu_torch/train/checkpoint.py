"""Checkpoints with the reference's naming (port of
``dvae_tpu.train.checkpoint``).

One epoch's checkpoint ``<name>`` is three files in the model directory:

* ``<name>.pt``: the model's bare ``state_dict`` in the reference's names,
  the format of reference ``training_M1.py:195``, which
  ``dvae_tpu.train.checkpoint.load_checkpoint`` reads too;
* ``<name>.opt.pt``: the optimizer's ``state_dict``, for resuming;
* ``<name>.json``: epoch and validation metrics.

``<name>`` is ``<prefix>_epoch_{e:03d}_vloss_{v:.2f}``.
"""

from __future__ import annotations

import json
import pathlib

import torch

_OPT_SUFFIX = ".opt.pt"


def checkpoint_name(prefix: str, epoch: int, vloss: float) -> str:
    return f"{prefix}_epoch_{epoch:03d}_vloss_{vloss:.2f}"


def _save(obj, path: pathlib.Path) -> None:
    # atomic: a kill mid-write must not leave a truncated file that the
    # newest-mtime resume rule would then pick
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)


def save_checkpoint(model_dir, name: str, model, optimizer=None,
                    metadata: dict | None = None) -> pathlib.Path:
    """Write ``<model_dir>/<name>.pt`` (CPU copies of the weights), and
    ``<name>.opt.pt`` / ``<name>.json`` when given. Returns the ``.pt`` path."""
    model_dir = pathlib.Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / f"{name}.pt"
    _save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    if optimizer is not None:
        _save(optimizer.state_dict(), model_dir / f"{name}{_OPT_SUFFIX}")
    if metadata is not None:
        (model_dir / f"{name}.json").write_text(json.dumps(metadata, indent=1))
    return path


def load_checkpoint(path, model, optimizer=None) -> None:
    """Load ``<name>.pt`` into ``model`` (strict) and, when ``optimizer`` is
    given, ``<name>.opt.pt`` into it (raises if that file is missing)."""
    path = pathlib.Path(path)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    if optimizer is not None:
        opt_path = path.with_name(path.name[:-len(".pt")] + _OPT_SUFFIX)
        if not opt_path.exists():
            raise FileNotFoundError(f"{path} has no optimizer state beside it ({opt_path.name})")
        # loaded on the CPU: load_state_dict moves the moments to each
        # parameter's device and keeps Adam's step counts on the CPU, as a
        # fresh optimizer has them
        optimizer.load_state_dict(torch.load(opt_path, map_location="cpu", weights_only=True))


def checkpoints(model_dir, pattern: str = "*.pt") -> list[pathlib.Path]:
    """The weight files matching ``pattern``, without the ``.opt.pt`` files
    that a ``*.pt`` glob also matches."""
    return [p for p in pathlib.Path(model_dir).glob(pattern)
            if not p.name.endswith(_OPT_SUFFIX)]


def best_checkpoint(model_dir, prefix: str | None = None) -> pathlib.Path:
    """The ``.pt`` checkpoint with the lowest vloss in its file name."""
    cands = []
    for p in checkpoints(model_dir):
        stem = p.stem
        if prefix and not stem.startswith(prefix):
            continue
        try:
            vloss = float(stem.rsplit("_vloss_", 1)[1])
        except (IndexError, ValueError):
            continue
        cands.append((vloss, p))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {model_dir}")
    return min(cands, key=lambda t: t[0])[1]
