"""Checkpoints with the reference's naming (port of
``dvae_tpu.train.checkpoint``).

One epoch's checkpoint ``<name>`` is three files in the model directory:

* ``<name>.pt``: the model's bare ``state_dict`` in the reference's names,
  the format of reference ``training_M1.py:195``, which
  ``dvae_tpu.train.checkpoint.load_checkpoint`` reads too;
* ``<name>.opt.pt``: the optimizer's ``state_dict``, for resuming; for the
  adversarial trainers' two optimizers one file holds both, as
  ``{"enc": ..., "aux": ...}``;
* ``<name>.json``: epoch and validation metrics.

``<name>`` is ``<prefix>_epoch_{e:03d}_vloss_{v:.2f}``.
:func:`partial_load` and :func:`extract_submodule` move a part of a
checkpoint between models by torch's dotted names
(training_M2_info_vad_pretrain.py:103-113, evaluate_ntcd_M2_info_vad.py:
322-324).
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


def _opt_state(optimizer):
    if isinstance(optimizer, dict):
        return {k: o.state_dict() for k, o in optimizer.items()}
    return optimizer.state_dict()


def save_checkpoint(model_dir, name: str, model, optimizer=None,
                    metadata: dict | None = None) -> pathlib.Path:
    """Write ``<model_dir>/<name>.pt`` (CPU copies of the weights), and
    ``<name>.opt.pt`` / ``<name>.json`` when given. ``optimizer`` is one
    optimizer or a dict of them by name. Returns the ``.pt`` path."""
    model_dir = pathlib.Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / f"{name}.pt"
    _save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    if optimizer is not None:
        _save(_opt_state(optimizer), model_dir / f"{name}{_OPT_SUFFIX}")
    if metadata is not None:
        (model_dir / f"{name}.json").write_text(json.dumps(metadata, indent=1))
    return path


def load_checkpoint(path, model, optimizer=None) -> None:
    """Load ``<name>.pt`` into ``model`` (strict) and, when ``optimizer`` is
    given (one, or a dict of them by name as saved), ``<name>.opt.pt`` into
    it (raises if that file is missing)."""
    path = pathlib.Path(path)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    if optimizer is not None:
        opt_path = path.with_name(path.name[:-len(".pt")] + _OPT_SUFFIX)
        if not opt_path.exists():
            raise FileNotFoundError(f"{path} has no optimizer state beside it ({opt_path.name})")
        # loaded on the CPU: load_state_dict moves the moments to each
        # parameter's device and keeps Adam's step counts on the CPU, as a
        # fresh optimizer has them
        saved = torch.load(opt_path, map_location="cpu", weights_only=True)
        if isinstance(optimizer, dict):
            for k, o in optimizer.items():
                o.load_state_dict(saved[k])
        else:
            optimizer.load_state_dict(saved)


def partial_load(path, model, key_substring: str) -> list[str]:
    """Load into ``model`` only the entries of the ``.pt`` at ``path`` whose
    name contains ``key_substring`` (e.g. ``enc_dec_clf.classifier``); the
    rest of ``model`` keeps its values. The donor may differ outside the
    filter. Returns the names loaded. Raises KeyError when the filter
    matches no entry of ``model`` or the donor lacks one it matches, and
    ValueError on a shape mismatch."""
    donor = torch.load(pathlib.Path(path), map_location="cpu", weights_only=True)
    names = [k for k in model.state_dict() if key_substring in k]
    if not names:
        # a filter that matches nothing would load nothing without a word
        raise KeyError(f"filter {key_substring!r} matches no entry of the model "
                       "(wrong layout or typo?)")
    own = model.state_dict()
    for k in names:
        if k not in donor:
            raise KeyError(f"{path} has no entry {k} matching filter {key_substring!r}")
        if donor[k].shape != own[k].shape:
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{tuple(donor[k].shape)} vs model {tuple(own[k].shape)}")
    model.load_state_dict({k: donor[k] for k in names}, strict=False)
    return names


def extract_submodule(state_dict: dict, *path_keys: str) -> dict:
    """The entries under a dotted prefix, named from below it:
    ``extract_submodule(sd, "enc_dec_clf")`` is a ``CVAE_v3``'s
    ``state_dict`` taken out of a ``DisentangledVAE``'s."""
    prefix = ".".join(path_keys) + "."
    sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"no entry under {prefix[:-1]!r}")
    return sub


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
