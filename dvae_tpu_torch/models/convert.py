"""Flax parameter tree -> the port's ``state_dict``.

The port's own copy of the naming rule of
``dvae_tpu.train.torch_import.export_torch_state_dict``: a Flax Dense path
maps to the reference's torch name by

* ``layers_{i}`` -> ``{i}``          (ModuleList index of a hidden MLP)
* ``hidden_{i}`` -> ``hidden.{i}``   (classifier layers)

and ``kernel``/``bias`` -> transposed ``weight`` (torch stores (out, in)) /
``bias``. Takes nested dicts of numpy arrays, so no JAX is needed.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _torch_name(path) -> str:
    parts = []
    for p in path:
        if p.startswith("layers_") and p[7:].isdigit():
            parts.append(p[7:])
        elif re.fullmatch(r"hidden_\d+", p):
            parts.extend(["hidden", p.split("_")[1]])
        else:
            parts.append(p)
    return ".".join(parts)


def _walk_dense(tree, path=()):
    """Yield (path, leaf_dict) for every Dense-style {kernel, bias} leaf."""
    if isinstance(tree, dict) and "kernel" in tree:
        yield path, tree
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_dense(tree[k], path + (k,))


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) -> reference-named f32 tensors.

    Raises ValueError when the tree holds leaves that are not Dense
    kernel/bias pairs (the naming rule cannot express them)."""
    tree = params.get("params", params)
    sd = {}
    covered = 0
    for path, leaf in _walk_dense(tree):
        name = _torch_name(path)
        sd[name + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).T))
        sd[name + ".bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
        covered += len(leaf)
    total = _count_leaves(tree)
    if covered != total:
        raise ValueError(
            f"conversion covers {covered} of {total} array leaves: the tree "
            "holds non-Dense parameters the reference naming cannot express")
    return sd
