"""Flax parameter tree -> the port's ``state_dict``.

The port's own copy of the naming rule of
``dvae_tpu.train.torch_import.export_torch_state_dict``: a Flax Dense path
maps to the reference's torch name by

* ``layers_{i}`` -> ``{i}``          (ModuleList index of a hidden MLP)
* ``hidden_{i}`` -> ``hidden.{i}``   (classifier layers)
* ``bn_{i}`` -> ``bn.{i}``           (a classifier's BatchNorm layers)

and ``kernel``/``bias`` -> transposed ``weight`` (torch stores (out, in)) /
``bias``; a BatchNorm's ``scale``/``bias`` params -> ``weight``/``bias`` and
its ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.
Takes nested dicts of numpy arrays, so no JAX is needed.
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
        elif re.fullmatch(r"(hidden|bn)_\d+", p):
            parts.extend(p.split("_"))
        else:
            parts.append(p)
    return ".".join(parts)


def _walk(tree, keys, path=()):
    """Yield (path, leaf_dict) for every dict holding all of ``keys``
    (a Dense's {kernel, bias}, a BatchNorm's {scale, bias} or {mean,
    var})."""
    if isinstance(tree, dict) and all(k in tree for k in keys):
        yield path, tree
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], keys, path + (k,))


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Flax variables (nested dicts of arrays: ``params`` and, for a
    BatchNorm classifier, ``batch_stats``; or the params tree alone) ->
    reference-named f32 tensors.

    Raises ValueError when the trees hold leaves that are not Dense
    kernel/bias pairs, BatchNorm scale/bias pairs or BatchNorm statistics
    (the naming rule cannot express them)."""
    tree = params.get("params", params)
    stats = params.get("batch_stats", {}) if "params" in params else {}
    sd = {}
    covered = 0
    for path, leaf in _walk(tree, ("kernel", "bias")):
        name = _torch_name(path)
        sd[name + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).T))
        sd[name + ".bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
        covered += len(leaf)
    for src, keys, names in ((tree, ("scale", "bias"), ("weight", "bias")),
                             (stats, ("mean", "var"), ("running_mean", "running_var"))):
        for path, leaf in _walk(src, keys):
            name = _torch_name(path)
            for key, suffix in zip(keys, names):
                sd[f"{name}.{suffix}"] = torch.from_numpy(np.array(leaf[key], np.float32))
            covered += len(leaf)
    total = _count_leaves(tree) + _count_leaves(stats)
    if covered != total:
        raise ValueError(
            f"conversion covers {covered} of {total} array leaves: the tree "
            "holds non-Dense, non-BatchNorm parameters the reference naming cannot "
            "express")
    return sd


_GATES = ("i", "f", "g", "o")  # torch's order of the LSTM gate blocks


def _arr(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _lstm_head(tree) -> tuple[dict, int]:
    """The ``lstm_{i}`` layers and the ``head`` of a Flax sequence
    classifier -> (the port's ``lstm.*`` / ``head.*`` tensors, leaves
    mapped). Layer ``i`` holds ``lstm_{i}/i{gate}/kernel`` (input, no bias)
    and ``lstm_{i}/h{gate}/{kernel,bias}`` (recurrent) for the gates i, f,
    g, o; ``weight_ih_l{i}`` / ``weight_hh_l{i}`` stack the transposed
    kernels in that order, ``bias_hh_l{i}`` the recurrent biases, and
    ``bias_ih_l{i}`` is zero."""
    sd, covered = {}, 0
    layers = sorted(int(k.split("_")[1]) for k in tree if re.fullmatch(r"lstm_\d+", k))
    if not layers or "head" not in tree:
        raise ValueError("the tree has no lstm_{i} layers or no head")
    for i in layers:
        cell = tree[f"lstm_{i}"]
        w_ih = [_arr(cell[f"i{g}"]["kernel"]).T for g in _GATES]
        w_hh = [_arr(cell[f"h{g}"]["kernel"]).T for g in _GATES]
        b_hh = [_arr(cell[f"h{g}"]["bias"]) for g in _GATES]
        sd[f"lstm.weight_ih_l{i}"] = torch.cat(w_ih).contiguous()
        sd[f"lstm.weight_hh_l{i}"] = torch.cat(w_hh).contiguous()
        sd[f"lstm.bias_ih_l{i}"] = torch.zeros(sum(b.shape[0] for b in b_hh))
        sd[f"lstm.bias_hh_l{i}"] = torch.cat(b_hh)
        covered += 12
    if layers != list(range(len(layers))):
        raise ValueError(f"LSTM layers {layers} are not numbered 0..{len(layers) - 1}")
    sd["head.weight"] = _arr(tree["head"]["kernel"]).T.contiguous()
    sd["head.bias"] = _arr(tree["head"]["bias"])
    return sd, covered + 2


def _check_covered(tree, covered: int, what: str) -> None:
    total = _count_leaves(tree)
    if covered != total:
        raise ValueError(f"conversion covers {covered} of {total} array leaves: the "
                         f"tree is not {what}")


def lstm_vad_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Flax ``LSTMVad`` params -> the port's ``LSTMVad`` state_dict (the
    gate stacking of :func:`_lstm_head`). Raises ValueError on any leaf it
    does not map."""
    tree = params.get("params", params)
    try:
        sd, covered = _lstm_head(tree)
    except ValueError as e:
        raise ValueError(f"the tree is not an LSTMVad: {e}") from None
    _check_covered(tree, covered, "an LSTMVad")
    return sd


def video_vad_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Flax ``VideoVad`` or ``AVVad`` params -> the port's state_dict of
    the same model. ``lip/conv_{i}/kernel`` (3, 3, in, out) goes to
    ``lip.convs.{i}.weight`` (out, in, 3, 3); ``lip/proj`` is transposed
    as it stands, since the port flattens the conv map in Flax's H, W, C
    order; the LSTM layers and the head as in :func:`_lstm_head`. Raises
    ValueError on any leaf it does not map."""
    tree = params.get("params", params)
    lip = tree.get("lip")
    if not isinstance(lip, dict) or "proj" not in lip:
        raise ValueError("the tree is not a VideoVad / AVVad (no lip/proj)")
    try:
        sd, covered = _lstm_head(tree)
    except ValueError as e:
        raise ValueError(f"the tree is not a VideoVad / AVVad: {e}") from None
    convs = sorted(int(k.split("_")[1]) for k in lip if re.fullmatch(r"conv_\d+", k))
    if convs != list(range(len(convs))):
        raise ValueError(f"lip convs {convs} are not numbered 0..{len(convs) - 1}")
    for i in convs:
        conv = lip[f"conv_{i}"]
        sd[f"lip.convs.{i}.weight"] = _arr(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"lip.convs.{i}.bias"] = _arr(conv["bias"])
        covered += 2
    sd["lip.proj.weight"] = _arr(lip["proj"]["kernel"]).T.contiguous()
    sd["lip.proj.bias"] = _arr(lip["proj"]["bias"])
    _check_covered(tree, covered + 2, "a VideoVad / AVVad")
    return sd
