"""The 1-D data mesh and its sharding helpers (port of
``dvae_tpu.parallel.mesh``).

JAX runs one SPMD program over a ``jax.sharding.Mesh``; the torch idiom is
one process per GPU under ``torchrun`` and a ``torch.distributed`` process
group. :class:`Mesh` holds both views of the same ``data`` axis: the
devices this process drives (one per process under a group; several, or
one named several times, in a single process) and the group, so that
``size``, the global number of shards, is the world size times the
process's devices.

* training (``train/loop.py``, ``train/sequence.py``): each process runs
  its contiguous rows of the global batch and the gradients are
  all-reduced over the group;
* enhancement (``enhance/pipeline.py``): one process splits the padded
  utterance batch into ``size`` contiguous shards and dispatches one per
  device; CUDA launches are asynchronous, so the devices overlap.

The models are ~0.2 M parameters, so the mesh is 1-D, as JAX's is.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

from dvae_tpu_torch.device import resolve_device


class Mesh:
    """A 1-D data mesh: ``devices`` (this process's shards, in order; an
    entry may repeat, which puts two shards on one device), ``group`` (the
    process group, or None in a single process), ``rank`` (this process's
    rank in it, 0 without one) and ``size`` (the global number of shards,
    the world size times ``len(devices)``). Shard ``i`` of a batch holds
    its ``i``-th contiguous block of rows; this process holds shards
    ``rank * len(devices)`` to ``(rank + 1) * len(devices) - 1``."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.size = self.world * len(self.devices)

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"Mesh([{devs}], rank={self.rank}, size={self.size})"

    @property
    def device(self) -> torch.device:
        """The one device of this process's shards. Training runs one
        process per GPU: a process whose shards lie on two devices
        raises."""
        if len(set(self.devices)) != 1:
            raise ValueError(
                f"{self!r}: a trainer runs this process's shards on one device; launch "
                "one process per GPU with torchrun --nproc-per-node=<GPUs>")
        return self.devices[0]


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over every device, as JAX's ``make_mesh`` builds it.

    * Under a joined process group (:func:`~dvae_tpu_torch.parallel.
      distributed_init`): the world, this process on ``cuda:LOCAL_RANK``
      (the CPU on ``device="cpu"``); ``n_devices``, when given, must be the
      world size.
    * ``device="cpu"``: ``n_devices`` CPU shards (1 by default), the
      counterpart of ``--xla_force_host_platform_device_count``.
    * Otherwise every visible CUDA device, or the first ``n_devices`` of
      them; too few raise ValueError, none raises as ``resolve_device``
      does.
    """
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"requested a {n_devices}-device mesh under a process group of "
                             f"{world}: one device per process")
        local = torch.device("cuda", _local_rank()) if dev.type == "cuda" else dev
        return Mesh([local], group=dist.group.WORLD)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices))
    count = torch.cuda.device_count()
    if n_devices is not None and count < n_devices:
        raise ValueError(f"requested a {n_devices}-device mesh but only {count} devices "
                         "exist (a CPU mesh of any size: make_mesh(n, device='cpu'))")
    return Mesh([torch.device("cuda", i) for i in range(count if n_devices is None
                                                           else n_devices)])


def _map(fn, tree):
    """``fn`` over the tensor or array leaves of a tuple / list / dict tree;
    None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def split_rows(x, parts: int, batch_dim: int = 0) -> list:
    """``parts`` contiguous equal blocks of ``x`` along ``batch_dim``; a
    dimension that does not divide raises."""
    n = x.shape[batch_dim]
    if n % parts:
        raise ValueError(f"batch dim {n} not divisible by {parts} shards")
    return list(torch.split(_tensor(x), n // parts, dim=batch_dim))


def shard_batch(batch, mesh: Mesh, batch_dim: int = 0):
    """This process's shards of a global batch: every leaf split into
    ``mesh.size`` contiguous blocks along ``batch_dim``, the blocks of this
    process's devices each moved to its device (a list per leaf)."""
    per = len(mesh.devices)

    def leaf(x):
        blocks = split_rows(x, mesh.size, batch_dim)[mesh.rank * per:(mesh.rank + 1) * per]
        return [b.to(d) for b, d in zip(blocks, mesh.devices)]

    return _map(leaf, batch)


def replicate(module, mesh: Mesh):
    """Make every process's copy of ``module`` equal to rank 0's: its
    parameters and buffers broadcast over the group, in place (a no-op
    without one). Returns ``module``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group)
    return module
