"""The multi-process runtime (port of ``dvae_tpu.parallel.distributed``).

JAX joins its processes with ``jax.distributed.initialize()``; here each
process is one GPU under ``torchrun``, which exports ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
:func:`distributed_init` joins the ``torch.distributed`` process group
from them (``env://``): NCCL on the card, ``gloo`` on the CPU.

* every process feeds only its own contiguous rows of each training batch
  (:func:`distribute_batch` / :func:`global_batch_from_local`);
* small result and metric trees come back to every process with
  :func:`gather_metrics`;
* checkpoints and logs are written by rank 0 only (``train/loop.py``,
  ``train/sequence.py``).

``--data-parallel`` / ``--multihost`` in the training CLIs wire this in.
The enhancement sweeps stay per-process, as the JAX package's do: their
outputs are per-utterance wav files and the sweep resumes by skipping
what exists, so several processes (or hosts) run the CLI on disjoint
``--shard`` / ``--snr`` slices with nothing to coordinate.
"""

from __future__ import annotations

import atexit
import os

import numpy as np
import torch
import torch.distributed as dist

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.parallel.mesh import Mesh, _map, _tensor, split_rows

#: torchrun's variables; any one present means a launcher asked for a group
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def distributed_init(device=None) -> bool:
    """Join the process group that ``torchrun`` describes (idempotent).

    Where none of :data:`TORCHRUN_ENV` is set, stays a single process and
    returns False. Where they are, joins the group by ``env://``: NCCL
    for CUDA (after ``torch.cuda.set_device(LOCAL_RANK)``), ``gloo`` for
    ``device="cpu"``; a partial environment (``MASTER_ADDR`` missing, say)
    or a failing join raises, since a requested multi-process run that
    quietly ran alone would train an independent copy per process. The
    group is left at exit. Returns whether the group has more than one
    process.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if not any(k in os.environ for k in TORCHRUN_ENV):
        return False
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"a torchrun environment without {', '.join(missing)}: "
                           "launch with torchrun, or set all of " + ", ".join(TORCHRUN_ENV))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    atexit.register(_leave)  # as jax.distributed shuts down at exit
    return dist.get_world_size() > 1


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_rows(x, mesh: Mesh, batch_dim: int):
    """This process's contiguous block of a global batch along
    ``batch_dim``; a dimension that does not divide the world raises."""
    n = _tensor(x).shape[batch_dim]
    if n % mesh.world:
        raise ValueError(f"batch dim {n} not divisible by process_count={mesh.world}")
    return split_rows(x, mesh.world, batch_dim)[mesh.rank]


def global_batch_from_local(local_batch, mesh: Mesh, batch_dim: int = 0):
    """This process's part of a global batch from its own rows: every leaf
    (``global_batch / world`` rows along ``batch_dim``) split over this
    process's devices, a list of per-device blocks per leaf. No data moves
    between processes. In a single process this is ``shard_batch``."""
    def leaf(x):
        blocks = split_rows(x, len(mesh.devices), batch_dim)
        return [b.to(d) for b, d in zip(blocks, mesh.devices)]

    return _map(leaf, local_batch)


def distribute_batch(batch, mesh: Mesh, batch_dim: int = 0):
    """Shard a batch that every process holds whole (the datasets read a
    shared filesystem): each process keeps its contiguous ``rank`` block of
    rows and splits it over its devices, as :func:`global_batch_from_local`
    does. ``batch_dim`` is 0 for ``(B, ...)`` batches, 1 for the multi-step
    ``(K, B, ...)`` stacks. The dimension must divide the process count (the
    training loop wrap-pads to the mesh size, a multiple of it)."""
    return global_batch_from_local(_map(lambda x: _local_rows(x, mesh, batch_dim), batch),
                                   mesh, batch_dim)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gather_metrics(tree):
    """Every process's small result tree, stacked on a leading process axis
    in rank order (numpy leaves), on every process; in a single process a
    length-1 axis. For metric tables and costs, not bulk tensors."""
    local = _map(_numpy, tree)
    if not (dist.is_available() and dist.is_initialized()):
        return _map(lambda a: a[None], local)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, local)
    return _zip_map(lambda *leaves: np.stack(leaves), parts)


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_map(fn, list(xs)) for xs in zip(*trees))
    return fn(*trees)


def grad_allreduce(mesh: Mesh | None, mean: bool = True):
    """``hook(optimizer)``, run between backward and ``step()``: the
    gradients of the optimizer's parameters all-reduced over the mesh's
    group as one flat buffer, summed and, with ``mean``, divided by the
    world size (the shards are equal, so this is the global batch's
    mean). None without a group."""
    if mesh is None or mesh.group is None:
        return None

    def hook(opt) -> None:
        grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        if mean:
            flat.div_(mesh.world)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    return hook


def allreduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t`` summed over the mesh's group, in place (as is without one)."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t
