"""Data parallelism over GPUs (port of ``dvae_tpu.parallel``): the 1-D
:class:`Mesh`, one process per GPU under ``torchrun`` joined by a
``torch.distributed`` group, batches sharded by rows."""

from dvae_tpu_torch.parallel.distributed import (
    distribute_batch,
    distributed_init,
    gather_metrics,
    global_batch_from_local,
)
from dvae_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = [
    "Mesh",
    "distribute_batch",
    "distributed_init",
    "gather_metrics",
    "global_batch_from_local",
    "make_mesh",
    "replicate",
    "shard_batch",
]
