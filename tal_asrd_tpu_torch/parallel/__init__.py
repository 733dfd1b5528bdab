"""Data and tensor parallelism on torch.distributed: the process mesh and
its sharding plan (mesh.py), the tensor-parallel layers (tensor.py), and a
launcher of process groups for tests and probes (launch.py).
`init_distributed` joins the process group (torchrun's, or the caller's)."""
from tal_asrd_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    init_distributed,
    replicated_sharding,
    param_shardings,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "param_shardings",
    "shard_batch",
]
