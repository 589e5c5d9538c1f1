"""Data parallelism over torch.distributed: the mesh and its collectives
(twin of unet_research_tpu/parallel/) and the local rank launcher."""

from unet_research_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    data_sharding,
    make_mesh,
    multihost_initialize,
    replicated,
    shard_ensemble_keys,
    shard_rows,
)

__all__ = ["Mesh", "Sharding", "data_sharding", "make_mesh", "multihost_initialize",
           "replicated", "shard_ensemble_keys", "shard_rows"]
