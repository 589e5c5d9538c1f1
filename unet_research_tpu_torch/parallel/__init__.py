"""Data parallelism over torch.distributed: the mesh and its collectives
(twin of unet_research_tpu/parallel/) and the local rank launcher."""

from unet_research_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    multihost_initialize,
    shard_rows,
)

__all__ = ["Mesh", "make_mesh", "multihost_initialize", "shard_rows"]
