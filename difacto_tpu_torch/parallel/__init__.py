"""The (dp, fs) mesh of the port (counterpart of difacto_tpu/parallel/):
the mesh and its placements (mesh.py), the per-shard routing of the
table kernels (sharded.py), the capacity and bounded-delay reports
(capacity.py), and multi-host training under torch.distributed: the
control and data planes (multihost.py) and the heartbeat monitor
(fault.py)."""

from .mesh import (DP_AXIS, FS_AXIS, Mesh, batch_sharding, dp_size,
                   fs_shard_bounds, fs_size, make_mesh, put_dp_local,
                   put_global, replicated, state_sharding,
                   validate_fs_capacity)

__all__ = ["DP_AXIS", "FS_AXIS", "Mesh", "make_mesh", "state_sharding",
           "batch_sharding", "replicated", "put_global", "put_dp_local",
           "fs_size", "dp_size", "fs_shard_bounds", "validate_fs_capacity"]
