"""Multi-chip / multi-host execution.

The reference is single-process, single-column (SURVEY.md §2 rows 14-15);
this subsystem is the package's replacement for an MPI/NCCL stack:

- ``mesh.py``   — device meshes and column shardings (pjit/NamedSharding)
- ``halo.py``   — explicit shard_map halo exchange via ``lax.ppermute``,
  overlapped with vertical compute
- ``stepping.py`` — sharded step/run builders and weak-scaling harness
- ``distributed.py`` — multi-host process-group initialization
"""

from landhydrology.parallel.mesh import (
    column_sharding,
    make_column_mesh,
    shard_state,
)
from landhydrology.parallel.halo import halo_exchanged_laplacian
from landhydrology.parallel.stepping import (
    make_fused_sharded_run,
    make_sharded_run,
    make_sharded_step,
)

__all__ = [
    "make_column_mesh",
    "column_sharding",
    "shard_state",
    "halo_exchanged_laplacian",
    "make_sharded_step",
    "make_sharded_run",
    "make_fused_sharded_run",
]
