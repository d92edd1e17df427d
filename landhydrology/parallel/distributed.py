"""Multi-host process-group initialization.

The replacement for an MPI launcher (SURVEY.md §2 row 15): each
host process calls :func:`initialize` (a thin, idempotent wrapper over
``jax.distributed.initialize``), after which ``jax.devices()`` spans the
whole cluster and every mesh/sharding utility in ``parallel/`` works
unchanged — pjit/shard_map collectives run over the devices' interconnect
(NCCL on GPUs) with no user-visible transport code.

Typical entry (one process per host):

    from landhydrology.parallel import distributed
    distributed.initialize(coordinator_address="host0:<port>",
                           num_processes=N, process_id=i)
    mesh = make_column_mesh()         # global devices
    ...

CPU multi-process testing (no accelerator needed):

    distributed.initialize(coordinator_address="127.0.0.1:<port>",
                           num_processes=N, process_id=i)
"""

from __future__ import annotations

from typing import Optional

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join (or create) the distributed process group.  Idempotent; with no
    arguments the coordinator is autodetected from the environment where a
    cluster manager provides one, exactly as
    ``jax.distributed.initialize`` documents."""
    global _initialized
    if _initialized:
        return
    # NB: must not touch any backend-initializing API (jax.devices,
    # jax.process_count, ...) before jax.distributed.initialize.
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_coordinator() -> bool:
    """True on process 0 (where single-writer side effects should run)."""
    return jax.process_index() == 0


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
