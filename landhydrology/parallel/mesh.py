"""Device meshes and column shardings.

The equivalent of a distributed communication backend
(SURVEY.md §2 row 15): columns — the trailing batch dims of ``(nz, *batch)``
fields — are sharded over a :class:`jax.sharding.Mesh`; XLA inserts the
collectives.  The vertical (stencil) axis is never sharded: it stays
on-chip (SURVEY.md §5 "long-context" note).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = Any


def near_square_factors(n: int) -> Tuple[int, int]:
    """Factor ``n`` into the most-square (a, b) with a * b == n, a <= b —
    the default 2-D mesh/grid factorization shared by the drivers."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def make_column_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("x", "y"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A device mesh for the column grid.

    ``shape`` defaults to a near-square factorization of the device count
    over ``axis_names``.  With one axis name the mesh is a simple ring
    (pure data parallelism over columns).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            a, b = near_square_factors(n)
            shape = (a, b) + (1,) * (len(axis_names) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def column_sharding(mesh: Mesh, batch_ndim: Optional[int] = None) -> NamedSharding:
    """Sharding for a ``(nz, *batch)`` field: vertical axis replicated,
    batch axes sharded over the mesh axes in order."""
    axes = list(mesh.axis_names)
    if batch_ndim is not None:
        axes = axes[:batch_ndim] + [None] * max(0, batch_ndim - len(axes))
    return NamedSharding(mesh, P(None, *axes))


def shard_state(state: dict, mesh: Mesh) -> dict:
    """Device-put every ``(nz, *batch)`` leaf of a state pytree with its
    batch dims sharded over the mesh (coordinate-like leaves with singleton
    batch dims are replicated)."""

    def put(x):
        if getattr(x, "ndim", 0) < 1 + len(mesh.axis_names):
            return jax.device_put(x, NamedSharding(mesh, P()))
        # replicate any batch axis too small to shard (e.g. broadcast-ready
        # coordinate arrays with singleton batch dims)
        specs = []
        for size, name in zip(x.shape[1:], mesh.axis_names):
            specs.append(name if size % mesh.shape[name] == 0 and size > 1 else None)
        return jax.device_put(x, NamedSharding(mesh, P(None, *specs)))

    return jax.tree_util.tree_map(put, state)
