"""Explicit halo exchange for the lateral surface coupling.

The new-architecture piece the reference has no prior art for
(SURVEY.md §5, §7 hard part 5): neighbor access for the cross-column
surface-coupling stencil on a mesh-sharded column grid, written as
``lax.ppermute`` ring exchanges inside ``shard_map``.

The 5-point Laplacian is separable, so only edge rows/columns are
exchanged (no corners).  The permutes are issued before the local interior
arithmetic so XLA's latency-hiding scheduler overlaps the ICI transfers
with the (much larger) vertical-sweep compute of the surrounding step.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

Array = Any


def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]  # receive from the left
    bwd = [(i, (i - 1) % n) for i in range(n)]  # receive from the right
    return fwd, bwd


def _exchange_axis(f_local: Array, axis_name: str, n_shards: int, axis: int):
    """Return (halo_lo, halo_hi): the neighboring shards' edge slabs along
    ``axis`` (periodic ring).  Single-shard axes wrap locally."""
    lo_slice = [slice(None)] * f_local.ndim
    hi_slice = [slice(None)] * f_local.ndim
    lo_slice[axis] = slice(0, 1)
    hi_slice[axis] = slice(f_local.shape[axis] - 1, f_local.shape[axis])
    first = f_local[tuple(lo_slice)]
    last = f_local[tuple(hi_slice)]
    if n_shards == 1:
        return last, first  # periodic wrap within the single shard
    fwd, bwd = _ring_perms(n_shards)
    # halo_lo = previous shard's last slab; halo_hi = next shard's first slab
    halo_lo = lax.ppermute(last, axis_name, fwd)
    halo_hi = lax.ppermute(first, axis_name, bwd)
    return halo_lo, halo_hi


def _local_laplacian(f_local: Array, dx, mesh_shape: dict, axis_names) -> Array:
    """Per-shard periodic 5-point Laplacian with halo exchange on the two
    leading axes."""
    ax_x, ax_y = axis_names
    lo_x, hi_x = _exchange_axis(f_local, ax_x, mesh_shape[ax_x], 0)
    lo_y, hi_y = _exchange_axis(f_local, ax_y, mesh_shape[ax_y], 1)
    # interior arithmetic proceeds while the permutes are in flight
    padded_x = jnp.concatenate([lo_x, f_local, hi_x], axis=0)
    padded_y = jnp.concatenate([lo_y, f_local, hi_y], axis=1)
    d2x = padded_x[:-2] + padded_x[2:] - 2.0 * f_local
    d2y = padded_y[:, :-2] + padded_y[:, 2:] - 2.0 * f_local
    return (d2x + d2y) / (dx * dx)


def _local_kinematic_tendency(
    ro, h_local: Array, mesh_shape: dict, axis_names
) -> Array:
    """Per-shard kinematic/diffusive-wave pond tendency with one-cell halo
    exchange — the sharded formulation of
    ``models/land._kinematic_wave_tendency``.

    Face fluxes are computed from the extended (halo-padded) water surface
    and pond depth; the boundary face between two shards is evaluated on
    BOTH sides from identical inputs with identical op order, so the face
    flux telescopes exactly (conservation) and an N-shard run is bitwise
    the 1-shard roll formulation (device-count invariance, tested in
    ``tests/parallel/test_sharding.py``).  ``ro.elevation`` must already be
    the shard-LOCAL slab (streamed as a sharded argument by
    ``make_fused_sharded_run``) or a scalar.
    """
    from landhydrology.models.land import _manning_face_flux

    h_eff = jnp.maximum(h_local - ro.h_detention, 0.0)
    z = jnp.broadcast_to(
        jnp.asarray(ro.elevation, dtype=h_local.dtype), h_local.shape
    )
    w = z + h_eff if ro.water_surface_slope else z
    dh = jnp.zeros_like(h_local)
    for axis, ax_name in enumerate(axis_names):
        n = h_local.shape[axis]

        def sl(a, b, axis=axis):
            return tuple(
                slice(a, b) if k == axis else slice(None)
                for k in range(h_local.ndim)
            )

        lo_w, hi_w = _exchange_axis(w, ax_name, mesh_shape[ax_name], axis)
        lo_h, hi_h = _exchange_axis(h_eff, ax_name, mesh_shape[ax_name], axis)
        w_ext = jnp.concatenate([lo_w, w, hi_w], axis=axis)
        h_ext = jnp.concatenate([lo_h, h_eff, hi_h], axis=axis)
        # faces f_j between extended cells j and j+1, j = 0..n (n+1 faces:
        # the prev-shard boundary face through the next-shard boundary face)
        s = (w_ext[sl(0, n + 1)] - w_ext[sl(1, n + 2)]) / ro.dx
        h_up = jnp.where(s > 0.0, h_ext[sl(0, n + 1)], h_ext[sl(1, n + 2)])
        q = _manning_face_flux(s, h_up, ro.manning_n)
        # local cell i: inflow face f_i, outflow face f_{i+1}
        dh = dh - (q[sl(1, n + 1)] - q[sl(0, n)]) / ro.dx
    return dh


def halo_exchanged_laplacian(f: Array, dx, mesh: Mesh) -> Array:
    """Periodic 5-point Laplacian of a ``(nx, ny)`` field sharded over the
    first two mesh axes, via explicit ring halo exchange.

    Numerically identical to the ``jnp.roll`` formulation in
    ``models/soil/rhs.lateral_surface_tendency`` (tested equal), but with
    the communication expressed as neighbor ``ppermute`` so only edge slabs
    travel over ICI instead of whole-array collective-permutes.
    """
    ax = mesh.axis_names[:2]
    fn = shard_map(
        partial(
            _local_laplacian,
            dx=dx,
            mesh_shape=dict(mesh.shape),
            axis_names=ax,
        ),
        mesh=mesh,
        in_specs=P(*ax),
        out_specs=P(*ax),
    )
    return fn(f)
