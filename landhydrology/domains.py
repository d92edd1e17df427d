"""Domains: the 1-D vertical soil column, batched.

Re-design of ``/root/reference/src/Domains/domain.jl``.  The
reference builds ClimaCore center/face finite-difference spaces for a single
column (``domain.jl:58-69``); here a :class:`Column` is a static config and
:func:`make_function_space` returns plain coordinate arrays:

- ``nz`` cell centers at midpoints of a uniform mesh, ``nz + 1`` faces at the
  cell edges (verified layout: ``test/SoilModel/coupled.jl:198`` — centers
  -1.95:0.1:-0.05 for zlim=(-2, 0), n=20).
- Batch dims: fields carry shape ``(nz, *batch_shape)`` — the vertical axis
  leads (it is the structured/stencil axis) and columns trail (the
  contiguous, vectorized axis, sharded over the device mesh).

Coordinate arrays have shape ``(nz, *[1]*len(batch_shape))`` so they
broadcast against any batch of columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


@dataclasses.dataclass(frozen=True)
class Column:
    """A 1-D vertical column domain (cf. ``domain.jl:12-33``).

    ``zlim = (zmin, zmax)`` with ``zmin < zmax``; ``nelements`` uniform cells;
    optional trailing ``batch_shape`` of independent columns (the reference is
    always a single column — batching is the package's scale axis,
    SURVEY.md §2 row 13).
    """

    zlim: Tuple[float, float]
    nelements: int
    batch_shape: Tuple[int, ...] = ()
    boundary_tags: Tuple[str, str] = ("bottom", "top")

    def __post_init__(self):
        if not self.zlim[0] < self.zlim[1]:
            raise ValueError(f"zlim must satisfy zmin < zmax, got {self.zlim}")

    @property
    def ndims(self) -> int:
        return 1

    def __len__(self) -> int:  # reference Base.length = physical height
        return int(self.zlim[1] - self.zlim[0])

    @property
    def height(self) -> float:
        return self.zlim[1] - self.zlim[0]

    @property
    def size(self) -> float:
        return self.height

    def __repr__(self) -> str:
        return f"[{self.zlim[0]:0.1f}, {self.zlim[1]:0.1f}]"


@dataclasses.dataclass(frozen=True, eq=False)
class VariableDepthColumn:
    """A batch of 1-D columns with **per-column depths** — heterogeneous
    terrain where bedrock (or the water table of interest) sits at a
    different depth under each column (capability beyond the reference; the
    reference's ``Column`` holds a single interval, ``domain.jl:12-19``).

    Each column keeps ``nelements`` cells, so fields stay dense
    ``(nz, *batch)`` arrays — no masked levels, no padding; the cell
    spacing ``dz = (z_top - z_bottom) / nz`` simply varies per column and
    broadcasts through every stencil/BC formula (the half-cell boundary
    distance ``dz/2`` of ``boundary_conditions.jl:196-208`` becomes a
    per-column array): uniform compute, heterogeneous geometry as data.

    ``z_bottom`` / ``z_top`` are scalars or arrays broadcastable to
    ``batch_shape`` with ``z_bottom < z_top`` everywhere.
    """

    z_bottom: Any  # array-like, broadcastable to batch_shape
    nelements: int
    batch_shape: Tuple[int, ...]
    z_top: Any = 0.0
    boundary_tags: Tuple[str, str] = ("bottom", "top")

    def __post_init__(self):
        zb = np.broadcast_to(np.asarray(self.z_bottom, dtype=np.float64), self.batch_shape)
        zt = np.broadcast_to(np.asarray(self.z_top, dtype=np.float64), self.batch_shape)
        if not np.all(zb < zt):
            raise ValueError(
                "VariableDepthColumn requires z_bottom < z_top for every "
                "column"
            )

    @property
    def ndims(self) -> int:
        return 1

    @property
    def height(self) -> Any:
        """Per-column physical height (array of ``batch_shape``)."""
        return np.broadcast_to(
            np.asarray(self.z_top, dtype=np.float64)
            - np.asarray(self.z_bottom, dtype=np.float64),
            self.batch_shape,
        )

    def __repr__(self) -> str:
        h = self.height
        return (
            f"VariableDepthColumn(nz={self.nelements}, batch={self.batch_shape}, "
            f"depth [{h.min():0.2f}, {h.max():0.2f}])"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """Discretized column: coordinates + spacing, broadcast-ready.

    ``zc``/``zf`` have shape ``(nz, *ones)`` where ``ones`` is one singleton
    axis per batch dim, so ``zc + field`` broadcasts for fields of shape
    ``(nz, *batch_shape)``.

    ``dz_boundary = dz/2`` is the half-cell center-to-face distance that the
    reference reads off ``face_local_geometry.WJ`` at the domain boundaries
    (``boundary_conditions.jl:196-208``) and uses in every Dirichlet-to-flux
    conversion.
    """

    zc: Array  # (nz, *ones) cell-center z
    zf: Array  # (nz+1, *ones) face z
    dz: Array  # scalar cell spacing
    nz: int = dataclasses.field(metadata=dict(static=True))
    batch_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def dz_boundary(self) -> Array:
        """Half-cell distance from the last center to the boundary face."""
        return self.dz / 2.0

    @property
    def shape(self) -> Tuple[int, ...]:
        """Shape of a center field on this grid."""
        return (self.nz, *self.batch_shape)


def make_function_space(domain, dtype=jnp.float64) -> ColumnGrid:
    """Build the (center, face) coordinate grid for a column
    (cf. ``domain.jl:58-69``).

    Uses float64 numpy for the mesh arithmetic then casts, so Float32 grids
    still place centers at exact midpoints.  Dispatches on the domain type:
    a :class:`Column` yields broadcast-singleton coordinates and a scalar
    ``dz``; a :class:`VariableDepthColumn` yields full per-column coordinate
    arrays and a ``(*batch)``-shaped ``dz``.
    """
    dtype = jnp.dtype(dtype) if jnp.issubdtype(jnp.dtype(dtype), jnp.floating) else jnp.dtype(
        jnp.float32
    )

    def conv(x):
        return jnp.asarray(x, dtype=dtype)

    if isinstance(domain, VariableDepthColumn):
        nz = int(domain.nelements)
        batch = tuple(domain.batch_shape)
        zb = np.broadcast_to(np.asarray(domain.z_bottom, dtype=np.float64), batch)
        zt = np.broadcast_to(np.asarray(domain.z_top, dtype=np.float64), batch)
        dz = (zt - zb) / nz  # (*batch)
        k = np.arange(nz + 1, dtype=np.float64).reshape((nz + 1,) + (1,) * len(batch))
        zf = zb[None] + k * dz[None]  # (nz+1, *batch)
        zc = 0.5 * (zf[:-1] + zf[1:])  # (nz, *batch)
        return ColumnGrid(
            zc=conv(zc),
            zf=conv(zf),
            dz=conv(dz),
            nz=nz,
            batch_shape=batch,
        )
    zmin, zmax = float(domain.zlim[0]), float(domain.zlim[1])
    nz = int(domain.nelements)
    dz = (zmax - zmin) / nz
    zf = zmin + dz * np.arange(nz + 1, dtype=np.float64)
    zc = 0.5 * (zf[:-1] + zf[1:])
    ones = (1,) * len(domain.batch_shape)
    return ColumnGrid(
        zc=conv(zc).reshape((nz, *ones)),
        zf=conv(zf).reshape((nz + 1, *ones)),
        dz=conv(dz),
        nz=nz,
        batch_shape=tuple(domain.batch_shape),
    )


def coordinates(grid: ColumnGrid) -> Array:
    """Center z coordinates (cf. ``right_hand_side.jl:7-8``)."""
    return grid.zc


def zero_field(grid: ColumnGrid, dtype=None) -> Array:
    """A zero center field on the grid, including batch dims
    (cf. ``right_hand_side.jl:16-17``)."""
    return jnp.zeros(grid.shape, dtype=dtype if dtype is not None else grid.zc.dtype)
