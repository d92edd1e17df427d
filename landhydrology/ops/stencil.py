"""Vertical finite-difference stencil operators, batched.

Reference semantics (ClimaCore operators as composed at
``/root/reference/src/SoilModel/right_hand_side.jl:170-181``, verified
against the hand-rolled finite-volume oracle at
``test/SoilModel/coupled.jl:230-234``):

- ``InterpolateC2F``: face value = arithmetic mean of adjacent centers on
  interior faces; boundary faces are never consumed because ``DivergenceF2C``
  overwrites them via ``SetValue``.
- ``GradientC2F``: face gradient = (c[i] - c[i-1]) / dz on interior faces.
- ``DivergenceF2C(top=SetValue(F_top), bottom=SetValue(F_bot))``:
  center divergence = (F[i+1] - F[i]) / dz with the two boundary faces
  replaced by the BC flux values.

Sign convention: flux positive along +z (``boundary_conditions.jl:36-38``).

Layout: the vertical axis is axis 0 of ``(nz, *batch)`` arrays; all ops are
pure slicing + arithmetic, which XLA fuses into the surrounding pointwise
sweep.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

Array = Any


def interp_c2f_interior(xc: Array) -> Array:
    """Center->face arithmetic-mean interpolation on interior faces.

    ``(nz, *batch) -> (nz-1, *batch)``; face j (between centers j-1 and j)
    gets ``(x[j-1] + x[j]) / 2``.
    """
    return 0.5 * (xc[:-1] + xc[1:])


def grad_c2f_interior(xc: Array, dz: Array) -> Array:
    """Center->face one-sided gradient on interior faces.

    ``(nz, *batch) -> (nz-1, *batch)``; face j gets ``(x[j] - x[j-1]) / dz``.
    """
    return (xc[1:] - xc[:-1]) / dz


def _boundary_slab(value: Array, like_interior: Array) -> Array:
    """Broadcast a boundary flux value to one face-slab ``(1, *batch)``."""
    batch_shape = like_interior.shape[1:]
    value = jnp.asarray(value, dtype=like_interior.dtype)
    return jnp.broadcast_to(value, batch_shape)[None]


def div_f2c(flux_interior: Array, flux_bottom: Array, flux_top: Array, dz: Array) -> Array:
    """Face->center divergence with SetValue boundary fluxes.

    ``flux_interior`` has shape ``(nz-1, *batch)`` (interior faces 1..nz-1);
    ``flux_bottom``/``flux_top`` are scalars or ``(*batch)`` arrays that
    overwrite faces 0 and nz.  Returns ``(nz, *batch)``:
    ``div[i] = (F[i+1] - F[i]) / dz``.
    """
    fb = _boundary_slab(flux_bottom, flux_interior)
    ft = _boundary_slab(flux_top, flux_interior)
    flux = jnp.concatenate([fb, flux_interior, ft], axis=0)  # (nz+1, *batch)
    return (flux[1:] - flux[:-1]) / dz


def diffusive_flux_faces(coeff_c: Array, field_c: Array, dz: Array) -> Array:
    """Interior-face diffusive flux ``-interp(K) * grad(u)``.

    The composition ``-interpc2f(K) * gradc2f(u)`` from
    ``right_hand_side.jl:181`` on interior faces: ``(nz, *batch) ->
    (nz-1, *batch)``.
    """
    return -interp_c2f_interior(coeff_c) * grad_c2f_interior(field_c, dz)
