"""Multi-step segment runner: ``steps_per_call`` steps of a column batch in
one ``lax.fori_loop``.

A segment is the unit of work of the schemes that act at segment
boundaries: the lateral Lie split of
:func:`~landhydrology.parallel.make_fused_sharded_run` and the macro-step
error control of :func:`~landhydrology.adaptive.run_adaptive_fused`.  It is
plain ``jax.numpy``/``lax``: the loop body is the same ``make_rhs`` tendency
and stepper the XLA scan drivers use, applied to the whole ``(nz, *batch)``
arrays, so XLA compiles it for whatever device runs it and ``jax.grad``
differentiates it natively.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from landhydrology.domains import ColumnGrid, make_function_space
from landhydrology.timestepping import SSPRK33, AbstractTimestepper

Array = Any

#: options of the Pallas column kernel that the plain XLA path replaced
REMOVED_OPTIONS = ("engine", "steps_per_call", "tile_cols", "interpret",
                   "differentiable")


def reject_removed_options(where: str, options: dict) -> None:
    """Raise for keyword arguments (or config keys) naming options that
    belonged to the removed Pallas column kernel; any other unexpected name
    raises the usual ``TypeError``."""
    if not options:
        return
    removed = sorted(k for k in options if k in REMOVED_OPTIONS)
    if removed:
        raise TypeError(
            f"{where}: option(s) {removed} were removed together with the "
            "Pallas column kernel; the plain XLA path is the only engine, "
            "so drop them"
        )
    raise TypeError(
        f"{where} got unexpected keyword argument(s) {sorted(options)}"
    )


def _forcing_row_index(t, t_start, inv_dt_forcing, n_rows):
    """Row of a time-indexed forcing table holding time ``t``: the
    step-start time mapped onto the grid ``t_start + i * dt_forcing`` by one
    multiply with the precomputed reciprocal, truncated and clamped to the
    table.  Shared with ``TimeForcedStepper`` so both engines of the
    adaptive-forced driver pick the same row even on a row boundary."""
    return jnp.clip(
        ((t - t_start) * inv_dt_forcing).astype(jnp.int32), 0, n_rows - 1
    )


def make_segment_run(
    model,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    steps_per_call: int = 16,
    streamed_geometry=None,
    forcing_fields=(),
    forcing_time_grid=None,
):
    """Build ``run(Y, t0, forcing=None, dt_run=None) -> Y'`` advancing
    ``steps_per_call`` steps of ``dt`` from ``t0`` (step ``i`` at time
    ``t0 + i * dt``).

    ``model`` is a :class:`~landhydrology.models.soil.model.SoilModel` or a
    :class:`~landhydrology.models.land.LandModel`; its step-level policies
    (equilibrium freeze-thaw projection, lagged coefficients, frozen
    surface exchange) are applied here, so callers pass a bare stepper.
    Prescribed profiles and MOST forcing are evaluated from ``(z, t)``
    inside the rhs.  ``dt_run`` overrides ``dt`` with a possibly traced
    step size (the adaptive driver's control variable).

    ``streamed_geometry``: optional ``(dz, zc)`` pair of traced arrays
    shaped ``(*batch)`` / ``(nz, *batch)`` for per-column grids that are
    only known as data, such as the shard-local slices of a
    ``VariableDepthColumn`` inside ``shard_map``.  The model's domain then
    supplies only ``nelements``.

    ``forcing_fields``: names of forcing fields (the
    :mod:`~landhydrology.runtime.forcing_driver` routing: atmospheric
    ``PrescribedAtmosForcing`` fields and/or ``"precipitation"``); ``run``
    then takes ``forcing``, a dict of ``(steps_per_call,)`` or
    ``(steps_per_call, *batch)`` rows, row ``i`` applied during step ``i``.

    ``forcing_time_grid``: optional ``(t_start, dt_forcing, n_rows)``
    switching the rows to time-indexed: ``forcing`` holds whole
    ``(n_rows, ...)`` tables and each step reads the row containing its
    start time (clamped to the table), so any ``dt_run`` works with one
    compiled program.
    """
    from landhydrology.models.land import (
        FrozenExchangeStepper,
        wrap_stepper_for_land,
    )
    from landhydrology.models.soil.freeze_thaw import (
        wrap_stepper_with_projection,
    )
    from landhydrology.models.soil.lagged import wrap_stepper_for_soil
    from landhydrology.runtime.forcing_driver import (
        _install_forcing_rows,
        _split_routing,
    )

    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil = model.soil if is_land else model
    name = soil.name
    dtype = soil.float_dtype
    steps_per_call = int(steps_per_call)

    def _strip_frozen(st):
        # the land policy is re-applied per step around the row-local land
        # model below; a caller-applied one would close over the unforced
        # model
        if isinstance(st, FrozenExchangeStepper):
            return _strip_frozen(st.inner)
        if hasattr(st, "inner"):
            return dataclasses.replace(st, inner=_strip_frozen(st.inner))
        return st

    if is_land:
        stepper = _strip_frozen(stepper)
    if getattr(soil, "freeze_thaw", None) is not None:
        stepper = wrap_stepper_with_projection(stepper, soil)

    forcing_fields = tuple(forcing_fields)
    if forcing_fields:
        atmos_keys, has_precip = _split_routing(model, forcing_fields)
    else:
        atmos_keys, has_precip = [], False
    time_indexed = forcing_time_grid is not None
    if time_indexed:
        if not forcing_fields:
            raise ValueError("forcing_time_grid requires forcing_fields")
        tg_start, tg_dt, tg_rows = forcing_time_grid
        tg_rows = int(tg_rows)
        if tg_rows < 1 or float(tg_dt) <= 0.0:
            raise ValueError(
                f"forcing_time_grid needs n_rows >= 1 and dt_forcing > 0; "
                f"got {forcing_time_grid}"
            )
    n_rows = tg_rows if time_indexed else steps_per_call

    if streamed_geometry is None:
        grid = make_function_space(soil.domain, dtype)
        zc = grid.zc
    else:
        dz_s, zc = streamed_geometry
        nz = int(soil.domain.nelements)
        ones = (1,) * (jnp.ndim(zc) - 1)
        # the rhs reads cell centers from Ya["zc"]; the grid carries dz
        grid = ColumnGrid(
            zc=jnp.zeros((nz, *ones), dtype),
            zf=jnp.zeros((nz + 1, *ones), dtype),
            dz=jnp.asarray(dz_s, dtype),
            nz=nz,
            batch_shape=tuple(jnp.shape(zc)[1:]),
        )

    def _rebind(st, soil_x):
        """Retarget steppers that close over the model or grid (imex
        solvers, the phase projection, lagged coefficients) to the
        row-local soil model and this runner's grid."""
        if hasattr(st, "inner"):
            st = dataclasses.replace(st, inner=_rebind(st.inner, soil_x))
        if hasattr(st, "model"):
            st = dataclasses.replace(st, model=soil_x)
        if hasattr(st, "grid"):
            st = dataclasses.replace(st, grid=grid)
        return st

    def make_step(m):
        soil_m = m.soil if is_land else m
        st = _rebind(stepper, soil_m)
        if is_land:
            st = wrap_stepper_for_land(st, m, grid)
        else:
            st = wrap_stepper_for_soil(st, m, grid)
        return m.make_rhs(grid), st

    if not forcing_fields:
        rhs0, stepper0 = make_step(model)

    def run(Y: dict, t0, forcing=None, dt_run=None) -> dict:
        if forcing_fields and forcing is None:
            raise ValueError(
                f"this segment run streams forcing fields {forcing_fields}; "
                "pass run(Y, t0, forcing=...)"
            )
        if forcing is not None:
            if not forcing_fields:
                raise ValueError(
                    "forcing passed but the run was built without "
                    "forcing_fields"
                )
            if set(forcing) != set(forcing_fields):
                raise KeyError(
                    f"forcing keys {sorted(forcing)} != declared "
                    f"forcing_fields {sorted(forcing_fields)}"
                )
            forcing = {k: jnp.asarray(v, dtype=dtype) for k, v in forcing.items()}
            for k, v in forcing.items():
                if v.ndim < 1 or v.shape[0] != n_rows:
                    raise ValueError(
                        f"forcing field {k!r} has shape {v.shape}; expected "
                        f"{n_rows} rows along the leading axis"
                    )
        t0 = jnp.asarray(t0, dtype=dtype)
        dt_k = jnp.asarray(dt if dt_run is None else dt_run, dtype=dtype)
        Ya = {"zc": zc, name: {}}
        if time_indexed:
            tg0 = jnp.asarray(tg_start, dtype=dtype)
            inv_dtF = jnp.asarray(1.0 / tg_dt, dtype=dtype)

        def body(i, Yc):
            t = t0 + i.astype(dtype) * dt_k
            if forcing is None:
                rhs, st = rhs0, stepper0
            else:
                j = _forcing_row_index(t, tg0, inv_dtF, n_rows) if time_indexed else i
                rows = {k: v[j] for k, v in forcing.items()}
                rhs, st = make_step(
                    _install_forcing_rows(model, rows, atmos_keys, has_precip)
                )
            return st.step(rhs, Yc, Ya, t, dt_k)

        return jax.lax.fori_loop(0, steps_per_call, body, Y)

    return run
