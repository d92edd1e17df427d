"""Sharded stepping — the multi-chip execution paths.

Two complementary paths over a :class:`jax.sharding.Mesh`:

- **pjit path** (default, fully general): the single-program step function
  is jitted with sharding constraints on the state; XLA partitions the
  embarrassingly parallel column physics with zero communication and lowers
  the lateral ``jnp.roll`` coupling to collective permutes.  Supports every
  feature (heterogeneous params, BatchedBC, MOST).
- **shard_map path** (halo-overlap optimized): the whole RK step runs as
  one per-shard program; the lateral term uses the explicit edge-slab halo
  exchange of ``halo.py``, issued so it overlaps the vertical sweeps
  (SURVEY.md §7 hard part 5).  Per-column parameter/BC arrays are streamed
  into the per-shard program as sharded arguments (the model is rebuilt
  from local slices), so heterogeneous configs run here too.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from landhydrology.domains import make_function_space
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.parallel.halo import _local_laplacian
from landhydrology.parallel.mesh import shard_state
from landhydrology.segment import reject_removed_options
from landhydrology.timestepping import AbstractTimestepper, SSPRK33

Array = Any


def _state_specs(tree, mesh: Mesh, batch_shape):
    """PartitionSpec pytree for a state: leaves shaped (nz, *batch) get
    their batch axes sharded; batch-only leaves (the pond height h_s of a
    LandModel state) shard the same way without the leading vertical axis;
    broadcast-ready singleton axes replicate."""
    ax = mesh.axis_names

    def _batch_parts(shape):
        return [
            name if size > 1 and size % mesh.shape[name] == 0 else None
            for size, name in zip(shape, ax)
        ]

    def spec(x):
        nd = getattr(x, "ndim", 0)
        if nd == len(batch_shape) and tuple(x.shape) == tuple(batch_shape):
            return P(*_batch_parts(x.shape))
        if nd < 1 + len(batch_shape):
            return P()
        return P(None, *_batch_parts(x.shape[1:]))

    return jax.tree_util.tree_map(spec, tree)


def _wrap_freeze_thaw(stepper, model):
    """Apply the equilibrium phase projection to the stepper when the model
    (or its soil component) configures EquilibriumFreezeThaw — without this,
    a freeze-thaw config would run on the sharded paths with the phase
    physics silently disabled (the rhs carries no equilibrium source; only
    the projection wrap does the work).  Idempotent no-op otherwise."""
    from landhydrology.models.soil.freeze_thaw import (
        wrap_stepper_with_projection,
    )

    ft_owner = getattr(model, "soil", model)
    if getattr(ft_owner, "freeze_thaw", None) is not None:
        return wrap_stepper_with_projection(stepper, ft_owner)
    return stepper


def make_sharded_step(
    model,
    mesh: Mesh,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    mode: str = "pjit",
):
    """Build a jitted, mesh-sharded ``step(Y, Ya, t) -> (Y', t')``.

    ``mode='pjit'``: sharding-constraint path (general).
    ``mode='shard_map'``: per-shard program with explicit halo exchange for
    the lateral coupling; per-column arrays are streamed as sharded args.
    """
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil_model = model.soil if is_land else model
    grid = make_function_space(soil_model.domain, model.float_dtype)
    dtype = model.float_dtype
    dt_a = jnp.asarray(dt, dtype=dtype)
    name = soil_model.name
    stepper = _wrap_freeze_thaw(stepper, model)

    if mode == "pjit":
        # AbstractModel protocol: composed models (LandModel) bring their
        # own rhs; XLA partitions the pond/routing terms with the state
        rhs = model.make_rhs(grid) if is_land else make_rhs(model, grid)
        if is_land:
            from landhydrology.models.land import wrap_stepper_for_land

            # step-level policies (frozen exchange / lagged coefficients):
            # no-op for the default stage-level config
            stepper = wrap_stepper_for_land(stepper, model, grid)
        else:
            from landhydrology.models.soil.lagged import (
                wrap_stepper_for_soil,
            )

            stepper = wrap_stepper_for_soil(stepper, model, grid)

        @jax.jit
        def step(Y, Ya, t):
            Y2 = stepper.step(rhs, Y, Ya, t, dt_a)
            return Y2, t + dt_a

        return step

    if mode != "shard_map":
        raise ValueError(f"unknown mode {mode!r}")
    # a caller-applied LaggedCoefficientStepper closes over the GLOBAL
    # model and would drop this branch's halo lateral term (its step
    # ignores the passed rhs); strip it — the policy is re-applied
    # natively inside _step_local from the shard-local model
    from landhydrology.models.soil.lagged import LaggedCoefficientStepper

    def _strip_lagged(st):
        if isinstance(st, LaggedCoefficientStepper):
            return _strip_lagged(st.inner)
        if hasattr(st, "inner"):
            return dataclasses.replace(st, inner=_strip_lagged(st.inner))
        return st

    stepper = _strip_lagged(stepper)
    if is_land:
        raise ValueError(
            "make_sharded_step(mode='shard_map') supports SoilModel only; "
            "LandModel runs multi-device via mode='pjit' or the "
            "make_fused_sharded_run segment path"
        )

    # --- shard_map path ---
    # the model config is closed over and replicated per shard; per-column
    # arrays (heterogeneous params, BatchedBC codes/values) would keep their
    # GLOBAL length inside the per-shard program, so every array-valued leaf of the
    # parameter/BC pytrees becomes an explicit sharded argument and the
    # model is rebuilt per shard from the local slices
    lc = model.lateral_coupling
    model_base = dataclasses.replace(model, lateral_coupling=None)
    hydrology = model_base.hydrology_model
    param_trees = (
        model_base.soil_param_set,
        getattr(hydrology, "hydraulic_model", None),
        getattr(hydrology, "viscosity_factor", None),
        getattr(hydrology, "impedance_factor", None),
        model_base.boundary_conditions,
    )
    flat_params, params_treedef = jax.tree_util.tree_flatten(param_trees)

    def _is_array(leaf):
        return hasattr(leaf, "ndim") and not callable(leaf) and leaf.ndim >= 1

    array_idx = [i for i, l in enumerate(flat_params) if _is_array(l)]
    param_args = [jnp.asarray(flat_params[i]) for i in array_idx]

    batch_shape = model.domain.batch_shape

    def _param_spec(x):
        # shard leaf dims that line up with full batch dims; replicate the
        # rest (broadcast-ready singleton or non-divisible axes)
        if x.ndim != len(batch_shape):
            return P()
        parts = []
        for size, axis_name in zip(x.shape, mesh.axis_names):
            parts.append(
                axis_name
                if size > 1 and size % mesh.shape[axis_name] == 0
                else None
            )
        return P(*parts)

    param_specs = tuple(_param_spec(x) for x in param_args)
    n_param_args = len(param_args)

    # variable-depth grids (VariableDepthColumn): the closed-over grid's
    # per-column dz would keep its GLOBAL length inside the per-shard
    # program — stream it as a sharded argument like the parameter leaves
    # (the rhs reads centers from Ya['zc'], which is sharded with the state)
    variable_dz = jnp.ndim(grid.dz) > 0
    if variable_dz:
        ones = (1,) * len(batch_shape)
        grid_stub = dataclasses.replace(
            grid,
            dz=jnp.zeros((), dtype),
            zc=jnp.zeros((grid.nz, *ones), dtype),
            zf=jnp.zeros((grid.nz + 1, *ones), dtype),
        )
        extra_args = (jnp.asarray(grid.dz, dtype=dtype),)
        extra_specs = (_param_spec(extra_args[0]),)
    else:
        grid_stub = grid
        extra_args = ()
        extra_specs = ()

    def _model_for_shard(local_arrays):
        leaves = list(flat_params)
        for pos, val in zip(array_idx, local_arrays):
            leaves[pos] = val
        sp_, hm_, visc_, imp_, bcs_ = jax.tree_util.tree_unflatten(
            params_treedef, leaves
        )
        out = dataclasses.replace(
            model_base, soil_param_set=sp_, boundary_conditions=bcs_
        )
        if hm_ is not None:
            out = dataclasses.replace(
                out,
                hydrology_model=dataclasses.replace(
                    hydrology,
                    hydraulic_model=hm_,
                    viscosity_factor=visc_,
                    impedance_factor=imp_,
                ),
            )
        return out

    mesh_shape = dict(mesh.shape)
    ax = mesh.axis_names[:2]
    top_idx = grid.nz - 1

    def _step_local(Y, Ya, t, *args):
        local_arrays = args[:n_param_args]
        grid_shard = (
            dataclasses.replace(grid_stub, dz=args[n_param_args])
            if variable_dz
            else grid
        )
        model_shard = _model_for_shard(list(local_arrays))
        rhs_local = make_rhs(model_shard, grid_shard)

        # steppers that close over the model/grid (PhaseEquilibriumStepper,
        # imex) must see the shard-local parameter slices
        def _rebind(st):
            if hasattr(st, "inner"):
                st = dataclasses.replace(st, inner=_rebind(st.inner))
            if hasattr(st, "model"):
                st = dataclasses.replace(st, model=model_shard)
            if hasattr(st, "grid"):
                st = dataclasses.replace(st, grid=grid_shard)
            return st

        stepper_local = _rebind(stepper)
        sp = model_shard.soil_param_set
        hm = (
            model_shard.hydrology_model.hydraulic_model
            if lc is not None
            else None
        )

        def with_lateral(base):
            def rhs(Y, Ya, t):
                dY = base(Y, Ya, t)
                if lc is not None:
                    vartheta_top = Y[name]["vartheta_l"][top_idx]
                    theta_i_top = Y[name]["theta_i"][top_idx]
                    nu_eff = sp.nu - theta_i_top
                    psi_top = sw.pressure_head(hm, vartheta_top, nu_eff, sp.S_s)
                    # local zc travels with the sharded aux state; for
                    # uniform grids the (1, ...) singleton slab broadcasts
                    # identically to the old scalar reshape
                    zc_top = Ya["zc"][top_idx]
                    h_top = psi_top + zc_top
                    lap = _local_laplacian(h_top, lc.dx, mesh_shape, ax)
                    d = dY[name]["vartheta_l"].at[top_idx].add(
                        lc.conductance / grid_shard.dz * lap
                    )
                    dY = {**dY, name: {**dY[name], "vartheta_l": d}}
                return dY

            return rhs

        # coefficient_update="step" is realized natively here (the halo
        # lateral term composes on top of the frozen-coefficient tendency,
        # which a generic stepper wrapper could not express)
        if getattr(model_shard, "coefficient_update", "stage") == "step":
            from landhydrology.models.soil.lagged import (
                make_coefficient_fns,
            )

            compute_coeffs, rhs_c = make_coefficient_fns(
                model_shard, grid_shard
            )
            C = compute_coeffs(Y, Ya, t)
            rhs = with_lateral(lambda Y_, Ya_, t_: rhs_c(C, Y_, Ya_, t_))
        else:
            rhs = with_lateral(rhs_local)

        Y2 = stepper_local.step(rhs, Y, Ya, t, dt_a)
        return Y2, t + dt_a

    def specs_for(tree):
        return _state_specs(tree, mesh, batch_shape)

    def step(Y, Ya, t):
        fn = shard_map(
            _step_local,
            mesh=mesh,
            in_specs=(specs_for(Y), specs_for(Ya), P(), *param_specs, *extra_specs),
            out_specs=(specs_for(Y), P()),
        )
        return fn(Y, Ya, t, *param_args, *extra_args)

    return jax.jit(step)


def make_sharded_run(model, mesh: Mesh, stepper=SSPRK33(), dt=1.0, n_steps=100,
                     mode: str = "pjit"):
    """A jitted n-step ``lax.scan`` over the sharded step (the multi-chip
    hot loop used by the benchmarks and the weak-scaling harness)."""
    step = make_sharded_step(model, mesh, stepper, dt, mode=mode)

    @jax.jit
    def run(Y, Ya, t0):
        def body(carry, _):
            Y, t = carry
            return step(Y, Ya, t), None

        (Yf, tf), _ = jax.lax.scan(body, (Y, t0), None, length=n_steps)
        return Yf, tf

    return run


def make_fused_sharded_run(
    model,
    mesh: Mesh,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    *,
    steps_per_call: int = 48,
    n_calls: int = 1,
    **removed,
):
    """The multi-device segment loop: :func:`~landhydrology.segment.
    make_segment_run` inside ``shard_map``, so each device advances its
    columns ``steps_per_call`` steps between lateral exchanges.

    Per shard: the local ``(nz, *local_batch)`` state is advanced
    ``steps_per_call`` steps per segment, ``n_calls`` times; per-column
    parameter/BC leaves are streamed as sharded arguments exactly like the
    plain shard_map path.

    Lateral surface coupling runs as a first-order **Lie split**: each
    segment advances the vertical physics with the lateral term frozen, then
    one explicit lateral update with halo exchange is applied over the
    segment window ``w = steps_per_call * dt``.  The split is device-count
    invariant (the halo laplacian is numerically identical to the roll
    laplacian), so an N-device run matches a 1-device run of the same
    scheme.  **Accuracy model (measured, see
    ``tests/parallel/test_sharding.py::test_fused_sharded_lateral_split_
    first_order_in_window``)**: the deviation from the unsplit trajectory is
    first order in the window, ``err ~ C w`` with ``C`` of the order of the
    lateral tendency ``(c / dz) lap(h)``; halving ``w`` halves the error.
    Near the stability limit ``w_max = dx^2 dz / (4 c)`` (checked at
    construction) the error grows superlinearly — choose ``w <~ w_max / 5``
    for the clean first-order regime, and shrink ``steps_per_call`` (or
    chain more ``n_calls``) until the lateral update per window is small
    against the fields it moves.

    Heterogeneous params, BatchedBC and MOST all run here.  LandModel
    composes too: the pond state h_s shards with the columns, the pond +
    MOST exchange runs inside the segment, and pond routing joins the
    lateral Lie split at segment boundaries — diffusive
    :class:`~landhydrology.models.land.RunoffRouting` via the halo
    Laplacian, Manning :class:`KinematicWaveRouting` via upwinded face
    fluxes with one-cell halo exchange
    (``parallel/halo._local_kinematic_tendency``; the per-column elevation
    field is streamed as a sharded argument).  The kinematic window has no
    static stability check (the wave speed is state-dependent) — size
    ``steps_per_call * dt`` with
    :func:`~landhydrology.models.land.kinematic_wave_dt_limit`.

    Returns jitted ``run(Y, Ya, t0) -> (Y', t')`` advancing
    ``n_calls * steps_per_call`` steps.
    """
    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    soil_model = model.soil if is_land else model
    surface = model.surface if is_land else None
    surf_name = surface.name if is_land else None
    grid = make_function_space(soil_model.domain, model.float_dtype)
    variable_dz = jnp.ndim(grid.dz) > 0
    dtype = model.float_dtype
    dt_f = float(dt)
    name = soil_model.name
    nz = grid.nz
    dz_f = None if variable_dz else float(grid.dz)
    batch_shape = soil_model.domain.batch_shape
    reject_removed_options("make_fused_sharded_run", removed)

    seg_dt = steps_per_call * dt_f
    lc = soil_model.lateral_coupling
    if lc is not None and variable_dz:
        raise ValueError(
            "lateral surface coupling with VariableDepthColumn is not "
            "supported on the segment-sharded path (the Lie-split update "
            "needs a uniform dz) — use make_sharded_step(mode='shard_map')"
        )
    if lc is not None:
        lat_limit = lc.dx * lc.dx * dz_f / (4.0 * lc.conductance)
        if seg_dt > lat_limit:
            raise ValueError(
                f"lateral split window steps_per_call*dt={seg_dt:g}s exceeds "
                f"the lateral explicit limit dx^2*dz/(4c)={lat_limit:g}s; "
                "reduce steps_per_call or dt"
            )
    ro = surface.runoff if is_land else None
    ro_is_kinematic = False
    if ro is not None:
        from landhydrology.models.land import (
            KinematicWaveRouting,
            RunoffRouting,
        )

        if isinstance(ro, KinematicWaveRouting):
            # upwinded Manning fluxes with one-cell halo exchange at
            # segment boundaries (parallel/halo._local_kinematic_tendency).
            # The kinematic wave speed depends on the evolving pond depth,
            # so there is no static window check — size the window with
            # models.land.kinematic_wave_dt_limit at the expected depths.
            ro_is_kinematic = True
        elif isinstance(ro, RunoffRouting):
            ro_limit = ro.dx * ro.dx / (4.0 * ro.conductance)
            if seg_dt > ro_limit:
                raise ValueError(
                    f"routing split window steps_per_call*dt={seg_dt:g}s "
                    f"exceeds the diffusive routing limit dx^2/(4c)="
                    f"{ro_limit:g}s; reduce steps_per_call or dt"
                )
        else:
            raise ValueError(f"unknown runoff routing config {ro!r}")
    soil_base = dataclasses.replace(soil_model, lateral_coupling=None)
    if is_land:
        model_base = dataclasses.replace(
            model,
            soil=soil_base,
            surface=dataclasses.replace(surface, runoff=None),
        )
    else:
        model_base = soil_base
    hydrology = soil_base.hydrology_model
    param_trees = (
        soil_base.soil_param_set,
        getattr(hydrology, "hydraulic_model", None),
        getattr(hydrology, "viscosity_factor", None),
        getattr(hydrology, "impedance_factor", None),
        soil_base.boundary_conditions,
        (
            {
                "tau_pond": surface.tau_pond,
                "h_evap_smoothing": surface.h_evap_smoothing,
            }
            if is_land
            else None
        ),
    )
    flat_params, params_treedef = jax.tree_util.tree_flatten(param_trees)

    def _is_array(leaf):
        return hasattr(leaf, "ndim") and not callable(leaf) and leaf.ndim >= 1

    array_idx = [i for i, l in enumerate(flat_params) if _is_array(l)]
    param_args = [jnp.asarray(flat_params[i]) for i in array_idx]
    n_param_args = len(param_args)

    def _param_spec(x):
        if x.ndim != len(batch_shape):
            return P()
        parts = []
        for size, axis_name in zip(x.shape, mesh.axis_names):
            parts.append(
                axis_name
                if size > 1 and size % mesh.shape[axis_name] == 0
                else None
            )
        return P(*parts)

    param_specs = tuple(_param_spec(x) for x in param_args)

    # VariableDepthColumn: the per-column dz is sharded data streamed into
    # the per-shard segment (mirroring the plain shard_map path); the local
    # zc slab travels with the sharded aux state (Ya['zc'])
    if variable_dz:
        geom_args = (jnp.asarray(grid.dz, dtype=dtype),)
        geom_specs = (_param_spec(geom_args[0]),)
    else:
        geom_args = ()
        geom_specs = ()
    n_geom = len(geom_args)

    # kinematic routing over real terrain: the per-column elevation field
    # must arrive as a SHARD-LOCAL slab (closed over, it would keep its
    # global shape inside the per-shard program) — stream it like the
    # parameter leaves
    if ro_is_kinematic and jnp.ndim(ro.elevation) > 0:
        ro_args = (jnp.asarray(ro.elevation, dtype=dtype),)
        ro_specs = (_param_spec(ro_args[0]),)
    else:
        ro_args = ()
        ro_specs = ()

    def _model_for_shard(local_arrays, local_batch):
        leaves = list(flat_params)
        for pos, val in zip(array_idx, local_arrays):
            leaves[pos] = val
        sp_, hm_, visc_, imp_, bcs_, surf_extra = jax.tree_util.tree_unflatten(
            params_treedef, leaves
        )
        if variable_dz:
            # geometry arrives as streamed data; the domain only supplies
            # nelements and the batch rank
            from landhydrology.domains import Column as _Column

            local_domain = _Column(
                zlim=(-1.0, 0.0), nelements=nz, batch_shape=local_batch
            )
        else:
            local_domain = dataclasses.replace(
                soil_base.domain, batch_shape=local_batch
            )
        out = dataclasses.replace(
            soil_base,
            domain=local_domain,
            soil_param_set=sp_,
            boundary_conditions=bcs_,
        )
        if hm_ is not None:
            out = dataclasses.replace(
                out,
                hydrology_model=dataclasses.replace(
                    hydrology,
                    hydraulic_model=hm_,
                    viscosity_factor=visc_,
                    impedance_factor=imp_,
                ),
            )
        if is_land:
            return dataclasses.replace(
                model_base,
                soil=out,
                surface=dataclasses.replace(model_base.surface, **surf_extra),
            )
        return out

    from landhydrology.segment import make_segment_run

    mesh_shape = dict(mesh.shape)
    ax = mesh.axis_names[:2]
    top_idx = nz - 1

    def _run_local(Y, Ya, t0, *args):
        local_arrays = list(args[:n_param_args])
        state = Y[name]
        local_batch = tuple(state[next(iter(state))].shape[1:])
        model_shard = _model_for_shard(local_arrays, local_batch)
        soil_shard = model_shard.soil if is_land else model_shard
        geometry = (args[n_param_args], Ya["zc"]) if variable_dz else None
        if ro_args:
            ro_local = dataclasses.replace(
                ro, elevation=args[n_param_args + n_geom]
            )
        else:
            ro_local = ro
        segment = make_segment_run(
            model_shard,
            stepper,
            dt=dt_f,
            steps_per_call=steps_per_call,
            streamed_geometry=geometry,
        )
        if lc is not None:
            sp = soil_shard.soil_param_set
            hm = soil_shard.hydrology_model.hydraulic_model
            zc_top = Ya["zc"][top_idx]  # (*ones) broadcast-ready

        def seg(carry, _):
            Yc, t = carry
            Yc = segment(Yc, t)
            t = t + jnp.asarray(steps_per_call * dt_f, dtype=dtype)
            if lc is not None:
                # Lie-split lateral update over the segment window, with the
                # explicit edge-slab halo exchange (overlaps vertical work)
                vt = Yc[name]["vartheta_l"][top_idx]
                ti = Yc[name]["theta_i"][top_idx]
                nu_eff = sp.nu - ti
                psi = sw.pressure_head(hm, vt, nu_eff, sp.S_s)
                h_top = psi + jnp.broadcast_to(zc_top, local_batch)
                lap = _local_laplacian(h_top, lc.dx, mesh_shape, ax)
                delta = (steps_per_call * dt_f) * lc.conductance / dz_f * lap
                d = Yc[name]["vartheta_l"].at[top_idx].set(vt + delta)
                Yc = {**Yc, name: {**Yc[name], "vartheta_l": d}}
            if ro is not None:
                # pond routing, Lie-split over the same window and
                # numerically identical to the roll formulation of
                # models/land.routing_tendency (device-count invariant):
                # diffusive -> halo Laplacian; kinematic -> upwinded
                # Manning face fluxes with one-cell halo exchange
                hs = Yc[surf_name]["h_s"]
                if ro_is_kinematic:
                    from landhydrology.parallel.halo import (
                        _local_kinematic_tendency,
                    )

                    dh = _local_kinematic_tendency(
                        ro_local, hs, mesh_shape, ax
                    )
                    hs2 = hs + (steps_per_call * dt_f) * dh
                else:
                    h_eff = jnp.maximum(hs - ro.h_detention, 0.0)
                    lap_h = _local_laplacian(h_eff, ro.dx, mesh_shape, ax)
                    hs2 = (
                        hs + (steps_per_call * dt_f) * ro.conductance * lap_h
                    )
                Yc = {**Yc, surf_name: {"h_s": hs2}}
            return (Yc, t), None

        (Yf, tf), _ = jax.lax.scan(
            seg, (Y, jnp.asarray(t0, dtype=dtype)), None, length=n_calls
        )
        return Yf, tf

    def specs_for(tree):
        return _state_specs(tree, mesh, batch_shape)

    def run(Y, Ya, t0):
        fn = shard_map(
            _run_local,
            mesh=mesh,
            in_specs=(
                specs_for(Y), specs_for(Ya), P(), *param_specs, *geom_specs,
                *ro_specs,
            ),
            out_specs=(specs_for(Y), P()),
        )
        return fn(Y, Ya, t0, *param_args, *geom_args, *ro_args)

    return jax.jit(run)
