"""End-to-end forcing pipeline consumption (VERDICT r2 item 2): forcing
files written with write_forcing stream through ForcingReader windows into
jitted runs — windowed streaming must equal a single in-memory run exactly,
and the native reader's prefetch must actually fire."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    initialize_states,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.heat import (
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.runtime import (
    ForcingReader,
    make_forced_segment_run,
    run_forced,
    write_forcing,
)
from landhydrology.segment import make_segment_run
from landhydrology.timestepping import SSPRK33

NZ, NCOL = 12, 16
DT = 60.0


def _atmos_soil():
    return SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6,
                                         theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
    )


def _ic(z, m):
    shape = (NZ, NCOL)
    th = jnp.broadcast_to(
        0.15 + 0.1 * jnp.linspace(0.0, 1.0, NCOL)[None, :], shape
    )
    ti = jnp.zeros(shape)
    rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
    return {
        "vartheta_l": th,
        "theta_i": ti,
        "rho_e_int": volumetric_internal_energy(
            ti, rcs, jnp.full(shape, 290.0), ps
        ),
    }


def _diurnal_forcing(n_steps, rng):
    """Synthetic diurnal reanalysis slice: per-column wind/temperature/
    humidity cycles with random per-column phase."""
    t = np.arange(n_steps) * DT
    phase = rng.uniform(0.0, 2 * np.pi, NCOL)
    day = 2 * np.pi * t[:, None] / 86400.0 + phase[None, :]
    return {
        "u_atm": (2.0 + 1.5 * np.sin(day)).astype(np.float64),
        "theta_atm": (295.0 + 8.0 * np.sin(day - 0.5)).astype(np.float64),
        "q_atm": (0.004 + 0.002 * np.cos(day)).astype(np.float64),
    }


def test_windowed_streaming_matches_in_memory(tmp_path):
    """run_forced over file windows == one in-memory segment over the full
    forcing arrays, exactly; prefetch hits > 0 on the native reader."""
    n_steps = 40
    rng = np.random.default_rng(0)
    fields = _diurnal_forcing(n_steps, rng)
    path = str(tmp_path / "forcing.bin")
    write_forcing(path, np.arange(n_steps) * DT, fields)

    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)

    # in-memory reference: one scan over the full rows
    seg = make_forced_segment_run(
        model, SSPRK33(), dt=DT, field_names=sorted(fields)
    )
    forcing_mem = {k: jnp.asarray(v) for k, v in fields.items()}
    Yref, tref = seg(Y, Ya, 0.0, forcing_mem)

    with ForcingReader(path) as reader:
        # window does not divide n_steps: exercises the tail window too
        Yf, tf = run_forced(
            model, Y, Ya, reader, SSPRK33(), dt=DT, window=16
        )
        hits = reader.prefetch_hits
        native = reader.is_native
    assert float(tf) == pytest.approx(float(tref))
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )
    if native:
        assert hits > 0  # the background prefetch actually served reads
    # the forcing actually did something: columns diverge from a
    # constant-forcing run
    const = {
        k: jnp.broadcast_to(jnp.asarray(v[:1]), v.shape)
        for k, v in fields.items()
    }
    Yc, _ = seg(Y, Ya, 0.0, const)
    assert (
        float(
            jnp.max(
                jnp.abs(Yc["soil"]["rho_e_int"] - Yf["soil"]["rho_e_int"])
            )
        )
        > 0.0
    )


def test_forced_land_precipitation_ponds(tmp_path):
    """'precipitation' rows drive the LandModel pond: a rain pulse in the
    file makes h_s grow then drain, matching the in-memory run exactly."""
    from landhydrology.models.land import (
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
    )

    n_steps = 30
    rain = np.zeros((n_steps, NCOL))
    rain[5:15] = 8e-6  # pulse above the tight soil's capacity
    fields = {"precipitation": rain, **_diurnal_forcing(n_steps,
                                                        np.random.default_rng(1))}
    path = str(tmp_path / "forcing_land.bin")
    write_forcing(path, np.arange(n_steps) * DT, fields)

    soil = dataclasses.replace(
        _atmos_soil(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7,
                                         theta_r=0.05)
        ),
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(tau_pond=240.0))
    Y, Ya = land_init(land, _ic, 0.0, h_s0=0.0)

    seg = make_forced_segment_run(
        land, SSPRK33(), dt=DT, field_names=sorted(fields)
    )
    Yref, _ = seg(Y, Ya, 0.0, {k: jnp.asarray(v) for k, v in fields.items()})

    with ForcingReader(path) as reader:
        Yf, _ = run_forced(land, Y, Ya, reader, SSPRK33(), dt=DT, window=8)

    assert float(jnp.max(Yref["surface"]["h_s"])) > 1e-5  # pulse ponded
    np.testing.assert_allclose(
        np.asarray(Yf["surface"]["h_s"]), np.asarray(Yref["surface"]["h_s"]),
        rtol=1e-13, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )


def test_segment_forced_rows_match_forced_scan():
    """Step-indexed forcing rows through the segment runner: the
    trajectory equals the per-step forced scan (same piecewise-constant row
    semantics), with a per-step scalar and a per-column forcing field."""
    n_steps = 29
    rng = np.random.default_rng(7)
    fields = _diurnal_forcing(n_steps, rng)
    # one per-step scalar field beside the per-column ones
    fields["theta_atm"] = fields["theta_atm"][:, 0].copy()

    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    forcing = {k: jnp.asarray(v) for k, v in fields.items()}

    seg_x = make_forced_segment_run(
        model, SSPRK33(), dt=DT, field_names=sorted(fields)
    )
    Yx, tx = seg_x(Y, Ya, 0.0, forcing)

    seg_f = make_segment_run(
        model, SSPRK33(), dt=DT, steps_per_call=n_steps,
        forcing_fields=sorted(fields),
    )
    Yf = seg_f(Y, 0.0, forcing=forcing)

    assert float(tx) == pytest.approx(n_steps * DT)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


def test_segment_forced_land_precipitation_matches_forced_scan():
    """Per-column precipitation rows stream through the segment runner for
    the LandModel (the reanalysis flagship composition): pond + soil match
    the forced scan."""
    from landhydrology.models.land import (
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
    )

    n_steps = 24
    rain = np.zeros((n_steps, NCOL))
    rain[4:12] = 8e-6
    fields = {
        "precipitation": rain,
        **_diurnal_forcing(n_steps, np.random.default_rng(3)),
    }

    soil = dataclasses.replace(
        _atmos_soil(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7,
                                         theta_r=0.05)
        ),
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(tau_pond=240.0))
    Y, Ya = land_init(land, _ic, 0.0, h_s0=0.0)
    forcing = {k: jnp.asarray(v) for k, v in fields.items()}

    seg_x = make_forced_segment_run(
        land, SSPRK33(), dt=DT, field_names=sorted(fields)
    )
    Yx, _ = seg_x(Y, Ya, 0.0, forcing)
    seg_f = make_segment_run(
        land, SSPRK33(), dt=DT, steps_per_call=n_steps,
        forcing_fields=sorted(fields),
    )
    Yf = seg_f(Y, 0.0, forcing=forcing)

    assert float(jnp.max(Yx["surface"]["h_s"])) > 1e-5  # the pulse ponded
    np.testing.assert_allclose(
        np.asarray(Yf["surface"]["h_s"]), np.asarray(Yx["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


def test_forcing_field_routing_validation():
    model = _atmos_soil()
    with pytest.raises(KeyError, match="route nowhere"):
        make_forced_segment_run(model, field_names=("u_atm", "banana"))
    with pytest.raises(TypeError, match="LandModel"):
        make_forced_segment_run(model, field_names=("precipitation",))
    no_atmos = dataclasses.replace(
        model,
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
    )
    with pytest.raises(TypeError, match="PrescribedAtmosForcing"):
        make_forced_segment_run(no_atmos, field_names=("u_atm",))


def test_forced_run_under_pjit_sharding(tmp_path):
    """Per-column forcing rows shard with the columns: an 8-device pjit
    forced run matches the single-device trajectory."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from landhydrology.parallel import make_column_mesh

    n_steps = 16
    fields = _diurnal_forcing(n_steps, np.random.default_rng(2))
    path = str(tmp_path / "forcing_shard.bin")
    write_forcing(path, np.arange(n_steps) * DT, fields)

    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    with ForcingReader(path) as reader:
        Y1, _ = run_forced(model, Y, Ya, reader, SSPRK33(), dt=DT, window=8)

    mesh = make_column_mesh(shape=(8,), axis_names=("x",))
    sh = NamedSharding(mesh, P(None, "x"))
    Ys = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), Y)
    with ForcingReader(path) as reader:
        YN, _ = run_forced(model, Ys, Ya, reader, SSPRK33(), dt=DT, window=8)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


# ---- adaptive error control x streamed forcing (VERDICT r4 item 4) ----


def _pulse_tables(n_rows, rng):
    """Scalar wind + per-column humidity + a mid-run warm pulse: forcing
    that genuinely changes the trajectory, on a coarse time grid."""
    u = 2.0 + 1.5 * rng.random(n_rows)
    th = 296.0 + np.zeros(n_rows)
    th[n_rows // 3 : n_rows // 2] = 305.0  # pulse
    q = 0.004 + 0.002 * rng.random((n_rows, NCOL))
    return {
        "u_atm": u.astype(np.float64),
        "theta_atm": th.astype(np.float64),
        "q_atm": q.astype(np.float64),
    }


def test_adaptive_forced_xla_matches_fine_fixed_dt():
    """run_adaptive_forced under a piecewise-constant-in-time
    forcing table == a fine fixed-dt forced scan with the rows repeated to
    the fine grid (identical forcing semantics), to controller tolerance."""
    from landhydrology.adaptive import AdaptiveConfig, run_adaptive_forced

    n_rows, dtF = 12, 240.0
    rng = np.random.default_rng(5)
    tables = _pulse_tables(n_rows, rng)
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    tf = n_rows * dtF

    # fine fixed-dt reference: dt = dtF/8, every row repeated 8x — exactly
    # the same forcing-as-a-function-of-time
    m = 8
    fine = {k: np.repeat(v, m, axis=0) for k, v in tables.items()}
    seg = make_forced_segment_run(
        model, SSPRK33(), dt=dtF / m, field_names=sorted(fine)
    )
    Yref, tref = seg(Y, Ya, 0.0, {k: jnp.asarray(v) for k, v in fine.items()})
    assert float(tref) == pytest.approx(tf)

    # dt_max = dtF/4: a step samples its row at step START, so each row
    # boundary crossed mid-step contributes O(dt) forcing-sampling error
    # outside the controller's estimate — bounding dt under the row
    # spacing bounds that sampling error alongside the controlled one
    Yf, stats = run_adaptive_forced(
        model, Y, Ya, 0.0, tf, dt0=60.0,
        forcing=tables, forcing_dt=dtF,
        config=AdaptiveConfig(rtol=1e-7, atol=1e-12, dt_max=dtF / 4),
    )
    assert bool(stats["converged"])
    for k in Y["soil"]:
        a, b = np.asarray(Yf["soil"][k]), np.asarray(Yref["soil"][k])
        scale = np.max(np.abs(b)) or 1.0
        assert np.max(np.abs(a - b)) / scale < 5e-5, k

    # the pulse mattered: a run with the pulse flattened ends elsewhere
    flat = dict(tables, theta_atm=np.full(n_rows, 296.0))
    Yflat, _ = run_adaptive_forced(
        model, Y, Ya, 0.0, tf, dt0=60.0, forcing=flat, forcing_dt=dtF,
        config=AdaptiveConfig(rtol=1e-7, atol=1e-12, dt_max=dtF),
    )
    assert (
        float(
            jnp.max(jnp.abs(Yflat["soil"]["rho_e_int"] - Yf["soil"]["rho_e_int"]))
        )
        > 0.0
    )


def test_adaptive_fused_forced_spc1_matches_adaptive_forced():
    """run_adaptive_fused with time-indexed rows and segments of 1 step
    takes the same controller decisions and produces the same trajectory
    as run_adaptive_forced."""
    from landhydrology.adaptive import (
        AdaptiveConfig,
        run_adaptive_forced,
        run_adaptive_fused,
    )

    n_rows, dtF = 8, 240.0
    tables = _pulse_tables(n_rows, np.random.default_rng(9))
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    tf = n_rows * dtF
    cfg = AdaptiveConfig(rtol=1e-5, atol=1e-10, dt_max=dtF)

    Yx, sx = run_adaptive_forced(
        model, Y, Ya, 0.0, tf, dt0=60.0, forcing=tables, forcing_dt=dtF,
        config=cfg,
    )
    Yf, sf = run_adaptive_fused(
        model, Y, Ya, 0.0, tf, dt0=60.0, forcing=tables, forcing_dt=dtF,
        config=cfg, steps_per_call=1,
    )
    assert bool(sx["converged"]) and bool(sf["converged"])
    assert int(sf["n_accepted"]) == int(sx["n_accepted"])
    assert int(sf["n_rejected"]) == int(sx["n_rejected"])
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-10, atol=1e-14, err_msg=k,
        )


def test_adaptive_forced_fused_segments_accuracy():
    """Macro-segment adaptive (steps_per_call=4) under time-indexed forcing
    still lands within tolerance of the fine fixed-dt forced reference."""
    from landhydrology.adaptive import AdaptiveConfig, run_adaptive_fused

    n_rows, dtF = 8, 240.0
    tables = _pulse_tables(n_rows, np.random.default_rng(11))
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    tf = n_rows * dtF

    m = 8
    fine = {k: np.repeat(v, m, axis=0) for k, v in tables.items()}
    seg = make_forced_segment_run(
        model, SSPRK33(), dt=dtF / m, field_names=sorted(fine)
    )
    Yref, _ = seg(Y, Ya, 0.0, {k: jnp.asarray(v) for k, v in fine.items()})

    Yf, stats = run_adaptive_fused(
        model, Y, Ya, 0.0, tf, dt0=30.0,
        forcing=tables, forcing_dt=dtF,
        config=AdaptiveConfig(rtol=1e-7, atol=1e-12, dt_max=dtF / 4),
        steps_per_call=4,
    )
    assert bool(stats["converged"])
    for k in Y["soil"]:
        a, b = np.asarray(Yf["soil"][k]), np.asarray(Yref["soil"][k])
        scale = np.max(np.abs(b)) or 1.0
        assert np.max(np.abs(a - b)) / scale < 2e-5, k


def test_adaptive_forced_validation():
    from landhydrology.adaptive import run_adaptive_fused

    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    with pytest.raises(ValueError, match="forcing_dt"):
        run_adaptive_fused(
            model, Y, Ya, 0.0, 1.0, 0.1, forcing={"u_atm": jnp.ones(4)},
        )
    with pytest.raises(ValueError, match="forcing_time_grid"):
        make_segment_run(
            model, SSPRK33(), dt=1.0, forcing_time_grid=(0.0, 1.0, 4)
        )


def test_adaptive_forced_with_implicit_stepper_both_engines():
    """The full composition: TR-BDF2 (implicit, PCR backend) under
    adaptive error control under streamed time-varying forcing, on both
    the per-step and the segment driver — the 'every engine enforces every
    policy' bar extended to the implicit steppers."""
    from landhydrology.adaptive import (
        AdaptiveConfig,
        run_adaptive_forced,
        run_adaptive_fused,
    )
    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil

    n_rows, dtF = 6, 600.0
    tables = _pulse_tables(n_rows, np.random.default_rng(13))
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    grid = make_function_space(model.domain, jnp.float64)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=2, tridiag="pcr")
    tf = n_rows * dtF
    cfg = AdaptiveConfig(rtol=1e-6, atol=1e-10, dt_max=dtF / 2)

    Yx, sx = run_adaptive_forced(
        model, Y, Ya, 0.0, tf, dt0=120.0, forcing=tables, forcing_dt=dtF,
        stepper=stepper, config=cfg,
    )
    Yf, sf = run_adaptive_fused(
        model, Y, Ya, 0.0, tf, dt0=120.0, forcing=tables, forcing_dt=dtF,
        stepper=stepper, config=cfg, steps_per_call=1,
    )
    assert bool(sx["converged"]) and bool(sf["converged"])
    assert int(sf["n_accepted"]) == int(sx["n_accepted"])
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-9, atol=1e-12, err_msg=k,
        )


def test_forced_scan_with_implicit_stepper_segment_matches():
    """make_forced_segment_run drives the implicit stepper too, and the
    segment runner's step-indexed rows with TR-BDF2 give the same
    trajectory."""
    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil

    n_steps = 12
    fields = _diurnal_forcing(n_steps, np.random.default_rng(17))
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    grid = make_function_space(model.domain, jnp.float64)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=2)
    forcing = {k: jnp.asarray(v) for k, v in fields.items()}

    seg_x = make_forced_segment_run(
        model, stepper, dt=300.0, field_names=sorted(fields)
    )
    Yx, _ = seg_x(Y, Ya, 0.0, forcing)
    seg_f = make_segment_run(
        model, stepper, dt=300.0, steps_per_call=n_steps,
        forcing_fields=sorted(fields),
    )
    Yf = seg_f(Y, 0.0, forcing=forcing)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-11, atol=1e-15, err_msg=k,
        )


def test_time_indexed_rows_clamp_at_table_ends():
    """Steps whose start time falls before the forcing grid's origin or
    beyond its last row read the clamped end rows (documented semantics),
    on both engines identically."""
    from landhydrology.domains import make_function_space
    from landhydrology.runtime.forcing_driver import TimeForcedStepper

    n_rows, dtF = 4, 100.0
    tables = {
        "u_atm": jnp.asarray([1.0, 2.0, 3.0, 4.0]),
        "q_atm": jnp.asarray(
            0.003 + 0.001 * np.arange(n_rows)[:, None]
            + np.zeros((n_rows, NCOL))
        ),
    }
    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    grid = make_function_space(model.domain, jnp.float64)
    # forcing grid starts at t=200: the first two dt=100 steps start
    # BEFORE it (clamp to row 0); the last steps run past the table
    # (clamp to row 3)
    t_start, dt, n = 200.0, 100.0, 9
    st = TimeForcedStepper(
        inner=SSPRK33(), model=model, grid=grid, tables=tables,
        t_start=t_start, dt_forcing=dtF,
    )

    Yx, t = Y, jnp.asarray(0.0)
    for _ in range(n):
        Yx = st.step(None, Yx, Ya, t, jnp.asarray(dt))
        t = t + dt

    run = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=n,
        forcing_fields=tuple(sorted(tables)),
        forcing_time_grid=(t_start, dtF, n_rows),
    )
    Yk = run(Y, 0.0, forcing=tables)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yk["soil"][k]), np.asarray(Yx["soil"][k]),
            rtol=1e-12, atol=1e-16, err_msg=k,
        )

    # manual reference with the clamped row sequence: steps at
    # t=0,100 -> row 0; 200->0, 300->1, 400->2, 500->3; 600,700,800 -> 3
    rows_seq = [0, 0, 0, 1, 2, 3, 3, 3, 3]
    Ym, t = Y, jnp.asarray(0.0)
    for i in range(n):
        mi = dataclasses.replace(
            model,
            boundary_conditions=SoilColumnBC(
                top=dataclasses.replace(
                    model.boundary_conditions.top,
                    u_atm=tables["u_atm"][rows_seq[i]],
                    q_atm=tables["q_atm"][rows_seq[i]],
                ),
                bottom=model.boundary_conditions.bottom,
            ),
        )
        rhs_i = mi.make_rhs(grid)
        Ym = SSPRK33().step(rhs_i, Ym, Ya, t, jnp.asarray(dt))
        t = t + dt
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yx["soil"][k]), np.asarray(Ym["soil"][k]),
            rtol=1e-12, atol=1e-16, err_msg=k,
        )


@pytest.mark.parametrize(
    "call",
    ["make_forced_segment_run", "run_forced", "run_adaptive_forced"],
)
def test_removed_engine_options_raise(call):
    """Options of the removed Pallas engine fail loudly instead of running
    the XLA path under a name that no longer means anything."""
    from landhydrology.adaptive import run_adaptive_forced

    model = _atmos_soil()
    Y, Ya = initialize_states(model, _ic, 0.0)
    calls = {
        "make_forced_segment_run": lambda: make_forced_segment_run(
            model, field_names=("u_atm",), engine="fused"
        ),
        "run_forced": lambda: run_forced(
            model, Y, Ya, None, tile_cols=NCOL
        ),
        "run_adaptive_forced": lambda: run_adaptive_forced(
            model, Y, Ya, 0.0, 1.0, 0.1, forcing={"u_atm": jnp.ones(4)},
            forcing_dt=1.0, engine="fused", steps_per_call=4,
        ),
    }
    with pytest.raises(TypeError, match="removed"):
        calls[call]()
