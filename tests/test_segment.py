"""Segment runner equivalence tests: ``make_segment_run``'s
``fori_loop`` over ``steps_per_call`` steps must match a step-by-step
loop over the same rhs + stepper exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.domains import make_function_space
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.heat import (
    k_solid,
    ksat_frozen,
    ksat_unfrozen,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.segment import make_segment_run
from landhydrology.timestepping import SSPRK33

NZ, NCOL = 16, 256


def _model(bc_top_hydrology, bc_bottom_hydrology):
    nu = 0.5
    ks = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.92,
        rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, nu, 2.29),
    )
    return SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=bc_top_hydrology, energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=bc_bottom_hydrology, energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        dtype=jnp.float64,
    )


def _state(msp_rho_c_ds=0.5 * 1.926e6):
    rng = np.random.default_rng(0)
    theta = jnp.asarray(0.3 + 0.1 * rng.random((NZ, NCOL)))
    theta_i = jnp.zeros((NZ, NCOL))
    T = jnp.asarray(285.0 + 5 * rng.random((NZ, NCOL)))
    rho_c_s = volumetric_heat_capacity(theta, theta_i, msp_rho_c_ds, ps)
    return {
        "soil": {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
        }
    }


@pytest.mark.parametrize(
    "top,bottom",
    [
        (VerticalFlux(0.0), FreeDrainage()),
        (Dirichlet(lambda t: 0.4), VerticalFlux(0.0)),
    ],
)
def test_segment_matches_scan(top, bottom):
    model = _model(top, bottom)
    grid = make_function_space(model.domain, jnp.float64)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 5.0, 8

    rhs = make_rhs(model, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for i in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_heterogeneous_params():
    """Per-column van Genuchten + porosity arrays run through the segment
    and match the step-by-step loop."""
    import dataclasses

    rng = np.random.default_rng(3)
    base = _model(VerticalFlux(0.0), FreeDrainage())
    hm_b = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.5, 3.5, NCOL)),
        alpha=jnp.asarray(rng.uniform(1.5, 4.0, NCOL)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-5, NCOL)),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.05, NCOL)),
    )
    msp_b = dataclasses.replace(
        base.soil_param_set, nu=jnp.asarray(rng.uniform(0.45, 0.55, NCOL))
    )
    model = dataclasses.replace(
        base,
        hydrology_model=dataclasses.replace(
            base.hydrology_model, hydraulic_model=hm_b
        ),
        soil_param_set=msp_b,
    )
    grid = make_function_space(model.domain, jnp.float64)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 5.0, 8

    rhs = make_rhs(model, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for i in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_richards_only():
    """Prescribed-temperature Richards-only model through the segment
    (prescribed T recomputed from its profile each stage) matches the
    step-by-step loop."""
    from landhydrology import PrescribedTemperatureModel
    import dataclasses

    base = _model(Dirichlet(lambda t: 0.4), FreeDrainage())
    model = dataclasses.replace(
        base,
        energy_model=PrescribedTemperatureModel(
            T_profile=lambda z, t: 285.0 + 2.0 * z + 0.0 * t
        ),
    )
    grid = make_function_space(model.domain, jnp.float64)
    full = _state()
    Y = {"soil": {k: full["soil"][k] for k in ("vartheta_l", "theta_i")}}
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 5.0, 8

    from landhydrology.models.soil.rhs import make_update_aux

    rhs = make_rhs(model, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for i in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_with_most_forcing():
    """Monin-Obukhov atmospheric forcing traced inside the segment matches
    the step-by-step loop."""
    from landhydrology import PrescribedAtmosForcing
    import dataclasses

    base = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    bc = dataclasses.replace(
        base.boundary_conditions,
        top=PrescribedAtmosForcing(
            u_atm=0.34, theta_atm=299.0, z_atm=0.05, theta_scale=299.0,
            rho_a_sfc=1.17, q_atm=0.015,
        ),
    )
    model = dataclasses.replace(base, boundary_conditions=bc)
    grid = make_function_space(model.domain, jnp.float64)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 20.0, 4

    rhs = make_rhs(model, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for i in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(Yr["soil"][k]),
            rtol=1e-12, err_msg=k,
        )


def test_segment_lateral_coupling_on_2d_batch_matches_scan():
    """The segment runs on the whole ``(nz, nx, ny)`` arrays, so
    cross-column lateral coupling and 2-D column batches run inside it and
    match the step-by-step loop."""
    import dataclasses

    from landhydrology.models.soil.model import LateralSurfaceCoupling

    base = _model(VerticalFlux(0.0), FreeDrainage())
    model = dataclasses.replace(
        base,
        domain=dataclasses.replace(base.domain, batch_shape=(16, 16)),
        lateral_coupling=LateralSurfaceCoupling(conductance=1e-5, dx=1.0),
    )
    grid = make_function_space(model.domain, jnp.float64)
    Y = jax.tree_util.tree_map(lambda v: v.reshape(NZ, 16, 16), _state())
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 5.0, 6

    rhs = make_rhs(model, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    Yp = make_segment_run(model, stepper, dt=dt, steps_per_call=n)(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(Yr["soil"][k]),
            rtol=1e-12, atol=1e-16, err_msg=k,
        )


def test_segment_land_model_matches_scan():
    """The flagship LandModel config — rain + pond + MOST evaporation +
    coupled energy — runs inside the segment and matches the XLA scan path
    on both the soil column state and the pond."""
    import dataclasses

    from landhydrology import PrescribedAtmosForcing
    from landhydrology.models.land import (
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
        make_rhs as make_land_rhs,
    )

    base = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    soil = dataclasses.replace(
        base,
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
    )
    rain, t_rain = 6e-6, 40.0
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: jnp.where(t < t_rain, rain, 0.0),
            tau_pond=120.0,
            h_evap_smoothing=1e-4,
        ),
    )

    def ic(z, m):
        shape = (NZ, NCOL)
        col = jnp.linspace(0.0, 1.0, NCOL)[None, :]
        th = jnp.broadcast_to(0.18 + 0.05 * col, shape)
        ti = jnp.zeros(shape)
        T = jnp.broadcast_to(290.0 + 2.0 * col + 0.0 * z, shape)
        rcs = volumetric_heat_capacity(th, ti, m.soil_param_set.rho_c_ds, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = land_init(land, ic, 0.0, h_s0=0.0)
    dt, n = 2.0, 24
    stepper = SSPRK33()
    rhs = make_land_rhs(land)

    @jax.jit
    def ref(Y):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, jnp.asarray(0.0)), None, length=n)
        return Yf

    Yr = ref(Y)
    Yk = make_segment_run(land, stepper, dt=dt, steps_per_call=n)(Y, 0.0)

    assert float(jnp.max(Yr["surface"]["h_s"])) > 1e-6  # pond actually formed
    np.testing.assert_allclose(
        np.asarray(Yk["surface"]["h_s"]), np.asarray(Yr["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yk["soil"][k]), np.asarray(Yr["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


def test_segment_land_model_routing_and_column_rain_match_scan():
    """Cross-column pond routing and per-column rain arrays run inside the
    segment (it holds the whole batch) and match the XLA scan path."""
    import dataclasses

    from landhydrology.models.land import (
        LandModel,
        RunoffRouting,
        SurfaceWaterModel,
        make_rhs as make_land_rhs,
    )

    flat = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    base = dataclasses.replace(
        flat, domain=dataclasses.replace(flat.domain, batch_shape=(16, 16))
    )
    rain = jnp.linspace(0.0, 2e-5, NCOL).reshape(16, 16)
    land = LandModel(soil=base, surface=SurfaceWaterModel(
        precipitation=lambda t: rain, tau_pond=120.0,
        runoff=RunoffRouting(conductance=1e-3, dx=10.0)))
    grid = make_function_space(base.domain, jnp.float64)
    Y = jax.tree_util.tree_map(lambda v: v.reshape(NZ, 16, 16), _state())
    Y["surface"] = {"h_s": jnp.linspace(0.0, 1e-3, NCOL).reshape(16, 16)}
    Ya = {"zc": grid.zc, "soil": {}}
    stepper, dt, n = SSPRK33(), 2.0, 8

    rhs = make_land_rhs(land, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    Yk = make_segment_run(land, stepper, dt=dt, steps_per_call=n)(Y, 0.0)
    np.testing.assert_allclose(
        np.asarray(Yk["surface"]["h_s"]), np.asarray(Yr["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yk["soil"][k]), np.asarray(Yr["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


# ---- implicit steppers inside the segment ----


def _implicit_reference(model, stepper, Y, Ya, dt, n):
    rhs = make_rhs(model, make_function_space(model.domain, jnp.float64))
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt
    return Yr


def test_segment_backward_euler_matches_scan():
    """BackwardEulerSoil (Newton + unrolled Thomas tridiagonal) runs inside
    the segment at dt far beyond the explicit CFL and matches the XLA path
    exactly (same trace)."""
    from landhydrology.imex import BackwardEulerSoil

    model = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    grid = make_function_space(model.domain, jnp.float64)
    stepper = BackwardEulerSoil(model=model, grid=grid, iters=2)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    dt, n = 600.0, 4

    Yr = _implicit_reference(model, stepper, Y, Ya, dt, n)
    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_trbdf2_stiff_infiltration_matches_scan():
    """TR-BDF2 on the stiff sand-infiltration config (Dirichlet top — the
    boundary-face Jacobian boost path — + FreeDrainage bottom) through the
    segment: the reference's stiffest regime (``richards_equation.jl:131``,
    dt=0.25 s explicit) at 20x the explicit CFL, segment == XLA."""
    import dataclasses

    from landhydrology import PrescribedTemperatureModel
    from landhydrology.imex import TRBDF2Soil

    hm = vanGenuchten(
        n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075
    )
    base = _model(Dirichlet(lambda t: 0.267), FreeDrainage())
    model = dataclasses.replace(
        base,
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=dataclasses.replace(
            base.hydrology_model, hydraulic_model=hm
        ),
        soil_param_set=dataclasses.replace(
            base.soil_param_set, nu=0.287
        ),
    )
    grid = make_function_space(model.domain, jnp.float64)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=2)
    Y = {
        "soil": {
            "vartheta_l": jnp.full((NZ, NCOL), 0.1, dtype=jnp.float64),
            "theta_i": jnp.zeros((NZ, NCOL), dtype=jnp.float64),
        }
    }
    Ya = {"zc": grid.zc, "soil": {}}
    dt, n = 5.0, 4

    Yr = _implicit_reference(model, stepper, Y, Ya, dt, n)
    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    assert np.all(np.isfinite(np.asarray(Yp["soil"]["vartheta_l"])))
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_trbdf2_heterogeneous_params():
    """TR-BDF2 segment with per-column van Genuchten/porosity arrays: the
    implicit assembly reads the stepper's model, which the segment's rebind
    keeps pointing at the per-column parameters."""
    import dataclasses

    from landhydrology.imex import TRBDF2Soil

    rng = np.random.default_rng(7)
    base = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    hm_b = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.8, 3.0, NCOL)),
        alpha=jnp.asarray(rng.uniform(1.5, 4.0, NCOL)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-5, NCOL)),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.05, NCOL)),
    )
    model = dataclasses.replace(
        base,
        hydrology_model=dataclasses.replace(
            base.hydrology_model, hydraulic_model=hm_b
        ),
        soil_param_set=dataclasses.replace(
            base.soil_param_set, nu=jnp.asarray(rng.uniform(0.45, 0.55, NCOL))
        ),
    )
    grid = make_function_space(model.domain, jnp.float64)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=2)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    dt, n = 300.0, 4

    Yr = _implicit_reference(model, stepper, Y, Ya, dt, n)
    run = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n
    )
    Yp = run(Y, 0.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]),
            np.asarray(Yr["soil"][k]),
            rtol=1e-12,
            atol=1e-16,
            err_msg=k,
        )


def test_segment_trbdf2_pcr_matches_thomas():
    """The PCR tridiagonal backend (latency-parallel over nz) through the
    segment converges to the same implicit step as the Thomas backend
    (the Newton fixed point is set by the rhs, not the linear solver)."""
    from landhydrology.imex import TRBDF2Soil

    model = _model(VerticalFlux(0.0), VerticalFlux(0.0))
    grid = make_function_space(model.domain, jnp.float64)
    Y = _state()
    Ya = {"zc": grid.zc, "soil": {}}
    dt, n = 600.0, 2

    outs = {}
    for solver in ("thomas", "pcr"):
        stepper = TRBDF2Soil(model=model, grid=grid, iters=3, tridiag=solver)
        run = make_segment_run(
            model, stepper, dt=dt, steps_per_call=n
        )
        outs[solver] = run(Y, 0.0)
        # each backend matches its own XLA trace exactly
        Yr = _implicit_reference(model, stepper, Y, Ya, dt, n)
        for k in Y["soil"]:
            np.testing.assert_allclose(
                np.asarray(outs[solver]["soil"][k]),
                np.asarray(Yr["soil"][k]),
                rtol=1e-12, atol=1e-16, err_msg=f"{solver}/{k}",
            )
    # and the two backends agree to Newton-converged tolerance
    for k in Y["soil"]:
        a = np.asarray(outs["thomas"]["soil"][k])
        b = np.asarray(outs["pcr"]["soil"][k])
        scale = np.max(np.abs(a)) or 1.0
        assert np.max(np.abs(a - b)) / scale < 1e-9, k
