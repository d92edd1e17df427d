"""Implicit (backward-Euler + Picard/Newton) Richards stepping tests:
unconditional stability at time steps far beyond the explicit CFL limit,
converging to the same hydrostatic equilibrium as the explicit path."""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    PrescribedTemperatureModel,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    initialize_states,
)
from landhydrology.domains import make_function_space
from landhydrology.imex import BackwardEulerRichards
from landhydrology.models.soil import vanGenuchten


def _expected_equilibrium(z, z_interface, nu, S_s=1e-3, alpha=2.6, n=2.0, m=0.5):
    z = np.asarray(z)
    unsat = nu * (1 + (alpha * (z - z_interface)) ** n) ** (-m)
    sat = -S_s * (z - z_interface) + nu
    return np.where(z < z_interface, sat, unsat)


@pytest.mark.slow
def test_implicit_richards_large_dt_equilibrium():
    """dt = 3000 s (30x the explicit test's dt=100) reaches the same
    hydrostatic equilibrium (cf. ``richards_equation.jl:1-95``)."""
    nu, S_s = 0.495, 1e-3
    model = SoilModel(
        domain=Column(zlim=(-10.0, 0.0), nelements=50),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=nu, S_s=S_s),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full_like(z, 0.494),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    stepper = BackwardEulerRichards(model=model, grid=grid, iters=3)
    tf = 60.0 * 60.0 * 24.0 * 36.0
    sim = Simulation(
        model, stepper, Y_init=Y, Ya_init=Ya, dt=3000.0, tspan=(0.0, tf)
    )
    sim.run()

    z = np.asarray(Ya["zc"]).ravel()
    vf = np.asarray(sim.Y["soil"]["vartheta_l"])
    err = vf - _expected_equilibrium(z, -0.56, nu)
    assert np.all(np.isfinite(vf))
    assert np.sqrt(np.mean(err) ** 2) < 1e-4
    assert np.sqrt(np.mean(err**2)) < 5e-3

    # mass conserved through the implicit update (zero-flux BCs)
    m0 = float(np.sum(np.asarray(Y["soil"]["vartheta_l"])))
    mf = float(np.sum(vf))
    assert abs(mf - m0) / m0 < 1e-10


def test_implicit_matches_explicit_short_horizon():
    """Implicit dt=2 vs explicit dt=0.25 on stiff sand infiltration over a
    short horizon: profiles agree to solver tolerance."""
    from landhydrology import Dirichlet, FreeDrainage
    from landhydrology.timestepping import SSPRK33

    hm = vanGenuchten(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075)
    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=150),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full_like(z, 0.1),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    tf = 60.0

    sim_ex = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.25, tspan=(0.0, tf)
    )
    sim_ex.run()
    sim_im = Simulation(
        model,
        BackwardEulerRichards(model=model, grid=grid, iters=3),
        Y_init=Y,
        Ya_init=Ya,
        dt=2.0,
        tspan=(0.0, tf),
    )
    sim_im.run()

    v_ex = np.asarray(sim_ex.Y["soil"]["vartheta_l"])
    v_im = np.asarray(sim_im.Y["soil"]["vartheta_l"])
    assert np.all(np.isfinite(v_im))
    # first-order implicit vs third-order explicit: agree to O(dt) accuracy
    assert np.max(np.abs(v_ex - v_im)) < 5e-3


def test_backward_euler_soil_coupled():
    """Fully implicit coupled step (water Newton + linear heat tridiag) at
    dt far beyond both CFL limits relaxes toward the same coupled
    equilibrium as the explicit path (shortened horizon)."""
    from landhydrology import SoilEnergyModel
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.imex import BackwardEulerSoil
    from landhydrology.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        temperature_from_rho_e_int,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.timestepping import SSPRK33

    nu = 0.5
    ks = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    rho_c_ds = (1 - nu) * 1.926e6
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.92,
        rho_c_ds=rho_c_ds,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, nu, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=20),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
    )

    def ic(z, m):
        T = 289.0 + 5.0 * z
        theta = jnp.full_like(z, 0.45)
        ti = jnp.zeros_like(z)
        rcs = volumetric_heat_capacity(theta, ti, rho_c_ds, ps)
        return {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    grid = make_function_space(model.domain, jnp.float64)
    tf = 3600.0 * 24.0

    sim_ex = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=20.0,
                        tspan=(0.0, tf))
    sim_ex.run()
    sim_im = Simulation(
        model,
        BackwardEulerSoil(model=model, grid=grid, iters=3),
        Y_init=Y,
        Ya_init=Ya,
        dt=600.0,  # 30x the explicit dt
        tspan=(0.0, tf),
    )
    sim_im.run()

    v_ex = np.asarray(sim_ex.Y["soil"]["vartheta_l"])
    v_im = np.asarray(sim_im.Y["soil"]["vartheta_l"])
    e_ex = np.asarray(sim_ex.Y["soil"]["rho_e_int"])
    e_im = np.asarray(sim_im.Y["soil"]["rho_e_int"])
    assert np.all(np.isfinite(v_im)) and np.all(np.isfinite(e_im))
    assert np.max(np.abs(v_ex - v_im)) < 2e-3
    # temperatures agree to ~0.05 K
    rcs = volumetric_heat_capacity(v_ex, 0.0, rho_c_ds, ps)
    T_ex = np.asarray(temperature_from_rho_e_int(e_ex, 0.0, rcs, ps))
    rcs_i = volumetric_heat_capacity(v_im, 0.0, rho_c_ds, ps)
    T_im = np.asarray(temperature_from_rho_e_int(e_im, 0.0, rcs_i, ps))
    assert np.max(np.abs(T_ex - T_im)) < 0.05
    # conservation through both implicit solves
    assert abs(v_im.sum() - v_ex.sum()) / v_ex.sum() < 1e-10
    assert abs(e_im.sum() - e_ex.sum()) / abs(e_ex.sum()) < 1e-8


def test_implicit_with_temperature_dependent_viscosity():
    """Regression: BackwardEulerSoil with TemperatureDependentViscosity and
    a dynamic energy model must diagnose T from rho_e_int (was KeyError)."""
    from landhydrology import SoilEnergyModel
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.imex import BackwardEulerSoil
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.water import TemperatureDependentViscosity

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=12),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0),
            viscosity_factor=TemperatureDependentViscosity(),
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
    )

    def ic(z, m):
        theta = jnp.full_like(z, 0.25)
        ti = jnp.zeros_like(z)
        T = 285.0 + 3.0 * z
        rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    grid = make_function_space(model.domain, jnp.float64)
    sim = Simulation(
        model,
        BackwardEulerSoil(model=model, grid=grid, iters=2),
        Y_init=Y,
        Ya_init=Ya,
        dt=300.0,
        tspan=(0.0, 6000.0),
    )
    sim.run()
    assert np.all(np.isfinite(np.asarray(sim.Y["soil"]["vartheta_l"])))
    assert np.all(np.isfinite(np.asarray(sim.Y["soil"]["rho_e_int"])))


# ---- TR-BDF2: second-order implicit stepping (VERDICT r1 item 4) ----


def _stiff_coupled_model():
    """Coupled column with a fully saturated profile: the water equation is
    in the S_s (compressibility) regime with diffusivity K/S_s, ~100x
    stiffer than unsaturated Richards and smooth (no saturation-interface
    kink), so formal temporal order is observable."""
    from landhydrology import SoilEnergyModel

    return SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=20),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.495, S_s=1e-3, rho_c_ds=1.3e6),
    )


def _stiff_coupled_state(model):
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    def ic(z, m):
        th = 0.4965 + 0.001 * jnp.sin(np.pi * z)
        ti = jnp.zeros_like(z)
        T = 285.0 + 3.0 * jnp.cos(np.pi * z / 2)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th + 0 * z,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    return initialize_states(model, ic, 0.0)


def _run_fixed(rhs, Ya, stepper, Y, dt, tf):
    import jax

    @jax.jit
    def go(Y):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.float64(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(
            body, (Y, jnp.float64(0.0)), None, length=int(round(tf / dt))
        )
        return Yf

    return go(Y)


@pytest.mark.slow
def test_trbdf2_second_order_at_30x_cfl():
    """Temporal self-convergence of TR-BDF2 on the stiff coupled column:
    order -> 2 with the coarsest dt ~30x the explicit CFL limit, and the
    same study shows backward Euler at order 1 (the improvement TR-BDF2
    buys)."""
    from landhydrology.diagnostics import explicit_dt_limit
    from landhydrology.imex import BackwardEulerSoil, TRBDF2Soil
    from landhydrology.models.soil.rhs import make_rhs

    model = _stiff_coupled_model()
    Y, Ya = _stiff_coupled_state(model)
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)

    tf = 12000.0
    dt_limit = float(explicit_dt_limit(model, Y))
    assert tf / 4 > 29.0 * dt_limit  # the coarsest step is ~30x CFL

    def errs_for(stepper_cls, iters):
        ref = _run_fixed(
            rhs, Ya, stepper_cls(model=model, grid=grid, iters=6), Y,
            tf / 512, tf,
        )
        out = []
        for n in (4, 8, 16, 32):
            st = stepper_cls(model=model, grid=grid, iters=iters)
            Yn = _run_fixed(rhs, Ya, st, Y, tf / n, tf)
            e = max(
                float(
                    jnp.max(
                        jnp.abs(
                            Yn["soil"]["vartheta_l"] - ref["soil"]["vartheta_l"]
                        )
                    )
                ),
                float(
                    jnp.max(
                        jnp.abs(Yn["soil"]["rho_e_int"] - ref["soil"]["rho_e_int"])
                    )
                )
                / 2e6,
            )
            out.append(e)
        return out

    errs2 = errs_for(TRBDF2Soil, 3)
    orders2 = [np.log2(errs2[i] / errs2[i + 1]) for i in range(3)]
    assert orders2[-1] > 1.85, (errs2, orders2)
    assert all(o > 1.6 for o in orders2), (errs2, orders2)

    errs1 = errs_for(BackwardEulerSoil, 3)
    orders1 = [np.log2(errs1[i] / errs1[i + 1]) for i in range(3)]
    assert all(o < 1.4 for o in orders1), (errs1, orders1)  # BE is O(dt)
    # in the asymptotic range (finest dt) order 2 has pulled clearly ahead
    assert errs2[-1] < 0.5 * errs1[-1], (errs2[-1], errs1[-1])


def test_trbdf2_richards_only_matches_be_limit():
    """TR-BDF2 on a water-only (PrescribedTemperature) model: stable at
    large dt, conserves mass, and converges to the same state as backward
    Euler as dt -> 0."""
    from landhydrology.imex import BackwardEulerRichards, TRBDF2Soil
    from landhydrology.models.soil.rhs import make_rhs

    nu = 0.43
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=15),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.0)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=nu, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": 0.25 + 0.05 * jnp.sin(np.pi * z) + 0 * z,
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)

    tr = TRBDF2Soil(model=model, grid=grid, iters=3)
    Yt = _run_fixed(rhs, Ya, tr, Y, 600.0, 6000.0)
    vt = np.asarray(Yt["soil"]["vartheta_l"])
    assert np.all(np.isfinite(vt))
    m0 = float(np.sum(np.asarray(Y["soil"]["vartheta_l"])))
    assert abs(float(np.sum(vt)) - m0) / m0 < 1e-12

    be = BackwardEulerRichards(model=model, grid=grid, iters=3)
    Yb = _run_fixed(rhs, Ya, be, Y, 60.0, 6000.0)
    np.testing.assert_allclose(
        vt, np.asarray(Yb["soil"]["vartheta_l"]), atol=5e-5
    )


def test_adaptive_uses_trbdf2_order():
    """run_adaptive derives its PI exponents from the stepper's order and
    integrates the stiff column with TR-BDF2 at steps far beyond the
    explicit CFL."""
    from landhydrology.adaptive import AdaptiveConfig, run_adaptive
    from landhydrology.diagnostics import explicit_dt_limit
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil.rhs import make_rhs

    model = _stiff_coupled_model()
    Y, Ya = _stiff_coupled_state(model)
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=3)
    assert stepper.order == 2

    dt_limit = float(explicit_dt_limit(model, Y))
    tf = 6000.0
    Yf, stats = run_adaptive(
        rhs, Y, Ya, 0.0, tf, dt0=300.0, stepper=stepper,
        config=AdaptiveConfig(rtol=1e-6, atol=1e-10),
    )
    assert bool(stats["converged"])
    assert np.all(np.isfinite(np.asarray(Yf["soil"]["vartheta_l"])))
    # the controller keeps dt far beyond the explicit limit
    assert float(stats["dt_final"]) > 2.0 * dt_limit

    ref = _run_fixed(
        rhs, Ya, TRBDF2Soil(model=model, grid=grid, iters=4), Y, tf / 256, tf
    )
    np.testing.assert_allclose(
        np.asarray(Yf["soil"]["vartheta_l"]),
        np.asarray(ref["soil"]["vartheta_l"]),
        atol=1e-5,
    )


def test_trbdf2_stages_counts_rhs_evaluations():
    """The ``stages`` contract is 'rhs evaluations per step' (ADVICE r2):
    1 up-front f(u^n) + 2 stages x iters sweeps x active components."""
    import dataclasses

    from landhydrology import (
        PrescribedHydrologyModel,
        PrescribedTemperatureModel,
    )
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil.freeze_thaw import FreezeThaw

    model = _stiff_coupled_model()
    grid = make_function_space(model.domain, model.float_dtype)
    assert TRBDF2Soil(model=model, grid=grid, iters=3).stages == 1 + 2 * 3 * 2
    assert TRBDF2Soil(model=model, grid=grid, iters=2).stages == 1 + 2 * 2 * 2
    water_only = dataclasses.replace(
        model, energy_model=PrescribedTemperatureModel()
    )
    assert TRBDF2Soil(model=water_only, grid=grid, iters=3).stages == 1 + 2 * 3
    ft = dataclasses.replace(model, freeze_thaw=FreezeThaw(tau=600.0))
    assert TRBDF2Soil(model=ft, grid=grid, iters=2).stages == 1 + 2 * 2 * 3
