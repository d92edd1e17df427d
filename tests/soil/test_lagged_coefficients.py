"""Lagged-coefficient stepping (``SoilModel(coefficient_update="step")``):
validation, stage-level equivalence of the coefficient-parametrized rhs,
measured first-order accuracy of the splitting, exact conservation, and
engine agreement (XLA scan / segment runner / pjit) — the step-level policy
machinery mirroring ``LandModel(surface_update="step")``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    Simulation,
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
from landhydrology.models.soil.lagged import (
    LaggedCoefficientStepper,
    make_coefficient_fns,
    wrap_stepper_for_soil,
)
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.segment import make_segment_run
from landhydrology.timestepping import SSPRK33, ForwardEuler

NZ, NCOL = 16, 8


def _coupled(coefficient_update="stage", **kw):
    return SoilModel(
        domain=Column(zlim=(-1.2, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6,
                                         theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=Dirichlet(lambda t: 0.30),
                energy=Dirichlet(lambda t: 288.0),
            ),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        coefficient_update=coefficient_update,
        **kw,
    )


def _ic(z, m):
    shape = (NZ, NCOL)
    th = jnp.broadcast_to(
        0.14 + 0.1 * jnp.linspace(0.0, 1.0, NCOL)[None, :], shape
    ) + 0.05 * jnp.exp(jnp.broadcast_to(z, shape) / 0.3)
    ti = jnp.zeros(shape)
    T = jnp.full(shape, 286.0) + 3.0 * jnp.broadcast_to(z, shape)
    rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
    return {
        "vartheta_l": th,
        "theta_i": ti,
        "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
    }


def test_validation_and_config_roundtrip():
    from landhydrology.config import from_config, to_config

    with pytest.raises(ValueError, match="coefficient_update"):
        _coupled(coefficient_update="sometimes")

    def serializable(cu):
        # lambda-valued Dirichlet BCs don't serialize; flux BCs do
        return dataclasses.replace(
            _coupled(coefficient_update=cu),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
                bottom=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
            ),
        )

    m = serializable("step")
    assert from_config(to_config(m)).coefficient_update == "step"
    assert from_config(to_config(serializable("stage"))).coefficient_update \
        == "stage"
    # the fully prescribed model has nothing to lag
    prescribed = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=8),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=PrescribedHydrologyModel(),
        boundary_conditions=None,
        coefficient_update="step",
    )
    with pytest.raises(ValueError, match="dynamic"):
        make_coefficient_fns(prescribed)


@pytest.mark.parametrize("variant", ["coupled", "richards", "heat", "no_ice"])
def test_rhs_with_coefficients_matches_stage_rhs(variant):
    """rhs_with_coeffs(compute_coeffs(Y), Y) == make_rhs(model)(Y) up to
    the reciprocal-multiply temperature diagnosis (ulp-level): lagging
    changes WHEN coefficients are evaluated, not WHAT the tendency is."""
    if variant == "richards":
        model = dataclasses.replace(
            _coupled(), energy_model=PrescribedTemperatureModel(),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.30)),
                bottom=SoilComponentBC(hydrology=FreeDrainage()),
            ),
        )
    elif variant == "heat":
        model = dataclasses.replace(
            _coupled(),
            hydrology_model=PrescribedHydrologyModel(
                vartheta_l_profile=lambda z, t: jnp.full_like(z, 0.2),
                theta_i_profile=lambda z, t: jnp.zeros_like(z),
            ),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(energy=Dirichlet(lambda t: 288.0)),
                bottom=SoilComponentBC(energy=VerticalFlux(0.0)),
            ),
        )
    elif variant == "no_ice":
        model = _coupled(assume_no_ice=True)
    else:
        model = _coupled()

    Y, Ya = initialize_states(model, _ic, 0.0)
    compute_coeffs, rhs_c = make_coefficient_fns(model)
    C = compute_coeffs(Y, Ya, 0.0)
    dY_lag = rhs_c(C, Y, Ya, 0.0)
    dY_ref = make_rhs(model)(Y, Ya, 0.0)
    for k in dY_ref["soil"]:
        a, b = np.asarray(dY_lag["soil"][k]), np.asarray(dY_ref["soil"][k])
        scale = np.max(np.abs(b)) or 1.0
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=f"{variant}/{k}")


def test_lagged_first_order():
    """The lagged-coefficient deviation from stage-level semantics is
    first order in dt at fixed final time (the splitting class shared with
    surface_update='step'), and far below the state scale at operating
    dt."""
    tf = 96.0
    model_stage = _coupled()
    model_step = _coupled(coefficient_update="step")
    Y0, Ya = initialize_states(model_stage, _ic, 0.0)

    def run(model, dt):
        stepper = wrap_stepper_for_soil(SSPRK33(), model)
        rhs = make_rhs(model)

        @jax.jit
        def go(Y):
            def body(carry, _):
                Yc, t = carry
                return (
                    stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt
                ), None

            (Yf, _), _ = jax.lax.scan(
                body, (Y, jnp.asarray(0.0)), None, length=int(round(tf / dt))
            )
            return Yf

        return go(Y0)

    def dev(dt):
        Ys = run(model_stage, dt)
        Yl = run(model_step, dt)
        return max(
            float(jnp.max(jnp.abs(Ys["soil"][k] - Yl["soil"][k])))
            / float(jnp.max(jnp.abs(Ys["soil"][k])) + 1e-30)
            for k in ("vartheta_l", "rho_e_int")
        )

    d4, d2, d1 = dev(4.0), dev(2.0), dev(1.0)
    assert d4 > 0.0  # the flag genuinely changes the trajectory
    assert 1.5 < d4 / d2 < 2.7, (d4, d2, d1)
    assert 1.5 < d2 / d1 < 2.7, (d4, d2, d1)
    assert d2 < 1e-5, d2  # far below the state scale at operating dt


def test_lagged_conserves_mass_exactly():
    """The lagged rhs stays in exact flux form: with zero-flux BCs the
    column water and energy totals are constant to roundoff over a lagged
    run (conservation does not depend on when coefficients are
    evaluated)."""
    closed = dataclasses.replace(
        _coupled(coefficient_update="step"),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
    )
    Y0, Ya = initialize_states(closed, _ic, 0.0)
    sim = Simulation(closed, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=2.0,
                     tspan=(0.0, 400.0))
    assert isinstance(sim.stepper, LaggedCoefficientStepper)  # policy applied
    sim.run()
    for k in ("vartheta_l", "rho_e_int"):
        tot0 = float(jnp.sum(Y0["soil"][k]))
        tot1 = float(jnp.sum(sim.Y["soil"][k]))
        assert tot1 == pytest.approx(tot0, rel=1e-12), k


def test_lagged_forward_euler_matches_stage():
    """A single-stage stepper evaluates the rhs exactly once per step, at
    the state the coefficients were computed from — lagging must then
    reproduce the stage-level trajectory to the reciprocal-multiply ulp
    (pins the wiring: wrapper applied, rhs ignored, same tendency)."""
    model = _coupled()
    model_l = _coupled(coefficient_update="step")
    Y0, Ya = initialize_states(model, _ic, 0.0)
    kw = dict(Y_init=Y0, Ya_init=Ya, dt=1.0, tspan=(0.0, 60.0))
    sim_s = Simulation(model, ForwardEuler(), **kw)
    sim_s.run()
    sim_l = Simulation(model_l, ForwardEuler(), **kw)
    sim_l.run()
    for k in Y0["soil"]:
        a, b = np.asarray(sim_l.Y["soil"][k]), np.asarray(sim_s.Y["soil"][k])
        scale = np.max(np.abs(b)) or 1.0
        np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-11 * scale,
                                   err_msg=k)


def test_lagged_engines_agree():
    """XLA scan, the segment runner, and pjit produce the same lagged
    trajectory (the policy is enforced inside every engine, not silently
    dropped by any of them) — and it differs from the stage trajectory."""
    model = _coupled(coefficient_update="step")
    Y0, Ya = initialize_states(model, _ic, 0.0)
    kw = dict(Y_init=Y0, Ya_init=Ya, dt=2.0, tspan=(0.0, 96.0))
    sim_x = Simulation(model, SSPRK33(), **kw)
    sim_x.run()
    Yp = make_segment_run(
        model, SSPRK33(), dt=kw["dt"], steps_per_call=48
    )(kw["Y_init"], 0.0)

    from landhydrology.parallel import make_column_mesh
    from landhydrology.parallel.stepping import make_sharded_run

    ndev = min(len(jax.devices()), 8)
    mesh = make_column_mesh(shape=(ndev,), axis_names=("columns",))
    run = make_sharded_run(model, mesh, SSPRK33(), dt=2.0, n_steps=48,
                           mode="pjit")
    Yj, _ = run(Y0, Ya, jnp.asarray(0.0))

    sim_stage = Simulation(_coupled(), SSPRK33(), **kw)
    sim_stage.run()

    for k in Y0["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=f"segment/{k}")
        np.testing.assert_allclose(
            np.asarray(Yj["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=f"pjit/{k}")
    dev = float(jnp.max(jnp.abs(sim_stage.Y["soil"]["vartheta_l"]
                                - sim_x.Y["soil"]["vartheta_l"])))
    assert 0.0 < dev < 1e-3, dev


def test_lagged_composes_with_land():
    """LandModel with soil.coefficient_update='step': the land policy
    stepper freezes the soil coefficients too, identically in Simulation
    and the segment runner."""
    from landhydrology import PrescribedAtmosForcing
    from landhydrology.models.land import (
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
    )

    soil = dataclasses.replace(
        _coupled(coefficient_update="step"),
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
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: jnp.where(t < 30.0, 8e-6, 0.0),
            tau_pond=120.0,
        ),
    )
    Y0, Ya = land_init(land, _ic, 0.0, h_s0=0.0)
    kw = dict(Y_init=Y0, Ya_init=Ya, dt=2.0, tspan=(0.0, 48.0))
    sim_x = Simulation(land, SSPRK33(), **kw)
    sim_x.run()
    Yp = make_segment_run(
        land, SSPRK33(), dt=kw["dt"], steps_per_call=24
    )(kw["Y_init"], 0.0)

    land_stage = dataclasses.replace(
        land, soil=dataclasses.replace(soil, coefficient_update="stage")
    )
    sim_s = Simulation(land_stage, SSPRK33(), **kw)
    sim_s.run()

    for k in Y0["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k)
    np.testing.assert_allclose(
        np.asarray(Yp["surface"]["h_s"]),
        np.asarray(sim_x.Y["surface"]["h_s"]), rtol=1e-12, atol=1e-18)
    dev = float(jnp.max(jnp.abs(sim_s.Y["soil"]["vartheta_l"]
                                - sim_x.Y["soil"]["vartheta_l"])))
    assert dev > 0.0  # the policy is real on the land path too
