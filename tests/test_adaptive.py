"""Adaptive step-doubling integration tests: accuracy vs a fine fixed-dt
reference, efficiency (far fewer steps than the fixed CFL-bound dt), and
jit-compatibility of the while_loop control."""

import jax
import jax.numpy as jnp
import numpy as np

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology.adaptive import AdaptiveConfig, run_adaptive
from landhydrology.domains import make_function_space
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.timestepping import SSPRK33


def _infiltration_model():
    hm = vanGenuchten(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075)
    return SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=150),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
    )


def test_adaptive_matches_fixed_fine_dt():
    model = _infiltration_model()
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full_like(z, 0.1),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    stepper = SSPRK33()
    tf = 120.0

    # fixed fine-dt reference
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(int(tf / 0.05)):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(0.05))
        t = t + 0.05

    run = jax.jit(
        lambda Y: run_adaptive(
            rhs, Y, Ya, 0.0, tf, dt0=0.01, stepper=stepper,
            config=AdaptiveConfig(rtol=1e-6, atol=1e-9),
        )
    )
    Ya_f, stats = run(Y)
    v_ref = np.asarray(Yr["soil"]["vartheta_l"])
    v_ad = np.asarray(Ya_f["soil"]["vartheta_l"])
    assert np.all(np.isfinite(v_ad))
    assert np.max(np.abs(v_ad - v_ref)) < 5e-4

    n_acc = int(stats["n_accepted"])
    n_rej = int(stats["n_rejected"])
    # fewer accepted steps than the 2400 fine-dt steps, some dt growth
    assert n_acc < 2400
    assert float(stats["dt_final"]) > 0.01
    assert n_rej < n_acc  # controller not thrashing


def test_adaptive_handles_stiffness_without_blowup():
    """The saturated-compressibility config that destroys fixed-dt explicit
    runs (see explicit_dt_limit): the controller shrinks dt and survives."""
    from landhydrology import VerticalFlux
    from landhydrology.models.soil.water import hydrostatic_profile

    hm = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=40),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=Dirichlet(
                    lambda t: hydrostatic_profile(
                        hm, jnp.asarray(-2.0), -0.5, 0.45, 1e-3
                    )
                )
            ),
        ),
        soil_param_set=SoilParams(nu=0.45, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": hydrostatic_profile(hm, z, -0.5, 0.45, 1e-3),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    # start with a dt 40x beyond the CFL limit (~0.15 s): fixed-dt SSPRK33
    # diverges here (verified in round-1 verification); adaptive must not
    Yf, stats = jax.jit(
        lambda Y: run_adaptive(rhs, Y, Ya, 0.0, 60.0, dt0=6.0)
    )(Y)
    v = np.asarray(Yf["soil"]["vartheta_l"])
    assert np.all(np.isfinite(v))
    drift = np.max(np.abs(v - np.asarray(Y["soil"]["vartheta_l"])))
    assert drift < 1e-5  # held the equilibrium
    assert float(stats["dt_final"]) < 1.0  # controller found the stiff scale


def _batched_infiltration(ncol=8, nz=40):
    hm = vanGenuchten(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0,
                      theta_r=0.075)
    return SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
    )


def _batched_ic(model):
    nz = model.domain.nelements
    ncol = model.domain.batch_shape[0]
    return initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full((nz, ncol), 0.1)
            + 0.02 * jnp.linspace(0.0, 1.0, ncol)[None, :],
            "theta_i": jnp.zeros((nz, ncol)),
        },
        0.0,
    )


def test_adaptive_fused_spc1_reduces_to_run_adaptive():
    """With steps_per_call=1 the macro-step IS one step-doubled step:
    run_adaptive_fused must reproduce run_adaptive's trajectory AND its
    controller decisions (accept counts) on the same problem — pins the
    wiring of the traced-dt segment + segment controller."""
    from landhydrology.adaptive import run_adaptive_fused

    model = _batched_infiltration()
    Y, Ya = _batched_ic(model)
    rhs = make_rhs(model)
    cfg = AdaptiveConfig(rtol=1e-5, atol=1e-8)
    tf = 30.0

    Yx, sx = jax.jit(
        lambda Y: run_adaptive(rhs, Y, Ya, 0.0, tf, dt0=0.05,
                               stepper=SSPRK33(), config=cfg)
    )(Y)
    Yf, sf = run_adaptive_fused(
        model, Y, Ya, 0.0, tf, dt0=0.05, stepper=SSPRK33(), config=cfg,
        steps_per_call=1,
    )
    assert bool(sf["converged"]) and bool(sx["converged"])
    assert int(sf["n_accepted"]) == int(sx["n_accepted"])
    assert int(sf["n_rejected"]) == int(sx["n_rejected"])
    np.testing.assert_allclose(
        np.asarray(Yf["soil"]["vartheta_l"]),
        np.asarray(Yx["soil"]["vartheta_l"]), rtol=1e-10, atol=1e-14,
    )


def test_adaptive_fused_segments_match_fine_reference():
    """Segment-granular error control (steps_per_call=6): matches a fine
    fixed-dt reference, converges, and grows dt."""
    from landhydrology.adaptive import run_adaptive_fused

    model = _batched_infiltration()
    Y, Ya = _batched_ic(model)
    rhs = make_rhs(model)
    stepper = SSPRK33()
    tf = 60.0

    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(int(tf / 0.05)):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(0.05))
        t = t + 0.05

    Yf, stats = run_adaptive_fused(
        model, Y, Ya, 0.0, tf, dt0=0.02, stepper=stepper,
        config=AdaptiveConfig(rtol=1e-6, atol=1e-9),
        steps_per_call=6,
    )
    assert bool(stats["converged"])
    v_ref = np.asarray(Yr["soil"]["vartheta_l"])
    v_ad = np.asarray(Yf["soil"]["vartheta_l"])
    assert np.all(np.isfinite(v_ad))
    assert np.max(np.abs(v_ad - v_ref)) < 5e-4
    assert float(stats["dt_final"]) > 0.02  # controller grew the step
    # macro-step accounting: far fewer segments than fine-dt steps
    assert int(stats["n_accepted"]) < tf / 0.05 / 6


def test_adaptive_terminates_on_nan_rhs():
    """A NaN-producing rhs must not hang the while_loop: the iteration cap
    and dt-floor force-accept guarantee termination."""

    def bad_rhs(Y, Ya, t):
        return {"m": {"x": Y["m"]["x"] * jnp.nan}}

    Y0 = {"m": {"x": jnp.ones(4)}}
    Yf, stats = run_adaptive(
        bad_rhs, Y0, {}, 0.0, 10.0, dt0=1.0,
        config=AdaptiveConfig(dt_min=1e-3, max_steps=500),
    )
    # loop returned (no hang); stats expose the failure mode
    assert int(stats["n_accepted"]) + int(stats["n_rejected"]) <= 500


def _tiny_land(surface_update="step"):
    """Minimal LandModel (rain + pond + MOST + energy) for the adaptive
    engine-parity tests: run_adaptive(model=...) and run_adaptive_fused
    must honor the land policy steppers like every other engine."""
    import jax.numpy as jnp

    from landhydrology import (
        PrescribedAtmosForcing,
        SoilEnergyModel,
        VerticalFlux,
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.land import (
        LandModel,
        PulsePrecipitation,
        SurfaceWaterModel,
        initialize_states as land_init,
    )
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    nz, ncol = 8, 8
    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.0, Ksat=1e-5,
                                         theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=PulsePrecipitation(rate=1e-3, t_start=0.0,
                                             t_stop=1e9),
            tau_pond=300.0,
        ),
        surface_update=surface_update,
    )

    def ic(z, m):
        th = jnp.full_like(z, 0.2)
        ti = jnp.zeros_like(z)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full_like(z, 290.0), ps
            ),
        }

    Y, Ya = land_init(land, ic, 0.0)
    return land, Y, Ya


def test_adaptive_land_model_matches_fixed_fine_dt():
    """run_adaptive(model=LandModel(surface_update='step')) applies the
    frozen-exchange policy and lands on the fixed-fine-dt trajectory —
    the 'enforced by every engine' bar for error control on the flagship
    composition."""
    import numpy as np

    from landhydrology.models.land import make_rhs as make_land_rhs
    from landhydrology.simulations import Simulation

    land, Y, Ya = _tiny_land()
    rhs = make_land_rhs(land)
    tf = 120.0
    Yad, stats = run_adaptive(
        rhs, Y, Ya, 0.0, tf, dt0=1.0,
        config=AdaptiveConfig(rtol=1e-6, atol=1e-9),
        model=land,
    )
    assert bool(stats["converged"])
    sim = Simulation(land, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.5,
                     tspan=(0.0, tf))
    Yref = sim.run().state(-1)
    for comp in ("soil", "surface"):
        for k in Yad[comp]:
            a = np.asarray(Yad[comp][k], dtype=np.float64)
            b = np.asarray(Yref[comp][k], dtype=np.float64)
            scale = np.max(np.abs(b)) + 1e-30
            assert np.max(np.abs(a - b)) / scale < 5e-4, (comp, k)


def test_adaptive_fused_land_matches_adaptive_xla():
    """run_adaptive_fused on the LandModel == run_adaptive on the same
    model (segments of 1 step reduce exactly to the per-step controller;
    the land policies ride inside the segment)."""
    import numpy as np

    from landhydrology.adaptive import run_adaptive_fused
    from landhydrology.models.land import make_rhs as make_land_rhs

    land, Y, Ya = _tiny_land()
    cfg = AdaptiveConfig(rtol=1e-5, atol=1e-8)
    tf = 60.0
    Yx, sx = run_adaptive(
        make_land_rhs(land), Y, Ya, 0.0, tf, dt0=2.0, config=cfg, model=land
    )
    Yf, sf_ = run_adaptive_fused(
        land, Y, Ya, 0.0, tf, dt0=2.0, config=cfg,
        steps_per_call=1,
    )
    assert bool(sx["converged"]) and bool(sf_["converged"])
    assert int(sx["n_accepted"]) == int(sf_["n_accepted"])
    for comp in ("soil", "surface"):
        for k in Yx[comp]:
            a = np.asarray(Yx[comp][k], dtype=np.float64)
            b = np.asarray(Yf[comp][k], dtype=np.float64)
            scale = np.max(np.abs(a)) + 1e-30
            assert np.max(np.abs(a - b)) / scale < 1e-6, (comp, k)
