"""LandModel (soil + ponded surface water) tests: Hortonian ponding,
capacity-limited infiltration, and exact cross-component water
conservation — the multi-component composition the reference anticipates
but never builds (initial_conditions.jl:14)."""

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
)
from landhydrology.models.land import (
    LandModel,
    SurfaceWaterModel,
    initialize_states,
    make_rhs,
)
from landhydrology.models.soil import vanGenuchten
from landhydrology.segment import make_segment_run
from landhydrology.timestepping import SSPRK33

NZ = 30
DZ = 1.5 / NZ


def _land(precip, Ksat=1e-6, tau=60.0):
    soil = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=Ksat, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),  # replaced by coupling
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    return LandModel(soil=soil, surface=SurfaceWaterModel(precipitation=precip,
                                                          tau_pond=tau))


def _ic(z, m):
    return {"vartheta_l": jnp.full_like(z, 0.15), "theta_i": jnp.zeros_like(z)}


def _run(land, tf, dt=2.0):
    Y, Ya = initialize_states(land, _ic, 0.0)
    rhs = make_rhs(land)
    stepper = SSPRK33()
    import jax

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(
            body, (Y, t0), None, length=int(round(tf / dt))
        )
        return Yf

    return Y, run(Y, jnp.asarray(0.0))


def test_light_rain_infiltrates_without_ponding():
    """P below infiltration capacity: no pond forms, soil gains all rain."""
    P = 1e-7
    land = _land(lambda t: P, Ksat=1e-5)
    Y0, Yf = _run(land, tf=2000.0)
    h_s = float(Yf["surface"]["h_s"])
    assert h_s < 1e-9  # no ponding
    gained = float(
        (jnp.sum(Yf["soil"]["vartheta_l"]) - jnp.sum(Y0["soil"]["vartheta_l"])) * DZ
    )
    np.testing.assert_allclose(gained, P * 2000.0, rtol=1e-6)


def test_heavy_rain_ponds_and_conserves():
    """P above capacity: a pond forms (Hortonian ponding); total water
    (soil + pond) equals the integrated rainfall exactly."""
    P = 5e-6
    land = _land(lambda t: P, Ksat=1e-6)
    Y0, Yf = _run(land, tf=4000.0)
    h_s = float(Yf["surface"]["h_s"])
    assert h_s > 1e-4  # ponded
    soil_gain = float(
        (jnp.sum(Yf["soil"]["vartheta_l"]) - jnp.sum(Y0["soil"]["vartheta_l"])) * DZ
    )
    np.testing.assert_allclose(soil_gain + h_s, P * 4000.0, rtol=1e-9)


def test_pond_drains_after_rain_stops():
    """Rain for 4000 s then stop: the pond keeps infiltrating and shrinks;
    conservation still exact."""
    P = 5e-6

    def precip(t):
        return jnp.where(t < 4000.0, P, 0.0)

    land = _land(precip, Ksat=1e-6)
    Y0, Y_mid = _run(land, tf=4000.0)

    # continue from t=2000 with the same rhs
    import jax

    rhs = make_rhs(land)
    _, Ya = initialize_states(land, _ic, 0.0)
    stepper = SSPRK33()

    @jax.jit
    def cont(Y, t0):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(2.0)), t + 2.0), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=2000)
        return Yf

    Y_end = cont(Y_mid, jnp.asarray(4000.0))
    h_mid = float(Y_mid["surface"]["h_s"])
    h_end = float(Y_end["surface"]["h_s"])
    assert h_mid > 1e-4
    assert h_end < h_mid  # pond draining
    total_mid = float(jnp.sum(Y_mid["soil"]["vartheta_l"]) * DZ) + h_mid
    total_end = float(jnp.sum(Y_end["soil"]["vartheta_l"]) * DZ) + h_end
    np.testing.assert_allclose(total_end, total_mid, rtol=1e-9)


def test_requires_dynamic_hydrology():
    from landhydrology import PrescribedHydrologyModel

    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=8),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=PrescribedHydrologyModel(),
        boundary_conditions=None,
    )
    with pytest.raises(TypeError):
        LandModel(soil=soil)


def test_land_model_in_simulation():
    """LandModel plugs into the Simulation driver via the make_rhs
    protocol (saveat trajectory included)."""
    P = 5e-6
    land = _land(lambda t: P, Ksat=1e-6)
    Y, Ya = initialize_states(land, _ic, 0.0)
    sim = Simulation(
        land, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=2.0, tspan=(0.0, 1000.0),
        saveat=500.0,
    )
    sol = sim.run()
    assert len(sol) == 3
    h = float(sim.Y["surface"]["h_s"])
    soil_gain = float(
        (jnp.sum(sim.Y["soil"]["vartheta_l"]) - jnp.sum(Y["soil"]["vartheta_l"]))
        * DZ
    )
    np.testing.assert_allclose(soil_gain + h, P * 1000.0, rtol=1e-9)


def test_runoff_routing_spreads_and_conserves():
    """Localized heavy rain on a 2-D column grid: pond excess routes to
    neighbors (diffusive wave), nothing routes below the detention height,
    and total water is conserved exactly."""
    import dataclasses

    from landhydrology.models.land import RunoffRouting

    NX = NY = 8
    nz = 10
    dz = 1.0 / nz

    # rain only on the center 2x2 patch, above infiltration capacity
    mask = np.zeros((NX, NY))
    mask[3:5, 3:5] = 1.0
    P = 2e-5

    def precip(t):
        return jnp.asarray(P * mask)

    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(NX, NY)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=5e-7, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=precip,
            tau_pond=120.0,
            runoff=RunoffRouting(conductance=5e-3, dx=1.0, h_detention=1e-4),
        ),
    )

    def ic(z, m):
        return {
            "vartheta_l": jnp.full((nz, NX, NY), 0.15),
            "theta_i": jnp.zeros((nz, NX, NY)),
        }

    Y, Ya = initialize_states(land, ic, 0.0)
    sim = Simulation(land, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=2.0,
                     tspan=(0.0, 4000.0))
    sim.run()

    h = np.asarray(sim.Y["surface"]["h_s"])
    assert np.all(np.isfinite(h))
    # rained patch ponded; water spread to dry-rain neighbors
    assert h[3, 3] > 1e-4
    assert h[2, 3] > 1e-6  # neighbor received routed water
    assert h[0, 0] < h[3, 3]  # far field below the source

    # exact conservation: soil + pond == IC + integrated rainfall
    soil_mass = float(jnp.sum(sim.Y["soil"]["vartheta_l"])) * dz
    total = soil_mass + float(h.sum())
    expected = 0.15 * nz * NX * NY * dz + P * mask.sum() * 4000.0
    np.testing.assert_allclose(total, expected, rtol=1e-10)

    # detention: without exceeding h_detention nothing routes
    land2 = dataclasses.replace(
        land,
        surface=dataclasses.replace(
            land.surface,
            precipitation=lambda t: jnp.asarray(1e-9 * mask),
            runoff=RunoffRouting(conductance=5e-3, dx=1.0, h_detention=1e-2),
        ),
    )
    Y2, Ya2 = initialize_states(land2, ic, 0.0)
    sim2 = Simulation(land2, SSPRK33(), Y_init=Y2, Ya_init=Ya2, dt=2.0,
                      tspan=(0.0, 400.0))
    sim2.run()
    h2 = np.asarray(sim2.Y["surface"]["h_s"])
    assert h2[0, 0] == 0.0  # nothing routed to the far field


def test_land_model_atmos_top_needs_dynamic_energy_and_rain_sign():
    """A PrescribedAtmosForcing top face composes with the pond only when
    the energy component is dynamic (MOST needs the surface T); prescribed
    temperature still raises.  Negative rain raises eagerly."""
    from landhydrology import PrescribedAtmosForcing, SoilEnergyModel
    import dataclasses

    soil = _land(lambda t: 0.0).soil
    atmos = PrescribedAtmosForcing(
        u_atm=0.3, theta_atm=299.0, z_atm=0.05, theta_scale=299.0,
        rho_a_sfc=1.17, q_atm=0.01,
    )
    soil_prescribed_T = dataclasses.replace(
        soil,
        boundary_conditions=dataclasses.replace(
            soil.boundary_conditions, top=atmos
        ),
    )
    with pytest.raises(TypeError, match="SoilEnergyModel"):
        LandModel(soil=soil_prescribed_T)

    # with a dynamic energy model the composition is allowed
    soil_atmos = dataclasses.replace(
        soil_prescribed_T, energy_model=SoilEnergyModel()
    )
    LandModel(soil=soil_atmos)

    land = _land(lambda t: -1e-6)  # wrong sign convention
    Y, Ya = initialize_states(land, _ic, 0.0)
    with pytest.raises(ValueError, match="non-negative"):
        make_rhs(land)(Y, Ya, 0.0)


# ---------------------------------------------------------------------------
# Kinematic-wave runoff (Manning flow over topography)
# ---------------------------------------------------------------------------


def _numpy_kinematic_tendency(h, z, n, dx, h_det, water_surface):
    """Hand-rolled oracle for the upwinded Manning face fluxes."""
    h_eff = np.maximum(h - h_det, 0.0)
    w = z + h_eff if water_surface else z + 0.0 * h_eff
    dh = np.zeros_like(h)
    for axis in (0, 1):
        s = (w - np.roll(w, -1, axis=axis)) / dx
        h_up = np.where(s > 0.0, h_eff, np.roll(h_eff, -1, axis=axis))
        q = np.sign(s) * np.sqrt(np.abs(s)) * h_up ** (5.0 / 3.0) / n
        dh -= (q - np.roll(q, 1, axis=axis)) / dx
    return dh


def test_kinematic_wave_tendency_matches_numpy_oracle():
    from landhydrology.models.land import (
        KinematicWaveRouting,
        _kinematic_wave_tendency,
    )

    rng = np.random.default_rng(3)
    h = rng.uniform(0.0, 0.02, (6, 7))
    z = rng.uniform(0.0, 0.5, (6, 7))
    for wss in (True, False):
        ro = KinematicWaveRouting(
            elevation=jnp.asarray(z), manning_n=0.04, dx=2.0,
            h_detention=5e-3, water_surface_slope=wss,
        )
        got = np.asarray(_kinematic_wave_tendency(ro, jnp.asarray(h)))
        want = _numpy_kinematic_tendency(h, z, 0.04, 2.0, 5e-3, wss)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-16)
        # conservative by construction: tendencies sum to zero
        np.testing.assert_allclose(got.sum(), 0.0, atol=1e-15)


def test_kinematic_wave_flows_downhill_and_conserves():
    """A pond on a Gaussian hill drains into the surrounding valley:
    hilltop pond shrinks, valley pond grows, soil + pond water closes
    exactly against zero rainfall input."""
    import dataclasses

    from landhydrology.models.land import KinematicWaveRouting

    NX = NY = 8
    nz = 6
    dzv = 1.0 / nz
    x = np.arange(NX)[:, None] - (NX - 1) / 2.0
    y = np.arange(NY)[None, :] - (NY - 1) / 2.0
    z_terrain = 0.5 * np.exp(-(x**2 + y**2) / 6.0)  # periodic-safe hill

    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(NX, NY)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-8, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: 0.0,
            tau_pond=1e9,  # negligible infiltration: isolate the routing
            runoff=KinematicWaveRouting(
                elevation=jnp.asarray(z_terrain), manning_n=0.05, dx=1.0
            ),
        ),
    )

    def ic(z, m):
        return {
            "vartheta_l": jnp.full((nz, NX, NY), 0.15),
            "theta_i": jnp.zeros((nz, NX, NY)),
        }

    h0 = 0.01  # uniform initial pond
    Y, Ya = initialize_states(land, ic, 0.0, h_s0=h0)
    # kinematic CFL: c = (5/3) h^(2/3) sqrt(|s|)/n peaks ~2.1 m/s here, so
    # dt must stay well under dx/c ~ 0.48 s (0.5 was marginal: stable or
    # not depending on XLA fusion rounding)
    sim = Simulation(land, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.2,
                     tspan=(0.0, 300.0))
    sim.run()
    h = np.asarray(sim.Y["surface"]["h_s"])
    assert np.all(np.isfinite(h)) and np.all(h >= -1e-12)
    hilltop = h[NX // 2, NY // 2]
    corner = h[0, 0]  # valley floor (periodic far field)
    assert hilltop < 0.2 * h0  # drained off the hill
    assert corner > 1.2 * h0  # collected in the valley
    # conservation: no rain, negligible infiltration -> pond+soil closes
    soil_mass = float(jnp.sum(sim.Y["soil"]["vartheta_l"])) * dzv
    soil_mass0 = float(jnp.sum(Y["soil"]["vartheta_l"])) * dzv
    np.testing.assert_allclose(
        soil_mass + h.sum(), soil_mass0 + h0 * NX * NY, rtol=1e-10
    )
    # diffusive-wave flow is downgradient, so the water-surface spread can
    # only decrease (the shallow pond cannot flatten 0.5 m of relief, but
    # it must move monotonically toward it)
    w0 = z_terrain + h0
    w1 = z_terrain + h
    assert w1.std() < w0.std()


def test_pure_kinematic_ignores_pond_slope_on_flat_bed():
    """On a flat bed, diffusive-wave routing spreads a pond bump (its own
    surface drives flow) while pure kinematic routing (bed slope only)
    moves nothing."""
    from landhydrology.models.land import (
        KinematicWaveRouting,
        _kinematic_wave_tendency,
    )

    h = np.zeros((6, 6))
    h[2, 2] = 0.05
    h = jnp.asarray(h)
    kin = KinematicWaveRouting(
        elevation=0.0, manning_n=0.05, dx=1.0, water_surface_slope=False
    )
    dif = KinematicWaveRouting(
        elevation=0.0, manning_n=0.05, dx=1.0, water_surface_slope=True
    )
    np.testing.assert_array_equal(
        np.asarray(_kinematic_wave_tendency(kin, h)), 0.0
    )
    d = np.asarray(_kinematic_wave_tendency(dif, h))
    assert d[2, 2] < 0.0  # bump drains
    assert d[1, 2] > 0.0 and d[2, 1] > 0.0  # into its neighbors
    np.testing.assert_allclose(d.sum(), 0.0, atol=1e-16)


def test_kinematic_wave_gradients_finite_at_equilibrium():
    """The Manning closure must be NaN-safe under AD at zero driving slope
    (flat water surface / filled hollows) — the repo-wide closure rule.
    sqrt'(0) is infinite, so the zero-slope branch needs a clamped operand."""
    import jax

    from landhydrology.models.land import (
        KinematicWaveRouting,
        _kinematic_wave_tendency,
    )

    for wss, h in [
        (True, jnp.full((5, 5), 0.01)),   # flat surface: every slope == 0
        (False, jnp.full((5, 5), 0.01)),  # flat bed: every slope == 0
        (True, jnp.zeros((5, 5))),        # fully dry
    ]:
        ro = KinematicWaveRouting(
            elevation=0.0, manning_n=0.05, dx=1.0, water_surface_slope=wss
        )
        g = jax.grad(lambda hh: jnp.sum(_kinematic_wave_tendency(ro, hh)))(h)
        assert np.all(np.isfinite(np.asarray(g))), (wss, h[0, 0])
    # and gradients flow where water actually moves
    hb = jnp.zeros((5, 5)).at[2, 2].set(0.05)
    ro = KinematicWaveRouting(elevation=0.0, manning_n=0.05, dx=1.0)
    g = jax.grad(lambda hh: _kinematic_wave_tendency(ro, hh)[2, 2])(hb)
    assert np.all(np.isfinite(np.asarray(g))) and float(g[2, 2]) != 0.0


def test_kinematic_wave_dt_limit_flags_unstable_config():
    """The routing CFL estimator brackets the empirical stability edge of
    the downhill-drain configuration (dt=0.5 was marginal there)."""
    from landhydrology.models.land import (
        KinematicWaveRouting,
        kinematic_wave_dt_limit,
    )

    x = np.arange(8)[:, None] - 3.5
    y = np.arange(8)[None, :] - 3.5
    z = 0.5 * np.exp(-(x**2 + y**2) / 6.0)
    ro = KinematicWaveRouting(elevation=jnp.asarray(z), manning_n=0.05, dx=1.0)
    # at the pond depths the drain run actually reaches (h ~ 0.05 in the
    # valley), the limit must be of order the observed ~0.5 s edge
    h = jnp.full((8, 8), 0.05)
    lim = float(kinematic_wave_dt_limit(ro, h))
    assert 0.1 < lim < 5.0
    # dry grid: no wave, no limit
    assert float(kinematic_wave_dt_limit(ro, jnp.zeros((8, 8)))) > 1e20


# ---------------------------------------------------------------------------
# Pond + MOST composition (VERDICT r1 item 5)
# ---------------------------------------------------------------------------


def _atmos_land(precip, tau=60.0, h_smooth=1e-4, Ksat=1e-6):
    """Coupled-energy soil with MOST forcing at the top, composed with the
    pond (the flagship rain + ponding + evaporation + energy config)."""
    import dataclasses

    from landhydrology import PrescribedAtmosForcing, SoilEnergyModel

    soil = _land(lambda t: 0.0, Ksat=Ksat).soil
    soil = dataclasses.replace(
        soil,
        energy_model=SoilEnergyModel(),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=dataclasses.replace(
            soil.soil_param_set, rho_c_ds=1.3e6
        ),
    )
    return LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=precip, tau_pond=tau, h_evap_smoothing=h_smooth
        ),
    )


def _ic_energy(z, m):
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    th = jnp.full_like(z, 0.25)
    ti = jnp.zeros_like(z)
    T = jnp.full_like(z, 292.0)
    rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
    return {
        "vartheta_l": th,
        "theta_i": ti,
        "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
    }


def test_atmos_land_matches_plain_soil_when_dry():
    """With no rain and no pond the composed rhs reduces exactly to the
    plain soil model under its own PrescribedAtmosForcing BC (MOST
    evaporation + heat flux; infiltration = 0)."""
    from landhydrology.models.soil.rhs import make_rhs as make_soil_rhs

    land = _atmos_land(lambda t: 0.0)
    Y, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.0)
    dY_land = make_rhs(land)(Y, Ya, 0.0)
    dY_soil = make_soil_rhs(land.soil)({"soil": Y["soil"]}, Ya, 0.0)

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(dY_land["soil"][k]), np.asarray(dY_soil["soil"][k]),
            rtol=1e-12, atol=1e-30, err_msg=k,
        )
    assert float(jnp.abs(dY_land["surface"]["h_s"])) < 1e-18


def test_rain_pond_evaporation_budget_closes():
    """Rain pulse then drydown under MOST forcing: forward-Euler stepping
    with the budget accumulated from surface_exchange at the same states —
    total water (column + pond) change equals integrated
    P - evap_soil - evap_pond to roundoff, the pond grows during rain,
    evaporates near the potential rate while it stands, and drains after."""
    import jax

    from landhydrology.domains import make_function_space
    from landhydrology.models.land import surface_exchange, _diagnose_state_T
    from landhydrology.timestepping import ForwardEuler

    rain = 8e-6  # above the infiltration capacity of the tight soil
    t_rain = 600.0

    def precip(t):
        return jnp.where(t < t_rain, rain, 0.0)

    land = _atmos_land(precip, tau=120.0, Ksat=2e-7)
    grid = make_function_space(land.soil.domain, land.float_dtype)
    dz = float(grid.dz)
    Y0, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.0)
    rhs = make_rhs(land)
    stepper = ForwardEuler()
    dt = 2.0

    def total_water(Y):
        return jnp.sum(Y["soil"]["vartheta_l"]) * dz + jnp.sum(
            Y["surface"]["h_s"]
        )

    n_steps = 1200  # 40 min: rain for 300 steps, drydown after

    @jax.jit
    def run(Y):
        def body(carry, _):
            Yc, t, budget = carry
            X = {
                "vartheta_l": Yc["soil"]["vartheta_l"],
                "theta_i": Yc["soil"]["theta_i"],
                "T": _diagnose_state_T(land.soil, Yc["soil"], Ya),
            }
            ex = surface_exchange(land, grid, X, Yc["surface"]["h_s"], t)
            budget = budget + dt * jnp.sum(
                ex["P"] - ex["evap_soil"] - ex["evap_pond"]
            )
            Yn = stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt))
            return (Yn, t + dt, budget), Yc["surface"]["h_s"]

        return jax.lax.scan(body, (Y, 0.0, 0.0), None, length=n_steps)

    (Yf, tf, budget), h_trace = run(Y0)

    # exact budget closure (forward Euler: one rhs eval per step at the
    # same state the budget terms were computed from)
    change = float(total_water(Yf) - total_water(Y0))
    assert change == pytest.approx(float(budget), rel=1e-10, abs=1e-15)

    h = np.asarray(h_trace).ravel()
    i_rain_end = int(t_rain / dt)
    assert h[i_rain_end - 1] > 1e-4          # pond formed during rain
    assert abs(int(np.argmax(h)) - i_rain_end) <= 1  # deepest at rain end
    assert h[-1] < 0.5 * h.max()             # drains + evaporates after
    assert np.all(h >= -1e-18)
    assert np.all(np.isfinite(np.asarray(Yf["soil"]["rho_e_int"])))


def test_pond_evaporates_at_potential_rate():
    """While a deep pond stands, the surface water flux is the potential
    (saturated-surface) MOST rate, independent of how dry the soil is."""
    from landhydrology.domains import make_function_space
    from landhydrology.models.land import surface_exchange, _diagnose_state_T
    from landhydrology.models.soil.surface_fluxes import (
        compute_turbulent_surface_fluxes,
    )

    land = _atmos_land(lambda t: 0.0)
    grid = make_function_space(land.soil.domain, land.float_dtype)
    Y, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.05)  # deep pond

    X = {
        "vartheta_l": Y["soil"]["vartheta_l"] * 0.0 + 0.08,  # very dry soil
        "theta_i": Y["soil"]["theta_i"],
        "T": _diagnose_state_T(land.soil, Y["soil"], Ya),
    }
    ex = surface_exchange(land, grid, X, Y["surface"]["h_s"], 0.0)
    # potential rate: MOST at a saturated surface
    top = X["vartheta_l"].shape[0] - 1
    _, E_pot = compute_turbulent_surface_fluxes(
        land.soil.energy_model, land.soil.hydrology_model, land.soil,
        jnp.asarray(land.soil.soil_param_set.nu), jnp.asarray(0.0),
        X["T"][top], 0.0,
    )
    assert float(ex["evap_pond"]) == pytest.approx(float(E_pot), rel=1e-12)
    assert float(ex["evap_soil"]) == 0.0  # bare-soil fraction is zero
    # and the potential rate exceeds what the dry soil alone could evaporate
    _, E_dry = compute_turbulent_surface_fluxes(
        land.soil.energy_model, land.soil.hydrology_model, land.soil,
        X["vartheta_l"][top], X["theta_i"][top], X["T"][top], 0.0,
    )
    assert float(E_pot) > float(E_dry)


def test_land_model_segment_matches_simulation():
    """The segment runner on the batched flagship LandModel config matches
    Simulation's scan over the same 48 steps."""
    import dataclasses

    from landhydrology import PrescribedAtmosForcing, SoilEnergyModel

    ncol = 64
    soil = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=16, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7,
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
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: jnp.where(t < 60.0, 8e-6, 0.0),
            tau_pond=120.0,
        ),
    )

    def ic(z, m):
        from landhydrology.constants import default_earth_param_set as ps
        from landhydrology.models.soil.heat import (
            volumetric_heat_capacity,
            volumetric_internal_energy,
        )

        shape = (16, ncol)
        th = jnp.broadcast_to(
            0.15 + 0.1 * jnp.linspace(0.0, 1.0, ncol)[None, :], shape
        )
        ti = jnp.zeros(shape)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full(shape, 291.0), ps
            ),
        }

    Y, Ya = initialize_states(land, ic, 0.0, h_s0=0.0)
    kw = dict(Y_init=Y, Ya_init=Ya, dt=2.0, tspan=(0.0, 96.0), saveat=48.0)
    sim_x = Simulation(land, SSPRK33(), **kw)
    sol_x = sim_x.run()
    assert len(sol_x) == 3  # t0 and the two saves
    Yp = make_segment_run(
        land, SSPRK33(), dt=kw["dt"], steps_per_call=48
    )(kw["Y_init"], 0.0)

    assert float(jnp.max(sim_x.Y["surface"]["h_s"])) > 1e-5  # heavy rain ponds
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    np.testing.assert_allclose(
        np.asarray(Yp["surface"]["h_s"]),
        np.asarray(sim_x.Y["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )


# --------------------------------------------------------------------------
# surface_update="step": frozen-per-step surface exchange
# --------------------------------------------------------------------------


def test_surface_update_validation_and_config_roundtrip():
    import dataclasses

    from landhydrology.config import from_config, to_config
    from landhydrology.models.land import ConstantPrecipitation

    land = _atmos_land(ConstantPrecipitation(rate=4e-7))
    with pytest.raises(ValueError, match="surface_update"):
        dataclasses.replace(land, surface_update="never")
    step_land = dataclasses.replace(land, surface_update="step")
    rt = from_config(to_config(step_land))
    assert rt.surface_update == "step"
    assert from_config(to_config(land)).surface_update == "stage"


def test_surface_update_step_exact_for_single_stage_stepper():
    """With a single-stage stepper (forward Euler) there is exactly one rhs
    evaluation per step, at the step's initial state — freezing the
    exchange at that same state must change NOTHING.  This pins the wiring
    (wrapper applied, rhs ignored, frozen rates consumed consistently)
    independent of any splitting-error tolerance."""
    import dataclasses

    import jax

    from landhydrology.timestepping import ForwardEuler

    land = _atmos_land(lambda t: 8e-6)
    Y0, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.0)

    def run(land_v, n=12, dt=2.0):
        from landhydrology.models.land import wrap_stepper_for_land

        stepper = wrap_stepper_for_land(ForwardEuler(), land_v)
        rhs = make_rhs(land_v)

        @jax.jit
        def go(Y):
            def body(carry, _):
                Yc, t = carry
                return (
                    stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)),
                    t + dt,
                ), None

            (Yf, _), _ = jax.lax.scan(
                body, (Y, jnp.asarray(0.0)), None, length=n
            )
            return Yf

        return go(Y0)

    Y_stage = run(land)
    Y_step = run(dataclasses.replace(land, surface_update="step"))
    for k in Y_stage["soil"]:
        np.testing.assert_array_equal(
            np.asarray(Y_stage["soil"][k]), np.asarray(Y_step["soil"][k]),
            err_msg=k,
        )
    np.testing.assert_array_equal(
        np.asarray(Y_stage["surface"]["h_s"]),
        np.asarray(Y_step["surface"]["h_s"]),
    )


def test_surface_update_step_first_order():
    """The frozen-exchange deviation from stage-level semantics is first
    order in dt (same accuracy class as the lateral Lie split): halving dt
    roughly halves the max state deviation at fixed final time, and at the
    operating dt the deviation is far below the state scale."""
    import dataclasses

    import jax

    from landhydrology.domains import make_function_space

    land = _atmos_land(lambda t: 8e-6)  # rain + pond + MOST, SSPRK33
    Y0, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.0)
    tf = 48.0

    def run(land_v, dt):
        from landhydrology.models.land import wrap_stepper_for_land

        stepper = wrap_stepper_for_land(SSPRK33(), land_v)
        rhs = make_rhs(land_v)

        @jax.jit
        def go(Y):
            def body(carry, _):
                Yc, t = carry
                return (
                    stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)),
                    t + dt,
                ), None

            (Yf, _), _ = jax.lax.scan(
                body, (Y, jnp.asarray(0.0)), None, length=int(round(tf / dt))
            )
            return Yf

        return go(Y0)

    step_land = dataclasses.replace(land, surface_update="step")

    def dev(dt):
        Ys = run(land, dt)
        Yf = run(step_land, dt)
        d = max(
            float(jnp.max(jnp.abs(Ys["soil"]["vartheta_l"]
                                  - Yf["soil"]["vartheta_l"]))),
            float(jnp.max(jnp.abs(Ys["surface"]["h_s"]
                                  - Yf["surface"]["h_s"]))),
        )
        return d

    d4, d2, d1 = dev(4.0), dev(2.0), dev(1.0)
    assert d4 > 0.0  # the split is real (flag actually changes the path)
    r42, r21 = d4 / d2, d2 / d1
    assert 1.5 < r42 < 2.7, (d4, d2, d1)
    assert 1.5 < r21 < 2.7, (d4, d2, d1)
    # absolute scale at the operating dt: far below the moisture scale
    assert d2 < 1e-6, d2


def test_surface_update_step_segment_matches_xla():
    """The segment runner with surface_update='step' reproduces the
    Simulation frozen-exchange trajectory exactly (both paths freeze at the
    same states), and differs from the stage-level trajectory (the flag is
    honored inside the segment, not silently dropped)."""
    import dataclasses

    from landhydrology import PrescribedAtmosForcing, SoilEnergyModel
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    ncol = 64
    soil = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=16, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7,
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
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: jnp.where(t < 60.0, 8e-6, 0.0),
            tau_pond=120.0,
        ),
        surface_update="step",
    )

    def ic(z, m):
        shape = (16, ncol)
        th = jnp.broadcast_to(
            0.15 + 0.1 * jnp.linspace(0.0, 1.0, ncol)[None, :], shape
        )
        ti = jnp.zeros(shape)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full(shape, 291.0), ps
            ),
        }

    Y, Ya = initialize_states(land, ic, 0.0, h_s0=0.0)
    kw = dict(Y_init=Y, Ya_init=Ya, dt=2.0, tspan=(0.0, 96.0))
    sim_x = Simulation(land, SSPRK33(), **kw)
    sim_x.run()
    Yp = make_segment_run(
        land, SSPRK33(), dt=kw["dt"], steps_per_call=48
    )(kw["Y_init"], 0.0)
    sim_stage = Simulation(
        dataclasses.replace(land, surface_update="stage"), SSPRK33(), **kw
    )
    sim_stage.run()

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    np.testing.assert_allclose(
        np.asarray(Yp["surface"]["h_s"]),
        np.asarray(sim_x.Y["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    # the frozen path is a genuinely different (but close) trajectory
    dev = float(jnp.max(jnp.abs(sim_stage.Y["soil"]["vartheta_l"]
                                - sim_x.Y["soil"]["vartheta_l"])))
    assert 0.0 < dev < 1e-3, dev  # real but tiny vs the ~0.2 moisture scale


def test_surface_update_step_conserves_water():
    """Water closure is exact under the frozen exchange: both sides of the
    component boundary consume the same frozen rates, so
    d/dt[column + pond] = P - evap_soil - evap_pond - bottom outflow holds
    to roundoff (accumulated with the SAME frozen rates the stepper
    used)."""
    import jax

    from landhydrology.domains import make_function_space
    from landhydrology.models.land import (
        FrozenExchangeStepper,
        _exchange_from_state,
    )
    from landhydrology.timestepping import ForwardEuler

    land = _atmos_land(lambda t: 8e-6)
    import dataclasses as dc

    land = dc.replace(land, surface_update="step")
    grid = make_function_space(land.soil.domain, land.float_dtype)
    Y, Ya = initialize_states(land, _ic_energy, 0.0, h_s0=0.0)
    stepper = FrozenExchangeStepper(inner=ForwardEuler(), land=land, grid=grid)
    rhs = make_rhs(land)

    dt, n = 2.0, 40
    dz = float(grid.dz) if jnp.ndim(grid.dz) == 0 else None
    water0 = float(jnp.sum(Y["soil"]["vartheta_l"]) * dz + Y["surface"]["h_s"])
    budget = 0.0
    t = jnp.asarray(0.0)
    for _ in range(n):
        ex = _exchange_from_state(land, grid, Y, Ya, t)
        budget += dt * float(ex["P"] - ex["evap_soil"] - ex["evap_pond"])
        Y = stepper.step(rhs, Y, Ya, t, jnp.asarray(dt))
        t = t + dt
    water1 = float(jnp.sum(Y["soil"]["vartheta_l"]) * dz + Y["surface"]["h_s"])
    np.testing.assert_allclose(water1 - water0, budget, rtol=1e-10, atol=1e-14)
