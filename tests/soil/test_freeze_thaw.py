"""Freeze-thaw phase-change tests (an extension beyond the reference; the reference's
theta_i tendency is hard-coded zero — right_hand_side.jl:359).

Oracles: exact water-mass and energy conservation of the source pair,
latent-heat release (freezing warms at fixed rho_e_int), equilibrium
partition at the freezing-point-depression curve, and a Stefan-like
freezing front propagating downward from a cold Dirichlet top."""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
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
from landhydrology.models.soil.freeze_thaw import (
    FreezeThaw,
    equilibrium_unfrozen_liquid,
    phase_change_sources,
)
from landhydrology.models.soil.heat import (
    temperature_from_rho_e_int,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.timestepping import SSPRK33

HM = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05)
NU = 0.4


def test_source_conserves_water_mass():
    ft = FreezeThaw(tau=100.0)
    theta_l = jnp.asarray([0.3, 0.2, 0.35])
    theta_i = jnp.asarray([0.0, 0.1, 0.02])
    T = jnp.asarray([260.0, 275.0, 272.0])
    rho_c_s = jnp.asarray([2.5e6, 2.5e6, 2.5e6])
    dl, di = phase_change_sources(ft, HM, theta_l, theta_i, T, NU, rho_c_s, ps)
    # d/dt [vartheta_l + (rho_i/rho_l) theta_i] == 0 exactly
    mass_rate = dl + (ps.rho_cloud_ice / ps.rho_cloud_liq) * di
    np.testing.assert_allclose(np.asarray(mass_rate), 0.0, atol=1e-18)
    # cold cell freezes, warm icy cell melts
    assert float(di[0]) > 0.0
    assert float(di[1]) < 0.0


def test_equilibrium_curve_monotone():
    T = jnp.linspace(250.0, 274.0, 50)
    tl = equilibrium_unfrozen_liquid(HM, T, NU, ps)
    finite = np.asarray(tl[:-1])
    assert np.all(np.diff(finite) >= -1e-12)  # colder -> less unfrozen water
    assert np.isinf(float(tl[-1]))  # above T_0: unconstrained


def _freeze_model(bc_top_T=None, tau=400.0):
    if bc_top_T is None:
        top = SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))
    else:
        top = SoilComponentBC(
            hydrology=VerticalFlux(0.0), energy=Dirichlet(lambda t: bc_top_T)
        )
    return SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=20),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=HM),
        boundary_conditions=SoilColumnBC(
            top=top,
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=NU, S_s=1e-3, rho_c_ds=1.2e6),
        freeze_thaw=FreezeThaw(tau=tau),
    )


def _ic_at(T0):
    def ic(z, m):
        theta = jnp.full_like(z, 0.3)
        theta_i = jnp.zeros_like(z)
        T = jnp.full_like(z, T0)
        rho_c_s = volumetric_heat_capacity(theta, theta_i, 1.2e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
        }

    return ic


def test_supercooled_column_freezes_and_warms():
    """Closed supercooled column: ice forms, diagnosed T rises toward the
    depression curve (latent-heat release), water mass and rho_e_int total
    conserved."""
    model = _freeze_model(None, tau=400.0)
    Y, Ya = initialize_states(model, _ic_at(271.0), 0.0)
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=10.0, tspan=(0.0, 40000.0)
    )
    sim.run()
    vf = np.asarray(sim.Y["soil"]["vartheta_l"])
    tif = np.asarray(sim.Y["soil"]["theta_i"])
    ref = np.asarray(sim.Y["soil"]["rho_e_int"])

    assert np.all(tif > 1e-4)  # ice formed everywhere
    # water mass conserved
    m0 = 0.3 * 20
    mf = float(np.sum(vf + ps.rho_cloud_ice / ps.rho_cloud_liq * tif))
    assert abs(mf - m0) / m0 < 1e-10
    # energy conserved (zero-flux BCs, sources carry no energy)
    e0 = float(np.sum(np.asarray(Y["soil"]["rho_e_int"])))
    assert abs(float(np.sum(ref)) - e0) / abs(e0) < 1e-10
    # latent heat release: diagnosed T above the supercooled IC
    rho_c_s = volumetric_heat_capacity(vf, tif, 1.2e6, ps)
    Tf = np.asarray(temperature_from_rho_e_int(ref, tif, rho_c_s, ps))
    assert np.all(Tf > 271.0)
    # energy-limited freezing relaxes T to T_0 from below, never across
    assert np.all(Tf < ps.T_0 + 1e-6)
    assert np.all(Tf > ps.T_0 - 0.05)
    # ice amount consistent with the energy balance: the latent heat of the
    # frozen fraction equals the sensible warming from the supercooled IC
    warming = np.asarray(
        volumetric_heat_capacity(vf, tif, 1.2e6, ps)
    ) * (Tf - 271.0)
    latent = tif * ps.rho_cloud_ice * ps.LH_f0
    np.testing.assert_allclose(latent, warming, rtol=0.05)


@pytest.mark.slow
def test_stefan_like_front():
    """Cold Dirichlet top on an initially warm wet column: the freezing
    front (max depth with ice) advances monotonically downward."""
    model = _freeze_model(bc_top_T=263.0, tau=400.0)
    Y, Ya = initialize_states(model, _ic_at(274.0), 0.0)
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=5.0,
        tspan=(0.0, 200000.0), saveat=40000.0,
    )
    sol = sim.run()
    depths = []
    z = np.asarray(Ya["zc"]).ravel()
    for k in range(1, len(sol)):
        ti = np.asarray(sol.state(k)["soil"]["theta_i"])
        frozen = ti > 1e-4
        depths.append(z[frozen].min() if frozen.any() else 0.0)
    # front depth decreases (goes deeper) over time and ends well below top
    assert all(b <= a + 1e-9 for a, b in zip(depths[:-1], depths[1:]))
    assert depths[-1] < -0.1
    ti_final = np.asarray(sol.state(-1)["soil"]["theta_i"])
    assert np.all(np.isfinite(ti_final))


@pytest.mark.slow
def test_stefan_front_matches_analytic():
    """Quantitative Stefan-problem validation (north-star config 3): with a
    sharp retention curve (near-step freezing-point depression) and no
    water flow, the freezing front from a cold Dirichlet surface must track
    the one-phase Stefan solution X(t) = 2 lambda sqrt(alpha_f t), with
    lambda from lam*exp(lam^2)*erf(lam) = Ste/sqrt(pi)."""
    import math

    from landhydrology import (
        Dirichlet as _Dirichlet,
        SoilEnergyModel as _SE,
    )
    from landhydrology.models.soil.heat import (
        k_dry,
        ksat_frozen,
        ksat_unfrozen,
        saturated_thermal_conductivity,
        thermal_conductivity,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    theta0, nu, rho_c_ds, ks = 0.3, 0.4, 1.2e6, 2.0
    ksf = ksat_frozen(ks, nu, 2.29)
    ksu = ksat_unfrozen(ks, nu, 0.57)
    T_s, T0 = 263.16, ps.T_0
    hm_sharp = vanGenuchten(n=3.0, alpha=10.0, Ksat=0.0, theta_r=0.0)
    msp = SoilParams(
        nu=nu, S_s=1e-3, nu_ss_quartz=0.6, rho_c_ds=rho_c_ds,
        kappa_solid=ks, kappa_sat_unfrozen=ksu, kappa_sat_frozen=ksf,
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=200),
        energy_model=_SE(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm_sharp),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=_Dirichlet(lambda t: T_s)
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        freeze_thaw=FreezeThaw(tau=100.0),
    )

    def ic(z, m):
        th = jnp.full_like(z, theta0)
        ti = jnp.zeros_like(z)
        rcs = volumetric_heat_capacity(th, ti, rho_c_ds, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full_like(z, T0), ps
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=10.0,
        tspan=(0.0, 4.0 * 86400.0), saveat=86400.0,
    )
    sol = sim.run()
    z = np.asarray(Ya["zc"]).ravel()

    theta_i_final = (ps.rho_cloud_liq / ps.rho_cloud_ice) * theta0
    C_f = float(volumetric_heat_capacity(0.0, theta_i_final, rho_c_ds, ps))
    Ke = theta_i_final / nu  # kersten frozen branch, nu_ss_om = 0
    kap_f = float(
        thermal_conductivity(
            k_dry(ps, msp), Ke,
            saturated_thermal_conductivity(0.0, theta_i_final, ksu, ksf),
        )
    )
    alpha_f = kap_f / C_f
    Ste = C_f * (T0 - T_s) / (theta0 * ps.rho_cloud_liq * ps.LH_f0)
    target = Ste / math.sqrt(math.pi)
    lo, hi = 1e-4, 2.0
    for _ in range(200):
        lam = 0.5 * (lo + hi)
        if lam * math.exp(lam * lam) * math.erf(lam) < target:
            lo = lam
        else:
            hi = lam

    fronts = []
    for k in range(2, len(sol)):  # skip day 1 (front ~15 dz, still smeared)
        t = float(sol.ts[k])
        ti_prof = np.asarray(sol.state(k)["soil"]["theta_i"])
        below = np.where(ti_prof / theta_i_final >= 0.5)[0]
        front_sim = -z[below.min()]
        front_ana = 2.0 * lam * math.sqrt(alpha_f * t)
        fronts.append((t, front_sim, front_ana))
        assert 0.9 < front_sim / front_ana < 1.05, (t, front_sim, front_ana)
    # sqrt(t) scaling between day 2 and day 4 (within discretization)
    r = fronts[-1][1] / fronts[0][1]
    assert abs(r - math.sqrt(fronts[-1][0] / fronts[0][0])) < 0.12


# ---------------------------------------------------------------------------
# Equilibrium (tau -> 0) freeze-thaw (VERDICT r1 item 7)
# ---------------------------------------------------------------------------


def test_equilibrium_projection_conserves_and_partitions():
    """The per-cell equilibrium projection conserves water mass and
    rho_e_int exactly and lands on the phase-equilibrium manifold:
    supercooled liquid partially freezes with T pinned just below T_0 at
    theta_l = theta_l_max(T); warm icy cells melt completely."""
    import dataclasses

    from landhydrology.models.soil.freeze_thaw import (
        EquilibriumFreezeThaw,
        equilibrium_phase_projection,
    )

    model = dataclasses.replace(
        _freeze_model(None), freeze_thaw=EquilibriumFreezeThaw()
    )
    # cells: supercooled liquid / warm with ice / unfrozen warm / very cold
    theta_l = jnp.asarray([[0.30], [0.20], [0.30], [0.30]])
    theta_i = jnp.asarray([[0.00], [0.10], [0.00], [0.00]])
    T = jnp.asarray([[271.0], [276.0], [285.0], [250.0]])
    rcs = volumetric_heat_capacity(theta_l, theta_i, 1.2e6, ps)
    Y = {
        "soil": {
            "vartheta_l": theta_l,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rcs, T, ps),
        }
    }
    Y2 = equilibrium_phase_projection(model, Y)
    v2 = np.asarray(Y2["soil"]["vartheta_l"]).ravel()
    i2 = np.asarray(Y2["soil"]["theta_i"]).ravel()
    e2 = np.asarray(Y2["soil"]["rho_e_int"])

    r = ps.rho_cloud_ice / ps.rho_cloud_liq
    mass0 = np.asarray(theta_l + r * theta_i).ravel()
    np.testing.assert_allclose(v2 + r * i2, mass0, rtol=1e-12)
    np.testing.assert_allclose(e2, np.asarray(Y["soil"]["rho_e_int"]), rtol=1e-15)

    rcs2 = volumetric_heat_capacity(
        np.minimum(v2, NU - i2), i2, 1.2e6, ps
    )
    T2 = np.asarray(
        temperature_from_rho_e_int(e2.ravel(), i2, np.asarray(rcs2), ps)
    )
    # supercooled cell froze partially, T pulled up to (just below) T_0
    assert i2[0] > 1e-3 and 271.0 < T2[0] <= ps.T_0 + 1e-9
    # warm icy cell: sensible heat above T_0 melts only part of the ice
    # (0.1 ice needs ~3e7 J/m^3; 2.85 K of sensible is ~6e6), so equilibrium
    # is partial melt with T pinned at the depression curve just below T_0
    assert 0.0 < i2[1] < 0.1 and abs(T2[1] - ps.T_0) < 0.01
    # unfrozen warm cell untouched
    assert i2[2] < 1e-12 and abs(T2[2] - 285.0) < 1e-9
    # very cold cell froze hard; liquid sits on the depression curve
    assert i2[3] > 0.15
    tlm = float(equilibrium_unfrozen_liquid(HM, jnp.asarray(T2[3]), NU, ps))
    np.testing.assert_allclose(v2[3], tlm, rtol=1e-6)


@pytest.mark.slow
def test_equilibrium_stefan_front_under_2pct_and_dt_independent():
    """North-star config 3 at the stiff limit: the equilibrium projection
    tracks the one-phase Stefan solution to <2% (sub-cell interpolated
    front) with **dt-independent** results (dt=40 vs dt=20 bitwise-close),
    where the relaxation scheme needed tau tuning and sat at 2-8%."""
    import math

    from landhydrology.models.soil.freeze_thaw import EquilibriumFreezeThaw
    from landhydrology.models.soil.heat import (
        k_dry,
        ksat_frozen,
        ksat_unfrozen,
        saturated_thermal_conductivity,
        thermal_conductivity,
    )

    theta0, nu, rho_c_ds, ks = 0.3, 0.4, 1.2e6, 2.0
    ksf = ksat_frozen(ks, nu, 2.29)
    ksu = ksat_unfrozen(ks, nu, 0.57)
    T_s, T0 = 263.16, ps.T_0
    hm_sharp = vanGenuchten(n=3.0, alpha=10.0, Ksat=0.0, theta_r=0.0)
    msp = SoilParams(
        nu=nu, S_s=1e-3, nu_ss_quartz=0.6, rho_c_ds=rho_c_ds,
        kappa_solid=ks, kappa_sat_unfrozen=ksu, kappa_sat_frozen=ksf,
    )

    def run(dt):
        model = SoilModel(
            domain=Column(zlim=(-2.0, 0.0), nelements=200),
            energy_model=SoilEnergyModel(),
            hydrology_model=SoilHydrologyModel(hydraulic_model=hm_sharp),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=Dirichlet(lambda t: T_s)
                ),
                bottom=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
            ),
            soil_param_set=msp,
            freeze_thaw=EquilibriumFreezeThaw(),
        )

        def ic(z, m):
            th = jnp.full_like(z, theta0)
            ti = jnp.zeros_like(z)
            rcs = volumetric_heat_capacity(th, ti, rho_c_ds, ps)
            return {
                "vartheta_l": th,
                "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(
                    ti, rcs, jnp.full_like(z, T0), ps
                ),
            }

        Y, Ya = initialize_states(model, ic, 0.0)
        sim = Simulation(
            model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt,
            tspan=(0.0, 4.0 * 86400.0), saveat=86400.0,
        )
        return sim.run(), np.asarray(Ya["zc"]).ravel()

    theta_i_final = (ps.rho_cloud_liq / ps.rho_cloud_ice) * theta0
    C_f = float(volumetric_heat_capacity(0.0, theta_i_final, rho_c_ds, ps))
    Ke = theta_i_final / nu
    kap_f = float(
        thermal_conductivity(
            k_dry(ps, msp), Ke,
            saturated_thermal_conductivity(0.0, theta_i_final, ksu, ksf),
        )
    )
    alpha_f = kap_f / C_f
    Ste = C_f * (T0 - T_s) / (theta0 * ps.rho_cloud_liq * ps.LH_f0)
    target = Ste / math.sqrt(math.pi)
    lo, hi = 1e-4, 2.0
    for _ in range(200):
        lam = 0.5 * (lo + hi)
        if lam * math.exp(lam * lam) * math.erf(lam) < target:
            lo = lam
        else:
            hi = lam

    def fronts(sol, z):
        out = []
        for k in range(1, len(sol)):
            r = np.asarray(sol.state(k)["soil"]["theta_i"]) / theta_i_final
            i = int(np.where(r >= 0.5)[0].min())
            if i > 0 and r[i] != r[i - 1]:
                f = (0.5 - r[i - 1]) / (r[i] - r[i - 1])
                zf = z[i - 1] + f * (z[i] - z[i - 1])
            else:
                zf = z[i]
            out.append((-zf, 2.0 * lam * math.sqrt(alpha_f * float(sol.ts[k]))))
        return out

    sol40, z = run(40.0)
    f40 = fronts(sol40, z)
    for sim_front, ana_front in f40:
        assert 0.98 < sim_front / ana_front < 1.02, (sim_front, ana_front)

    sol20, _ = run(20.0)
    f20 = fronts(sol20, z)
    # dt-independence: the projection depends only on the conserved
    # (mass, energy) pair, so halving dt leaves the front unchanged to the
    # time-integration error of the (smooth) conduction alone
    for (a, _), (b, _) in zip(f40, f20):
        assert abs(a - b) / a < 5e-3, (a, b)


def test_equilibrium_through_segment_and_trbdf2():
    """The projection composes with the segment runner (wrapper model
    rebinds to the segment's model) and with the implicit steppers: all
    three engines freeze a supercooled batch to the same equilibrium."""
    import dataclasses

    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil.freeze_thaw import (
        EquilibriumFreezeThaw,
        wrap_stepper_with_projection,
    )
    from landhydrology.segment import make_segment_run

    ncol = 8
    model = dataclasses.replace(
        _freeze_model(None),
        domain=Column(zlim=(-1.0, 0.0), nelements=16, batch_shape=(ncol,)),
        freeze_thaw=EquilibriumFreezeThaw(),
    )

    def ic(z, m):
        shape = (16, ncol)
        theta = jnp.full(shape, 0.3)
        theta_i = jnp.zeros(shape)
        T = jnp.broadcast_to(
            270.0 + jnp.linspace(0.0, 2.0, ncol)[None, :], shape
        )
        rcs = volumetric_heat_capacity(theta, theta_i, 1.2e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    dt, n_steps = 50.0, 8

    # XLA explicit reference
    sim_x = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt,
        tspan=(0.0, dt * n_steps),
    )
    sim_x.run()

    # segment runner
    stepper = wrap_stepper_with_projection(SSPRK33(), model)
    segment = make_segment_run(
        model, stepper, dt=dt, steps_per_call=n_steps,
    )
    Yp = segment(Y, jnp.asarray(0.0))

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(sim_x.Y["soil"][k]),
            rtol=1e-10, atol=1e-18, err_msg=f"segment:{k}",
        )

    # TR-BDF2 implicit path (Simulation auto-wraps the projection)
    grid = make_function_space(model.domain, jnp.float64)
    sim_i = Simulation(
        model, TRBDF2Soil(model=model, grid=grid, iters=3),
        Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, dt * n_steps),
    )
    sim_i.run()
    ti_x = np.asarray(sim_x.Y["soil"]["theta_i"])
    ti_i = np.asarray(sim_i.Y["soil"]["theta_i"])
    assert np.all(ti_x > 1e-4) and np.all(ti_i > 1e-4)  # all cells froze some
    np.testing.assert_allclose(ti_i, ti_x, atol=2e-3)
    # both steppers conserve water mass exactly
    r = ps.rho_cloud_ice / ps.rho_cloud_liq
    m0 = float(jnp.sum(Y["soil"]["vartheta_l"] + r * Y["soil"]["theta_i"]))
    for sim in (sim_x, sim_i):
        mf = float(
            jnp.sum(sim.Y["soil"]["vartheta_l"] + r * sim.Y["soil"]["theta_i"])
        )
        assert abs(mf - m0) / m0 < 1e-12


def test_freeze_thaw_requires_dynamic_components():
    """EquilibriumFreezeThaw (or relaxation FreezeThaw) with a prescribed
    energy or hydrology component must fail loudly at construction, not
    with a raw KeyError at the first projection (ADVICE r2)."""
    import dataclasses

    from landhydrology import (
        PrescribedHydrologyModel,
        PrescribedTemperatureModel,
    )
    from landhydrology.models.soil.freeze_thaw import EquilibriumFreezeThaw

    base = _freeze_model(None)
    with pytest.raises(TypeError, match="SoilEnergyModel"):
        dataclasses.replace(
            base,
            energy_model=PrescribedTemperatureModel(),
            freeze_thaw=EquilibriumFreezeThaw(),
        )
    with pytest.raises(TypeError, match="SoilHydrologyModel"):
        dataclasses.replace(
            base,
            hydrology_model=PrescribedHydrologyModel(),
            freeze_thaw=EquilibriumFreezeThaw(),
        )
