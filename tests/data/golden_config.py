"""The frozen model/state configuration behind the golden trajectories.

Shared by the generator (make_golden.py) and the regression test so the
two can never drift apart.  Deliberately exercises: coupled water+energy,
free drainage + Dirichlet BCs, heterogeneous per-column parameters, a
near-saturation column, and freeze-thaw-free physics (the reference-parity
subset)."""

import numpy as np

N_STEPS = 64
NZ = 24
NCOL = 8
DT = 10.0


def build_model_and_state(dtype):
    import jax.numpy as jnp

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
        initialize_states,
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    rng = np.random.default_rng(42)
    nu = jnp.asarray(rng.uniform(0.42, 0.5, NCOL), dtype=dtype)
    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.6, 2.8, NCOL), dtype=dtype),
        alpha=jnp.asarray(rng.uniform(2.0, 3.5, NCOL), dtype=dtype),
        Ksat=jnp.asarray(rng.uniform(5e-7, 5e-6, NCOL), dtype=dtype),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.04, NCOL), dtype=dtype),
    )
    ks = k_solid(0.0, 0.6, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.6,
        rho_c_ds=1.1e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, 0.45, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, 0.45, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-1.2, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=Dirichlet(lambda t: 0.31),
                energy=Dirichlet(lambda t: 290.0 + 0.0 * t),
            ),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        dtype=dtype,
    )

    def ic(z, m):
        shape = (NZ, NCOL)
        prof = jnp.asarray(
            0.12 + 0.25 * np.exp(np.asarray(z).reshape(NZ, 1) / 0.4)
            + 0.02 * rng.random((NZ, NCOL)),
            dtype=dtype,
        )
        theta = jnp.minimum(prof, 0.9 * nu)
        theta_i = jnp.zeros(shape, dtype=dtype)
        T = jnp.asarray(
            285.0 + 4.0 * np.asarray(z).reshape(NZ, 1) + np.zeros((NZ, NCOL)),
            dtype=dtype,
        )
        rcs = volumetric_heat_capacity(theta, theta_i, 1.1e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, DT


# ---------------------------------------------------------------------------
# Flagship-family goldens (VERDICT r3 item 7): the LandModel pond + MOST +
# routing composition, freeze-thaw, and a forced (time-varying atmosphere)
# run — so a kernel/closure rewrite can no longer shift flagship numerics
# with only co-moving equivalence tests watching.
# ---------------------------------------------------------------------------

LAND_STEPS = 48
LAND_DT = 2.0
LAND_NZ, LAND_NX, LAND_NY = 12, 4, 4


def build_land_model_and_state(dtype):
    """LandModel flagship: coupled soil + MOST atmosphere + rain pulse +
    pond + kinematic-wave routing over a terrain hill."""
    import jax.numpy as jnp

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
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.land import (
        KinematicWaveRouting,
        LandModel,
        PulsePrecipitation,
        SurfaceWaterModel,
        initialize_states as land_init,
    )
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    x = np.arange(LAND_NX)[:, None] - (LAND_NX - 1) / 2.0
    y = np.arange(LAND_NY)[None, :] - (LAND_NY - 1) / 2.0
    terrain = 0.2 * np.exp(-(x**2 + y**2) / 4.0)
    soil = SoilModel(
        domain=Column(
            zlim=(-1.5, 0.0), nelements=LAND_NZ,
            batch_shape=(LAND_NX, LAND_NY),
        ),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=2e-7, theta_r=0.05
            )
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
        dtype=dtype,
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=PulsePrecipitation(
                rate=8e-6, t_start=0.0, t_stop=60.0
            ),
            tau_pond=120.0,
            runoff=KinematicWaveRouting(
                elevation=jnp.asarray(terrain, dtype=dtype),
                manning_n=0.05, dx=1.0,
            ),
        ),
    )

    def ic(z, m):
        shape = (LAND_NZ, LAND_NX, LAND_NY)
        th = jnp.full(shape, 0.22, dtype=dtype)
        ti = jnp.zeros(shape, dtype=dtype)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full(shape, 292.0, dtype=dtype), ps
            ),
        }

    Y, Ya = land_init(land, ic, 0.0, h_s0=2e-3)
    return land, Y, Ya, LAND_DT


FREEZE_STEPS = 64
FREEZE_DT = 5.0


def build_freeze_model_and_state(dtype):
    """Freeze-thaw flagship: coupled column cooled from above through the
    freezing point, rate-based phase change (tau resolves a few steps)."""
    import jax.numpy as jnp

    from landhydrology import (
        Column,
        Dirichlet,
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
    from landhydrology.models.soil.freeze_thaw import FreezeThaw
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=16, batch_shape=(4,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=1e-7, theta_r=0.05
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0),
                energy=Dirichlet(lambda t: 263.15),  # -10 C surface
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        freeze_thaw=FreezeThaw(tau=60.0),
        dtype=dtype,
    )

    def ic(z, m):
        shape = (16, 4)
        th = jnp.full(shape, 0.3, dtype=dtype)
        ti = jnp.zeros(shape, dtype=dtype)
        T = jnp.full(shape, 274.0, dtype=dtype)  # just above freezing
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, FREEZE_DT


FORCED_STEPS = 40
FORCED_DT = 60.0
FORCED_NZ, FORCED_NCOL = 12, 16


def build_forced_model_state_and_rows(dtype):
    """Forced flagship: MOST-topped coupled column batch driven by a
    deterministic (trig-generated, RNG-free) per-step forcing table with a
    scalar and a per-column field."""
    import jax.numpy as jnp

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

    model = SoilModel(
        domain=Column(
            zlim=(-1.5, 0.0), nelements=FORCED_NZ,
            batch_shape=(FORCED_NCOL,),
        ),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05
            )
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
        dtype=dtype,
    )

    t = np.arange(FORCED_STEPS) * FORCED_DT
    phase = 2.0 * np.pi * np.arange(FORCED_NCOL) / FORCED_NCOL
    day = 2.0 * np.pi * t[:, None] / 86400.0 + phase[None, :]
    rows = {
        "u_atm": jnp.asarray(2.0 + 1.5 * np.sin(2e-4 * t), dtype=dtype),
        "theta_atm": jnp.asarray(
            295.0 + 8.0 * np.sin(day - 0.5), dtype=dtype
        ),
        "q_atm": jnp.asarray(0.004 + 0.002 * np.cos(day), dtype=dtype),
    }

    def ic(z, m):
        shape = (FORCED_NZ, FORCED_NCOL)
        th = jnp.broadcast_to(
            0.15 + 0.1 * jnp.linspace(0.0, 1.0, FORCED_NCOL)[None, :], shape
        ).astype(dtype)
        ti = jnp.zeros(shape, dtype=dtype)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full(shape, 290.0, dtype=dtype), ps
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, rows, FORCED_DT
