"""Bare-soil evaporation experiment with Monin-Obukhov surface forcing.

Port of ``/root/reference/experiments/SoilModel/surface_fluxes.jl``
(480-day drydown of a sandy-loam column driven by a prescribed atmosphere,
dt = 160 s, saves every 4 h).  Instead of Plots.jl figures the driver writes
the saved trajectory and post-processed surface diagnostics (surface
moisture, evaporation rate, heat flux — the reference's ``f(u_k)``
post-processing at ``surface_fluxes.jl:131-158``) to an ``.npz``.

Usage:
    python experiments/soil/surface_fluxes.py --days 480 --out drydown.npz
    python experiments/soil/surface_fluxes.py --days 2 --platform cpu  # smoke
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# allow running straight from a source checkout
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--days", type=float, default=480.0)
    p.add_argument("--dt", type=float, default=160.0)
    p.add_argument("--nz", type=int, default=10)
    p.add_argument("--saveat-hours", type=float, default=4.0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument(
        "--plot",
        type=str,
        default=None,
        help="write drydown figures (PNG) to this path prefix — the "
        "reference's Plots.jl output (surface_fluxes.jl:169-277)",
    )
    p.add_argument("--platform", type=str, default=None, help="cpu to force CPU")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
        Column,
        PrescribedAtmosForcing,
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
    from landhydrology.constants import default_earth_param_set as param_set
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        temperature_from_rho_e_int,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.surface_fluxes import (
        compute_turbulent_surface_fluxes,
    )
    from landhydrology.models.soil.water import (
        hydrostatic_profile,
        volumetric_liquid_fraction,
    )
    from landhydrology.timestepping import SSPRK33

    # soil composition (surface_fluxes.jl:27-58)
    nu = 0.55
    Ksat = 1.31 / 100 / 3600 / 1000
    S_s = 1e-3
    hm = vanGenuchten(n=1.68, alpha=5.0, Ksat=Ksat, theta_r=0.084)
    kappa_solid = k_solid(0.0, 0.4, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=S_s,
        nu_ss_gravel=0.0,
        nu_ss_om=0.0,
        nu_ss_quartz=0.4,
        rho_p=1770.0 / (1.0 - nu),
        rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=kappa_solid,
        kappa_sat_unfrozen=ksat_unfrozen(kappa_solid, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(kappa_solid, nu, 2.29),
    )

    # atmosphere (surface_fluxes.jl:67-87)
    T_surf = 299.0
    rho_a_sfc = 1.17
    bc = SoilColumnBC(
        top=PrescribedAtmosForcing(
            u_atm=0.34,
            theta_atm=T_surf,
            z_atm=0.05,
            theta_scale=T_surf,
            rho_a_sfc=rho_a_sfc,
            q_atm=0.015,
        ),
        bottom=SoilComponentBC(
            energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)
        ),
    )

    model = SoilModel(
        domain=Column(zlim=(-0.55, 0.0), nelements=args.nz),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=bc,
        soil_param_set=msp,
    )

    # hydrostatic IC at T = 298.5 (surface_fluxes.jl:101-113)
    def ic(z, m):
        T = jnp.full_like(z, 298.5)
        theta_i = jnp.zeros_like(z)
        theta_l = hydrostatic_profile(hm, z, -0.55, nu, S_s)
        rho_c_s = volumetric_heat_capacity(theta_l, theta_i, msp.rho_c_ds, param_set)
        rho_e_int = volumetric_internal_energy(theta_i, rho_c_s, T, param_set)
        return {"vartheta_l": theta_l, "theta_i": theta_i, "rho_e_int": rho_e_int}

    t0, tf = 0.0, 3600.0 * 24.0 * args.days
    Y, Ya = initialize_states(model, ic, t0)
    sim = Simulation(
        model,
        SSPRK33(),
        Y_init=Y,
        Ya_init=Ya,
        dt=args.dt,
        tspan=(t0, tf),
        saveat=3600.0 * args.saveat_hours,
    )
    wall = time.time()
    sol = sim.run()
    wall = time.time() - wall

    # post-processing (surface_fluxes.jl:131-158): surface state + fluxes
    us = sol.us["soil"]
    vartheta = np.asarray(us["vartheta_l"])  # (nsave, nz)
    theta_i = np.asarray(us["theta_i"])
    rho_e = np.asarray(us["rho_e_int"])
    nu_eff = nu - theta_i
    vlf = np.asarray(volumetric_liquid_fraction(jnp.asarray(vartheta), jnp.asarray(nu_eff)))
    rho_c_s = np.asarray(
        volumetric_heat_capacity(
            jnp.asarray(vlf), jnp.asarray(theta_i), msp.rho_c_ds, param_set
        )
    )
    temp = np.asarray(
        temperature_from_rho_e_int(
            jnp.asarray(rho_e), jnp.asarray(theta_i), jnp.asarray(rho_c_s), param_set
        )
    )
    heat_flux, evap = compute_turbulent_surface_fluxes(
        model.energy_model,
        model.hydrology_model,
        model,
        jnp.asarray(vartheta[:, -1]),
        jnp.asarray(theta_i[:, -1]),
        jnp.asarray(temp[:, -1]),
    )
    heat_flux = np.asarray(heat_flux)
    evap = np.asarray(evap)

    days = np.asarray(sol.ts) / 86400.0
    print(f"integrated {round((tf - t0) / args.dt)} steps in {wall:.1f}s")
    print(f"surface vartheta_l: {vartheta[0,-1]:.4f} -> {vartheta[-1,-1]:.4f}")
    print(f"surface T:          {temp[0,-1]:.2f} -> {temp[-1,-1]:.2f} K")
    print(f"evaporation (mm/day): {evap[0]*86400*1000:.3f} -> {evap[-1]*86400*1000:.3f}")
    print(f"surface heat flux (W/m^2): {heat_flux[0]:.2f} -> {heat_flux[-1]:.2f}")

    if args.out:
        np.savez(
            args.out,
            t_days=days,
            zc=np.asarray(Ya["zc"]).ravel(),
            vartheta_l=vartheta,
            theta_i=theta_i,
            rho_e_int=rho_e,
            T=temp,
            surface_heat_flux=heat_flux,
            surface_evaporation=evap,
        )
        print(f"wrote {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(10, 7), constrained_layout=True)
        axes[0, 0].plot(days, vartheta[:, -1])
        axes[0, 0].set(xlabel="t (days)", ylabel="surface vartheta_l",
                       title="Surface moisture drydown")
        axes[0, 1].plot(days, evap * 86400 * 1000)
        axes[0, 1].set(xlabel="t (days)", ylabel="E (mm/day)",
                       title="Evaporation")
        axes[1, 0].plot(days, heat_flux)
        axes[1, 0].set(xlabel="t (days)", ylabel="W/m^2",
                       title="Surface heat flux")
        zc = np.asarray(Ya["zc"]).ravel()
        for frac in (0.0, 0.1, 0.3, 1.0):
            k = min(len(days) - 1, int(frac * (len(days) - 1)))
            axes[1, 1].plot(vartheta[k], zc, label=f"{days[k]:.0f} d")
        axes[1, 1].set(xlabel="vartheta_l", ylabel="z (m)",
                       title="Moisture profiles")
        axes[1, 1].legend()
        path = f"{args.plot}_drydown.png"
        fig.savefig(path, dpi=120)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
