"""Synthetic catchment — storm-runoff showcase composing the package's
capabilities beyond the reference (which is a single uniform column,
SURVEY.md §2 rows 13-15):

- **terrain**: a periodic ridge/valley surface drives Manning kinematic-wave
  overland flow (``KinematicWaveRouting``);
- **variable regolith depth**: soil columns are deeper in the valley
  (``VariableDepthColumn`` — per-column dz);
- **heterogeneous soils**: per-column van Genuchten parameters, coarser
  (higher Ksat) on the ridge;
- **storm hydrology**: a Gaussian rain pulse ponds where infiltration
  capacity is exceeded, routes downslope, and infiltrates in the valley
  (``LandModel``: Hortonian ponding + conservative pond-soil exchange).

Prints a JSON summary: the pond "hydrograph" (valley storage vs time), the
runoff concentration ratio, infiltration partition, and the water-mass
closure residual.

Usage:
    python experiments/soil/catchment.py                       # GPU
    python experiments/soil/catchment.py --nx 16 --ny 16 --hours 0.5 --platform cpu
    python experiments/soil/catchment.py --plot                # + figures
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--nz", type=int, default=16)
    p.add_argument("--dx", type=float, default=10.0)  # lateral spacing (m)
    p.add_argument("--hours", type=float, default=2.0)
    p.add_argument("--dt", type=float, default=2.0)
    p.add_argument("--storm-mm-h", type=float, default=40.0)  # peak intensity
    p.add_argument(
        "--atmos",
        action="store_true",
        help="MOST atmospheric forcing at the surface (coupled energy + "
        "evaporation from pond and bare soil) instead of prescribed T",
    )
    p.add_argument("--platform", type=str, default=None)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
        PrescribedTemperatureModel,
        Simulation,
        SoilColumnBC,
        SoilComponentBC,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VariableDepthColumn,
        VerticalFlux,
    )
    from landhydrology.models.land import (
        KinematicWaveRouting,
        LandModel,
        SurfaceWaterModel,
        initialize_states,
        kinematic_wave_dt_limit,
    )
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.timestepping import SSPRK33

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    nx, ny, nz = args.nx, args.ny, args.nz

    # --- terrain: periodic ridge (x=0) / valley (x=nx/2), mild y roughness
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    relief = 8.0  # m ridge-to-valley
    z_terrain = (
        0.5 * relief * (1.0 + np.cos(2 * np.pi * ix / nx)) * np.ones((1, ny))
        + 0.3 * np.sin(2 * np.pi * iy / ny) * np.sin(2 * np.pi * ix / nx)
    )
    z_norm = (z_terrain - z_terrain.min()) / (z_terrain.max() - z_terrain.min())

    # --- regolith: thin on the ridge, thick in the valley
    depth = 0.5 + 1.5 * (1.0 - z_norm)  # 0.5 m .. 2.0 m

    # --- soils: coarser (sandier, higher Ksat) upslope
    rng = np.random.default_rng(42)
    log_ksat = -6.5 + 1.2 * z_norm + 0.15 * rng.standard_normal((nx, ny))
    hm = vanGenuchten(
        n=jnp.asarray(1.8 + 1.2 * z_norm, dtype=dtype),
        alpha=jnp.asarray(2.0 + 1.5 * z_norm, dtype=dtype),
        Ksat=jnp.asarray(10.0**log_ksat, dtype=dtype),
        theta_r=0.05,
    )

    if args.atmos:
        from landhydrology import PrescribedAtmosForcing, SoilEnergyModel

        energy_model = SoilEnergyModel()
        top_bc = PrescribedAtmosForcing(
            u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
            rho_a_sfc=1.2, q_atm=0.006,
        )
        bottom_bc = SoilComponentBC(
            hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
        )
    else:
        energy_model = PrescribedTemperatureModel()
        top_bc = SoilComponentBC(hydrology=VerticalFlux(0.0))
        bottom_bc = SoilComponentBC(hydrology=VerticalFlux(0.0))  # bedrock

    soil = SoilModel(
        domain=VariableDepthColumn(
            z_bottom=jnp.asarray(-depth, dtype=dtype),
            nelements=nz,
            batch_shape=(nx, ny),
        ),
        energy_model=energy_model,
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(top=top_bc, bottom=bottom_bc),
        soil_param_set=SoilParams(nu=0.42, S_s=1e-3, rho_c_ds=1.3e6),
        dtype=dtype,
    )

    # --- storm: smooth Gaussian pulse peaking at 1/4 of the run
    t_end = args.hours * 3600.0
    P_peak = args.storm_mm_h / 1000.0 / 3600.0  # m/s
    t_c, sig = 0.25 * t_end, 0.08 * t_end

    def precip(t):
        return P_peak * jnp.exp(-(((t - t_c) / sig) ** 2))

    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=precip,
            tau_pond=600.0,
            runoff=KinematicWaveRouting(
                elevation=jnp.asarray(z_terrain, dtype=dtype),
                manning_n=0.05,
                dx=args.dx,
                h_detention=5e-4,
            ),
        ),
    )

    def ic(z, m):
        out = {
            "vartheta_l": jnp.full((nz, nx, ny), 0.15, dtype=dtype),
            "theta_i": jnp.zeros((nz, nx, ny), dtype=dtype),
        }
        if args.atmos:
            from landhydrology.constants import default_earth_param_set as ps
            from landhydrology.models.soil.heat import (
                volumetric_heat_capacity,
                volumetric_internal_energy,
            )

            rcs = volumetric_heat_capacity(
                out["vartheta_l"], out["theta_i"], 1.3e6, ps
            )
            out["rho_e_int"] = volumetric_internal_energy(
                out["theta_i"], rcs, jnp.full((nz, nx, ny), 292.0, dtype=dtype), ps
            )
        return out

    Y, Ya = initialize_states(land, ic, 0.0)
    sim = Simulation(
        land,
        SSPRK33(),
        Y_init=Y,
        Ya_init=Ya,
        dt=args.dt,
        tspan=(0.0, t_end),
        saveat=t_end / 24.0,
    )
    t_start = time.time()
    sol = sim.run()
    jax.block_until_ready(sim.Y)
    wall = time.time() - t_start

    # --- analysis
    dz_col = np.asarray(depth) / nz  # per-column spacing
    h_traj = np.asarray(sol.us["surface"]["h_s"])  # (n_saves, nx, ny)
    ts = np.asarray(sol.ts)
    pond_vol = h_traj.sum(axis=(1, 2)) * args.dx**2  # m^3 "hydrograph"
    v0 = np.asarray(Y["soil"]["vartheta_l"])
    vf = np.asarray(sim.Y["soil"]["vartheta_l"])
    hf = h_traj[-1]
    soil_gain = ((vf - v0).sum(axis=0) * dz_col) * args.dx**2  # m^3 per column

    # mass closure: rain in == soil gain + pond (RK-stage quadrature of the
    # smooth pulse; residual is O(dt^3) time-integration error, not leakage)
    import math

    rain_total = (
        P_peak * sig * math.sqrt(math.pi) * nx * ny * args.dx**2
    )  # analytic Gaussian integral (t_c +- many sig inside the run)
    stored = soil_gain.sum() + hf.sum() * args.dx**2
    evap_total = 0.0
    if args.atmos:
        # trapezoidal quadrature of the diagnosed evaporation over the
        # saved trajectory (MOST evaporation leaves the budget); coarse but
        # closes the storm balance to the save-interval resolution
        from landhydrology.domains import make_function_space
        from landhydrology.models.land import (
            _diagnose_state_T,
            surface_exchange,
        )

        grid_d = make_function_space(soil.domain, dtype)
        e_rates = []
        for k in range(len(sol)):
            Yk = sol.state(k)
            X = {
                "vartheta_l": Yk["soil"]["vartheta_l"],
                "theta_i": Yk["soil"]["theta_i"],
                "T": _diagnose_state_T(soil, Yk["soil"], Ya),
            }
            ex = surface_exchange(
                land, grid_d, X, Yk["surface"]["h_s"], float(sol.ts[k])
            )
            e_rates.append(
                float(jnp.sum(ex["evap_soil"] + ex["evap_pond"]))
            )
        e_rates = np.asarray(e_rates)
        evap_total = float(
            np.trapezoid(e_rates, np.asarray(sol.ts)) * args.dx**2
        )
    closure = abs(stored + evap_total - rain_total) / rain_total

    valley = z_norm < 0.2
    ridge = z_norm > 0.8
    summary = {
        "grid": [nx, ny, nz],
        "steps": int(round(t_end / args.dt)),
        "wall_s_incl_compile": wall,
        "grid_points_per_s": nz * nx * ny * round(t_end / args.dt) / wall,
        "finite": bool(np.isfinite(vf).all() and np.isfinite(hf).all()),
        "peak_pond_volume_m3": float(pond_vol.max()),
        "pond_peak_lag_s": float(ts[pond_vol.argmax()] - t_c),
        "final_pond_volume_m3": float(hf.sum() * args.dx**2),
        "runoff_concentration_valley_vs_ridge": float(
            hf[valley].mean() / max(hf[ridge].mean(), 1e-12)
        ),
        "infiltration_valley_vs_ridge_m": [
            # per-column water column gained (m), averaged inside each mask
            # (soil_gain already carries each column's own dz)
            float(soil_gain[valley].mean() / args.dx**2),
            float(soil_gain[ridge].mean() / args.dx**2),
        ],
        "atmos_forcing": bool(args.atmos),
        "evaporation_total_m3": float(evap_total),
        "mass_closure_rel_residual": float(closure),
        # routing stability margin at peak ponding (dt must stay below it)
        "kinematic_dt_limit_at_peak_s": float(
            kinematic_wave_dt_limit(
                land.surface.runoff,
                jnp.asarray(h_traj[pond_vol.argmax()], dtype=dtype),
            )
        ),
    }
    print(json.dumps(summary, indent=1))
    assert summary["finite"]

    if args.out:
        np.savez(
            args.out,
            h_s=h_traj,
            ts=ts,
            vartheta_l=vf,
            elevation=z_terrain,
            depth=depth,
        )
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(2, 2, figsize=(11, 8))
        axs[0, 0].imshow(z_terrain, cmap="terrain")
        axs[0, 0].set_title("terrain elevation (m)")
        im = axs[0, 1].imshow(hf * 1000.0, cmap="Blues")
        axs[0, 1].set_title("final pond depth (mm)")
        fig.colorbar(im, ax=axs[0, 1])
        axs[1, 0].plot(ts / 3600.0, pond_vol)
        axs[1, 0].axvline(t_c / 3600.0, ls="--", c="gray", label="storm peak")
        axs[1, 0].set_xlabel("t (h)")
        axs[1, 0].set_ylabel("ponded volume (m$^3$)")
        axs[1, 0].legend()
        im = axs[1, 1].imshow((vf - v0).sum(axis=0) * dz_col * 1000.0, cmap="YlGnBu")
        axs[1, 1].set_title("infiltrated water (mm)")
        fig.colorbar(im, ax=axs[1, 1])
        fig.tight_layout()
        path = os.path.join(os.path.dirname(__file__), "catchment.png")
        fig.savefig(path, dpi=120)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
