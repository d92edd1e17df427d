"""Regional heterogeneous-grid run — north-star config 4 (driver
``BASELINE.json``): ~1e5 independent columns with heterogeneous van
Genuchten parameters and mixed per-column BC types on a single device,
integrated with one compiled ``lax.scan``.

Usage:
    python experiments/soil/regional_grid.py                 # GPU, 131072 cols
    python experiments/soil/regional_grid.py --ncol 2048 --platform cpu
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
    p.add_argument("--ncol", type=int, default=131072)
    p.add_argument("--nz", type=int, default=48)
    p.add_argument("--hours", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=5.0)
    p.add_argument("--platform", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
        BatchedBC,
        BCKind,
        Column,
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
    from landhydrology.diagnostics import water_mass
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.rhs import make_rhs
    from landhydrology.timestepping import SSPRK33

    dtype = jnp.float32  # perf driver: single precision on every backend
    ncol, nz = args.ncol, args.nz
    rng = np.random.default_rng(7)

    # heterogeneous soils: loam..sand spectrum per column
    nu = jnp.asarray(rng.uniform(0.35, 0.52, ncol), dtype=dtype)
    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.4, 3.5, ncol), dtype=dtype),
        alpha=jnp.asarray(rng.uniform(1.5, 4.5, ncol), dtype=dtype),
        Ksat=jnp.asarray(10 ** rng.uniform(-7.0, -4.5, ncol), dtype=dtype),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.08, ncol), dtype=dtype),
    )
    ks = k_solid(0.0, 0.6, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.6,
        rho_c_ds=1.2e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, 0.45, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, 0.45, 2.29),
    )

    # mixed BCs: ~half rain-flux columns, ~half Dirichlet-ponding columns
    # at the top; free drainage or zero flux at the bottom
    kinds_top = jnp.asarray(rng.integers(0, 2, ncol), dtype=jnp.int32)  # FLUX/DIRICHLET
    rain = jnp.asarray(-10 ** rng.uniform(-8.0, -6.5, ncol), dtype=dtype)
    pond = 0.9 * nu
    top_vals = jnp.where(kinds_top == BCKind.DIRICHLET, pond, rain)
    kinds_bot = jnp.asarray(
        np.where(rng.random(ncol) < 0.5, BCKind.FREE_DRAINAGE, BCKind.FLUX),
        dtype=jnp.int32,
    )
    bc = SoilColumnBC(
        top=SoilComponentBC(
            hydrology=BatchedBC(kind=kinds_top, value=top_vals),
            energy=VerticalFlux(0.0),
        ),
        bottom=SoilComponentBC(
            hydrology=BatchedBC(kind=kinds_bot, value=jnp.zeros(ncol, dtype)),
            energy=VerticalFlux(0.0),
        ),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=bc,
        soil_param_set=msp,
        dtype=dtype,
    )

    def ic(z, m):
        shape = (nz, ncol)
        theta = jnp.broadcast_to(
            (0.3 + 0.4 * jnp.asarray(rng.random(ncol), dtype=dtype)) * nu, shape
        )
        ti = jnp.zeros(shape, dtype=dtype)
        T = jnp.full(shape, 288.0, dtype=dtype)
        rcs = volumetric_heat_capacity(theta, ti, 1.2e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    n_steps = int(round(args.hours * 3600.0 / args.dt))
    rhs = make_rhs(model)
    stepper = SSPRK33()
    dt = jnp.asarray(args.dt, dtype=dtype)

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Y, t = carry
            return (stepper.step(rhs, Y, Ya, t, dt), t + dt), None

        (Yf, tf), _ = jax.lax.scan(body, (Y, t0), None, length=n_steps)
        return Yf

    m0 = float(water_mass(Y, 2.0 / nz, param_set=ps))
    t_start = time.time()
    Yf = run(Y, jnp.asarray(0.0, dtype=dtype))
    jax.block_until_ready(Yf)
    wall = time.time() - t_start
    mf = float(water_mass(Yf, 2.0 / nz, param_set=ps))

    v = np.asarray(Yf["soil"]["vartheta_l"])
    summary = {
        "ncol": ncol,
        "nz": nz,
        "steps": n_steps,
        "wall_s_incl_compile": wall,
        "grid_points_per_s": nz * ncol * n_steps / wall,
        "finite": bool(np.isfinite(v).all()),
        "theta_min": float(v.min()),
        "theta_max": float(v.max()),
        "water_mass_change_frac": (mf - m0) / m0,
        "dirichlet_cols_wetter": bool(
            np.mean(v[-1][np.asarray(kinds_top) == BCKind.DIRICHLET])
            > np.mean(v[-1][np.asarray(kinds_top) == BCKind.FLUX])
        ),
    }
    print(json.dumps(summary, indent=1))
    if args.out:
        np.savez(args.out, vartheta_l=v, theta_i=np.asarray(Yf["soil"]["theta_i"]))


if __name__ == "__main__":
    main()
