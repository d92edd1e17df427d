"""Production-style long run: compiled stepping + checkpoints + async IO.

Exercises the full runtime stack the way a large deployment would
(SURVEY.md §5 subsystems working together):

- one compiled ``Simulation`` loop segmented at save points,
- periodic npz checkpoints with crash-safe resume (``--resume``),
- saved states streamed through the C++ async trajectory sink,
- NaN guards + conservation monitors between segments,
- grid-points/s throughput report.

Smoke:    python experiments/soil/production_run.py --platform cpu --ncol 512 \
              --nz 16 --hours 0.02 --segment-minutes 0.2
Resume:   rerun the same command with --resume after interrupting.
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
    p.add_argument("--ncol", type=int, default=65536)
    p.add_argument("--nz", type=int, default=48)
    p.add_argument("--hours", type=float, default=6.0)
    p.add_argument("--dt", type=float, default=5.0)
    p.add_argument("--segment-minutes", type=float, default=30.0,
                   help="checkpoint/diagnostic cadence in simulated minutes")
    p.add_argument("--workdir", type=str, default="/tmp/lh_production")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--platform", type=str, default=None)
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
        Column,
        FreeDrainage,
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
    from landhydrology.checkpoint import CheckpointManager
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.diagnostics import energy_total, nan_guard, water_mass
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.runtime import TrajectorySink
    from landhydrology.timestepping import SSPRK33

    os.makedirs(args.workdir, exist_ok=True)
    dtype = jnp.float32
    nz, ncol = args.nz, args.ncol
    rng = np.random.default_rng(11)

    nu = jnp.asarray(rng.uniform(0.35, 0.5, ncol), dtype=dtype)
    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.5, 3.0, ncol), dtype=dtype),
        alpha=jnp.asarray(rng.uniform(1.5, 4.0, ncol), dtype=dtype),
        Ksat=jnp.asarray(10 ** rng.uniform(-6.5, -5.0, ncol), dtype=dtype),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.06, ncol), dtype=dtype),
    )
    ks = k_solid(0.0, 0.5, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.5,
        rho_c_ds=1.2e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, 0.42, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, 0.42, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(-2e-7), energy=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        dtype=dtype,
        assume_no_ice=True,
    )

    def ic(z, m):
        shape = (nz, ncol)
        theta = jnp.broadcast_to(0.5 * nu, shape)
        ti = jnp.zeros(shape, dtype=dtype)
        T = jnp.full(shape, 288.0, dtype=dtype)
        rcs = volumetric_heat_capacity(theta, ti, 1.2e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    mgr = CheckpointManager(os.path.join(args.workdir, "ckpt"))
    t0, step0 = 0.0, 0
    if args.resume and mgr.latest() is not None:
        Y, t0, step0 = mgr.restore(Y)
        print(f"resumed from step {step0} (t={t0:.0f}s)")

    seg_seconds = args.segment_minutes * 60.0
    tf = args.hours * 3600.0
    dz = 2.0 / nz
    # append on resume so previously streamed records survive the restart
    sink = TrajectorySink(
        os.path.join(args.workdir, "trajectory.bin"), append=args.resume
    )
    def segment_callback(Yc, t):
        """Checkpoint + stream + guard at every save point (the callback
        subsystem doing the runtime work, one compiled loop throughout)."""
        nan_guard(Yc, where=f"t={t:.0f}s")
        jax.effects_barrier()
        step_idx = int(round(t / args.dt))
        mgr.save(step_idx, Yc, t)
        sink.append(
            step_idx, t,
            {"surface_theta": np.asarray(Yc["soil"]["vartheta_l"][nz - 1])},
        )
        m = float(water_mass(Yc, dz, param_set=ps))
        e = float(energy_total(Yc, dz))
        print(
            f"t={t/3600.0:6.2f} h  checkpoint step={step_idx}  "
            f"water={m:.6e}  energy={e:.6e}",
            flush=True,
        )

    sim = Simulation(
        model,
        SSPRK33(),
        Y_init=Y,
        Ya_init=Ya,
        dt=args.dt,
        tspan=(t0, tf),
        saveat=seg_seconds,
        callbacks=[segment_callback],
    )
    sim.t = t0
    wall0 = time.time()
    sim.run()
    sink.close()
    wall = time.time() - wall0
    n_steps = int(round((tf - t0) / args.dt))
    print(
        json.dumps(
            {
                "steps": n_steps,
                "wall_s": wall,
                "grid_points_per_s": nz * ncol * n_steps / wall,
                "checkpoints": len(mgr.steps()),
                "sink_records": "see trajectory.bin",
            }
        )
    )


if __name__ == "__main__":
    main()
