"""Weak-scaling harness: columns/s vs device count at fixed per-device work.

North-star target: >80% weak-scaling efficiency from 1 chip to N devices
(``BASELINE.json``).  Without accelerators it runs on virtual CPU devices
(``--virtual N``); on a multi-GPU host it uses the real devices.

Usage:
    python experiments/soil/weak_scaling.py --virtual 8 --cols-per-device 4096
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
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices")
    p.add_argument("--cols-per-device", type=int, default=4096)
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--lateral", action="store_true",
                   help="include halo-exchanged lateral coupling")
    p.add_argument("--mode", choices=["pjit", "shard_map", "fused"],
                   default="pjit",
                   help="'fused' = the multi-step segment runner inside "
                        "shard_map with the lateral Lie split")
    p.add_argument("--steps-per-call", type=int, default=16)
    args = p.parse_args()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)

    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
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
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.model import LateralSurfaceCoupling
    from landhydrology.parallel import make_column_mesh, shard_state
    from landhydrology.parallel.mesh import near_square_factors
    from landhydrology.parallel.stepping import (
        make_fused_sharded_run,
        make_sharded_run,
    )
    from landhydrology.timestepping import SSPRK33

    all_devices = jax.devices()
    # f32 everywhere: this is a throughput harness
    dtype = jnp.float32

    def run_on(n_dev):
        devices = all_devices[:n_dev]
        mesh_shape = near_square_factors(n_dev)
        nx = mesh_shape[0] * max(1, int(np.sqrt(args.cols_per_device)))
        ny = mesh_shape[1] * max(1, args.cols_per_device // max(
            1, int(np.sqrt(args.cols_per_device))
        ))
        model = SoilModel(
            domain=Column(zlim=(-2.0, 0.0), nelements=args.nz,
                          batch_shape=(nx, ny)),
            energy_model=SoilEnergyModel(),
            hydrology_model=SoilHydrologyModel(
                hydraulic_model=vanGenuchten(
                    n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0
                )
            ),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(hydrology=VerticalFlux(0.0),
                                    energy=VerticalFlux(0.0)),
                bottom=SoilComponentBC(hydrology=VerticalFlux(0.0),
                                       energy=VerticalFlux(0.0)),
            ),
            soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
            lateral_coupling=(
                LateralSurfaceCoupling(conductance=1e-5, dx=1.0)
                if args.lateral
                else None
            ),
            dtype=dtype,
        )

        def ic(z, m):
            shape = (args.nz, nx, ny)
            theta = jnp.full(shape, 0.2, dtype=dtype)
            ti = jnp.zeros(shape, dtype=dtype)
            T = jnp.full(shape, 288.0, dtype=dtype)
            rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
            return {
                "vartheta_l": theta,
                "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
            }

        Y, Ya = initialize_states(model, ic, 0.0)
        mesh = make_column_mesh(shape=mesh_shape, devices=devices)
        Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
        if args.mode == "fused":
            spc = max(1, min(args.steps_per_call, args.steps))
            run = make_fused_sharded_run(
                model, mesh, SSPRK33(), dt=1.0, steps_per_call=spc,
                n_calls=max(1, args.steps // spc),
            )
        else:
            run = make_sharded_run(
                model, mesh, SSPRK33(), dt=1.0, n_steps=args.steps,
                mode=args.mode,
            )
        t0 = jnp.asarray(0.0, dtype=dtype)
        jax.block_until_ready(run(Ys, Yas, t0))  # compile + warm
        best = float("inf")
        for _ in range(3):
            s = time.perf_counter()
            jax.block_until_ready(run(Ys, Yas, t0))
            best = min(best, time.perf_counter() - s)
        cols_per_s = nx * ny * args.steps / best
        return cols_per_s, nx * ny

    results = {}
    n = 1
    while n <= len(all_devices):
        cps, ncols = run_on(n)
        results[n] = {"columns_steps_per_s": cps, "ncols": ncols}
        n *= 2
    base = results[1]["columns_steps_per_s"]
    for n, r in results.items():
        r["efficiency"] = r["columns_steps_per_s"] / (n * base)
    note = None
    if args.virtual and args.virtual > (os.cpu_count() or 1):
        note = (
            f"{args.virtual} virtual devices share {os.cpu_count()} physical "
            "CPU cores: throughput cannot scale and efficiency here only "
            "validates correctness/compilation, not hardware scaling"
        )
    print(json.dumps({"mode": args.mode, "lateral": args.lateral,
                      "note": note, "results": results}, indent=1))


if __name__ == "__main__":
    main()
