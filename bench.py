"""Benchmark: coupled soil-column grid-points/s per device.

The north-star metric (``BASELINE.json``): grid points processed per second
on the flagship fully coupled water+energy column model.  One grid point =
one (level, column) cell advanced one time step (SSPRK33 = 3 RHS sweeps per
step).

Measured paths, all plain JAX compiled by XLA:
- **xla**: the jit ``lax.scan`` over SSPRK33 steps (the faithful
  reference-style implementation; the reference itself is a serial
  single-column Julia loop with no published numbers — SURVEY.md §6);
- **sharded**: the segment runner inside ``shard_map`` on a 1-device mesh
  (the multi-device loop; measures its overhead over the plain scan);
- **lagged**: ``coefficient_update="step"`` (nonlinear coefficients once
  per step; first-order splitting, ``models/soil/lagged.py``);
- **land**: rain + pond + MOST + energy (``LandModel``);
- **implicit**: TR-BDF2 on the stiff infiltration config against explicit
  stepping at matched accuracy.

Every rate is steady-state: each jitted run is called once to compile, then
timed ``reps`` times with ``block_until_ready``; the best time is reported
and the first call is reported as set-up.

Usage:  python bench.py            # full benchmark; needs a GPU
        python bench.py --smoke    # tiny CPU smoke (CI-sized)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build(nz, ncol, dtype, no_ice=False):
    import jax.numpy as jnp

    from landhydrology import (
        Column,
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

    nu = 0.5
    ks = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.92,
        rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, nu, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        dtype=dtype,
        assume_no_ice=no_ice,
    )

    def ic(z, m):
        shape = (nz, ncol)
        # laterally varying moisture/temperature so the sweep sees realistic
        # branch diversity (near-saturation + unsaturated columns)
        col = jnp.arange(ncol, dtype=dtype)[None, :] / ncol
        theta = 0.25 + 0.2 * col + 0.0 * z
        theta_i = jnp.zeros(shape, dtype=dtype)
        T = 284.0 + 6.0 * col + 2.0 * z
        rho_c_s = volumetric_heat_capacity(theta, theta_i, msp.rho_c_ds, ps)
        return {
            "vartheta_l": jnp.broadcast_to(theta, shape).astype(dtype),
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).astype(
                dtype
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya


def build_land(nz, ncol, dtype, surface_update="stage",
               coefficient_update="stage"):
    """The flagship composition: the bench soil column + MOST atmosphere +
    rain pulse + pond store (rain + ponding + evaporation + energy), for the
    fused-LandModel bench row (VERDICT r2 item 3).

    ``surface_update="step"`` freezes the blended MOST multisection solve
    per step instead of per RK stage (LandModel.surface_update);
    ``coefficient_update="step"`` additionally lags the soil's nonlinear
    coefficient sweep (SoilModel.coefficient_update, models/soil/lagged.py)
    — the two step-level splittings compose (the production configuration)."""
    import dataclasses

    import jax.numpy as jnp

    from landhydrology import (
        PrescribedAtmosForcing,
        SoilColumnBC,
        SoilComponentBC,
        VerticalFlux,
    )
    from landhydrology.models.land import (
        LandModel,
        PulsePrecipitation,
        SurfaceWaterModel,
        initialize_states as land_init,
    )

    model, Y, Ya = build(nz, ncol, dtype)
    soil = dataclasses.replace(
        model,
        assume_no_ice=False,
        coefficient_update=coefficient_update,
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
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
            precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0,
                                             t_stop=1e9),
            tau_pond=300.0,
        ),
        surface_update=surface_update,
    )
    Yl = dict(Y)
    Yl["surface"] = {"h_s": jnp.full((ncol,), 1e-4, dtype=dtype)}
    return land, Yl, Ya


def build_stiff(nz, ncol, dtype):
    """The reference's stiffest regime: sand infiltration with a Dirichlet
    top (``richards_equation.jl:98-190``, explicit dt=0.25 s at dz=1 cm) —
    the matched-accuracy arena where the implicit steppers earn wall-clock
    over explicit CFL stepping.  Richards-only (PrescribedTemperature), the
    same column count as the main bench rows."""
    import jax.numpy as jnp

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
    from landhydrology.models.soil import vanGenuchten

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
        dtype=dtype,
    )

    def ic(z, m):
        shape = (nz, ncol)
        col = jnp.arange(ncol, dtype=dtype)[None, :] / ncol
        theta = 0.10 + 0.02 * col + 0.0 * z
        return {
            "vartheta_l": jnp.broadcast_to(theta, shape).astype(dtype),
            "theta_i": jnp.zeros(shape, dtype=dtype),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya


def gpu_name_and_power_limit():
    """``nvidia-smi``'s ``name, power.limit`` line for the first card, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    none stops here instead of timing the CPU under the card's name."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); run with a CUDA-enabled JAX on a GPU host"
        )
    return dev


def timed(fn, *args, reps=3):
    """``(first_call_s, best_s, out)`` of a jitted ``fn``: the first call
    compiles, the best of ``reps`` more is the steady-state time.  Every
    call ends in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def scan_run(rhs, stepper, dt, n_steps):
    """Jitted ``run(Y, Ya, t0) -> Y`` of ``n_steps`` steps in one scan."""
    import jax

    @jax.jit
    def run(Y, Ya, t0):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, dt), t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=n_steps)
        return Yf

    return run


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true", help="tiny CPU run")
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--ncol", type=int, default=65536)
    p.add_argument("--steps", type=int, default=96)
    p.add_argument("--steps-per-call", type=int, default=32,
                   help="segment length of the sharded path")
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument(
        "--no-ice",
        action="store_true",
        help="exact assume_no_ice specialization (theta_i == 0 workloads)",
    )
    p.add_argument(
        "--land-surface-update", type=str, default="stage",
        choices=("stage", "step"),
        help="LandModel.surface_update for the land path: 'stage' = MOST "
             "solves in every RK stage (reference semantics), 'step' = "
             "frozen per step (first-order surface split, ~3x fewer MOST "
             "solves)",
    )
    p.add_argument(
        "--land-lagged", action="store_true",
        help="compose the land path with soil coefficient_update='step' "
             "(lagged nonlinear coefficients, models/soil/lagged.py) — the "
             "production configuration when paired with "
             "--land-surface-update step",
    )
    p.add_argument(
        "--implicit-solver", type=str, default="pcr",
        choices=("thomas", "pcr"),
        help="tridiagonal backend of the implicit rows",
    )
    p.add_argument(
        "--implicit-dt-factor", type=float, default=40.0,
        help="implicit (TR-BDF2) step size as a multiple of the measured "
             "explicit CFL limit on the stiff infiltration config",
    )
    p.add_argument(
        "--paths", type=str, default="sharded,land,lagged,implicit",
        help="comma-separated subset of {sharded,land,lagged,implicit} to "
             "measure beside the always-on xla path",
    )
    args = p.parse_args()
    paths = set(args.paths.split(","))

    import jax

    from landhydrology.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args.nz, args.ncol, args.steps = 16, 1024, 32
        args.steps_per_call = 8
        # the smoke's nz=16 grid takes a front cell per step at 40x CFL
        # (dt ~ dz^2): cap the implicit factor at the accuracy-validated
        # value for that resolution (the nz=64 rows run 40x; the factor is
        # resolution-dependent by nature)
        args.implicit_dt_factor = min(args.implicit_dt_factor, 20.0)
        card = None
    else:
        require_gpu()
        card = gpu_name_and_power_limit()
        print(f"card: {card}", flush=True)

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from landhydrology.domains import make_function_space
    from landhydrology.models.land import wrap_stepper_for_land
    from landhydrology.models.soil.lagged import wrap_stepper_for_soil
    from landhydrology.models.soil.rhs import make_rhs
    from landhydrology.timestepping import SSPRK33

    dtype = jnp.float32
    model, Y, Ya = build(args.nz, args.ncol, dtype, no_ice=args.no_ice)
    grid = make_function_space(model.domain, dtype)
    stepper = SSPRK33()
    rhs = make_rhs(model, grid)
    dt = jnp.asarray(args.dt, dtype=dtype)
    t0a = jnp.asarray(0.0, dtype=dtype)
    work = args.nz * args.ncol * args.steps
    rows = {}

    # --- xla scan path ---
    first, best, Yx = timed(scan_run(rhs, stepper, dt, args.steps), Y, Ya, t0a)
    rows["xla"] = {"first_call_s": first, "best_s": best,
                   "grid_points_per_s": work / best}

    # --- segment runner inside shard_map on a 1-device mesh ---
    max_dev_sh = None
    if "sharded" in paths:
        from landhydrology.parallel import (
            make_column_mesh,
            make_fused_sharded_run,
            shard_state,
        )

        spc = args.steps_per_call
        mesh1 = make_column_mesh(
            shape=(1,), axis_names=("columns",), devices=jax.devices()[:1]
        )
        run_sh = make_fused_sharded_run(
            model, mesh1, stepper, dt=args.dt, steps_per_call=spc,
            n_calls=args.steps // spc,
        )
        first, best, (Ysh, _) = timed(
            run_sh, shard_state(Y, mesh1), shard_state(Ya, mesh1), t0a
        )
        rows["sharded"] = {
            "first_call_s": first, "best_s": best,
            "grid_points_per_s": args.nz * args.ncol * spc
            * (args.steps // spc) / best,
        }
        if args.steps % spc == 0:
            max_dev_sh = float(np.max(np.abs(
                np.asarray(Ysh["soil"]["vartheta_l"])
                - np.asarray(Yx["soil"]["vartheta_l"])
            )))

    # --- lagged coefficients (coefficient_update="step") ---
    max_dev_lag = None
    if "lagged" in paths:
        model_lag = dataclasses.replace(model, coefficient_update="step")
        st_lag = wrap_stepper_for_soil(stepper, model_lag, grid)
        first, best, Ylag = timed(
            scan_run(make_rhs(model_lag, grid), st_lag, dt, args.steps),
            Y, Ya, t0a,
        )
        rows["lagged"] = {"first_call_s": first, "best_s": best,
                          "grid_points_per_s": work / best}
        # the lagged trajectory is a first-order-split neighbor of the
        # stage trajectory, not a different solution
        max_dev_lag = float(np.max(np.abs(
            np.asarray(Ylag["soil"]["vartheta_l"])
            - np.asarray(Yx["soil"]["vartheta_l"])
        )))

    # --- LandModel (rain + pond + MOST + energy) ---
    if "land" in paths:
        land, Yl, Yal = build_land(
            args.nz, args.ncol, dtype,
            surface_update=args.land_surface_update,
            coefficient_update="step" if args.land_lagged else "stage",
        )
        st_land = wrap_stepper_for_land(stepper, land, grid)
        first, best, Ylf = timed(
            scan_run(land.make_rhs(grid), st_land, dt, args.steps),
            Yl, Yal, t0a,
        )
        rows["land"] = {
            "first_call_s": first, "best_s": best,
            "grid_points_per_s": work / best,
            "finite": bool(np.isfinite(np.asarray(Ylf["surface"]["h_s"])).all()),
        }

    # --- implicit (TR-BDF2) on the stiff infiltration config: simulated
    # time per wall second at matched accuracy against explicit stepping ---
    imp = None
    if "implicit" in paths:
        from landhydrology.diagnostics import explicit_dt_limit
        from landhydrology.imex import TRBDF2Soil

        model_st, Y_st, Ya_st = build_stiff(args.nz, args.ncol, dtype)
        grid_st = make_function_space(model_st.domain, dtype)
        rhs_st = make_rhs(model_st, grid_st)
        # CFL limit at the sharpest state the run can visit: a discrete
        # wetting front puts the dry IC (0.1) and the Dirichlet value
        # (0.267) on ADJACENT cells, and that face's K x dpsi/dtheta
        # coupling binds the explicit step (safety 0.5)
        v_wet = Y_st["soil"]["vartheta_l"]
        front = jnp.where(
            (jnp.arange(v_wet.shape[0]) % 2)[:, None] == 0, 0.1, 0.267
        ).astype(dtype)
        Y_wet = {"soil": dict(Y_st["soil"],
                              vartheta_l=jnp.broadcast_to(front, v_wet.shape))}
        dt_exp = 0.5 * float(explicit_dt_limit(model_st, Y_wet))
        # integer factor keeps the matched-accuracy horizons EXACTLY equal
        factor_i = int(round(args.implicit_dt_factor))
        dt_imp = factor_i * dt_exp
        stepper_im = TRBDF2Soil(
            model=model_st, grid=grid_st, iters=2,
            tridiag=args.implicit_solver,
        )
        n_im = 8
        dt_exp_a = jnp.asarray(dt_exp, dtype=dtype)
        dt_imp_a = jnp.asarray(dt_imp, dtype=dtype)
        _, best_ex, v_ex = timed(
            scan_run(rhs_st, stepper, dt_exp_a, n_im * factor_i),
            Y_st, Ya_st, t0a,
        )
        _, best_im, v_im = timed(
            scan_run(rhs_st, stepper_im, dt_imp_a, n_im), Y_st, Ya_st, t0a
        )
        v_ex = np.asarray(v_ex["soil"]["vartheta_l"])
        v_im = np.asarray(v_im["soil"]["vartheta_l"])
        pts = args.nz * args.ncol
        imp = {
            "config": "stiff sand infiltration (Dirichlet top, "
            "richards_equation.jl:98-190)",
            "dt_explicit_cfl_s": dt_exp,
            "dt_implicit_s": dt_imp,
            "implicit_stepper": (
                f"TRBDF2Soil(iters=2, tridiag={args.implicit_solver!r})"
            ),
            "explicit_grid_points_per_s": pts * n_im * factor_i / best_ex,
            "implicit_grid_points_per_s": pts * n_im / best_im,
            # simulated seconds per wall second, implicit over explicit, over
            # the same horizon at the accuracy reported below
            "effective_speedup_matched_accuracy": best_ex / best_im,
            "implicit_dt_factor": factor_i,
            "max_dev_implicit_vs_explicit": float(np.max(np.abs(v_im - v_ex))),
            # the reference's own acceptance metric for this config is a
            # profile l2 < 0.1 (richards_equation.jl:189); gate 10x tighter
            "rmse_implicit_vs_explicit": float(
                np.sqrt(np.mean((v_im - v_ex) ** 2))
            ),
            "implicit_finite": bool(np.isfinite(v_im).all()),
        }

    v_x = np.asarray(Yx["soil"]["vartheta_l"])
    ok = bool(np.isfinite(v_x).all())
    if max_dev_sh is not None:
        ok = ok and max_dev_sh < 1e-5
    if max_dev_lag is not None:
        ok = ok and np.isfinite(max_dev_lag) and max_dev_lag < 1e-2
    if "land" in rows:
        ok = ok and rows["land"]["finite"]
    if imp is not None:
        ok = ok and imp["implicit_finite"] and imp["rmse_implicit_vs_explicit"] < 1e-2

    dev = jax.devices()[0]
    result = {
        "metric": "coupled soil-column grid-points/s per device",
        "value": rows["xla"]["grid_points_per_s"],
        "unit": "grid-points/s",
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "jax": jax.__version__,
            "dtype": "float32",
            "nz": args.nz,
            "ncol": args.ncol,
            "steps": args.steps,
            "paths": rows,
            "max_dev_sharded_vs_xla": max_dev_sh,
            "max_dev_lagged_vs_stage": max_dev_lag,
            "land_surface_update": args.land_surface_update,
            "land_coefficient_update": "step" if args.land_lagged else "stage",
            "implicit": imp,
            "paths_agree": ok,
            "timing": "best of 3 block_until_ready calls after one "
            "compiling call (first_call_s)",
        },
    }
    print(json.dumps(result))
    if not ok:
        raise SystemExit("bench: paths disagree or produced non-finite state")


if __name__ == "__main__":
    main()
