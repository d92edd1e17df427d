"""Command-line entry point: run a simulation from a JSON config file.

The reference has no CLI — its "user entry" layer is Julia scripts composing
constructors (SURVEY.md §1 row 8).  This module keeps that constructor
lattice as the source of truth (``config.py`` serializes it) and adds the
thin driver the reference lacks::

    python -m landhydrology run run.json
    python -m landhydrology describe run.json
    python -m landhydrology example > run.json

Config layout (the ``model`` section is exactly ``config.to_config(model)``):

.. code-block:: json

    {
      "model": {"__type__": "SoilModel", ...},
      "simulation": {"dt": 100.0, "t_final": 86400.0, "saveat": 3600.0,
                     "stepper": "SSPRK33"},
      "initial_conditions": {"kind": "default"},
      "output": {"path": "trajectory.npz"},
      "checkpoint": {"directory": "ckpts", "every": 10000}
    }

``initial_conditions.kind`` is one of:

- ``default`` — the reference's defaults (T_0, no ice, vartheta_l = nu/2;
  ``models.jl:147-162``); fully coupled models only.
- ``constant`` — uniform ``vartheta_l``/``theta_i`` (and ``T`` for dynamic
  energy, converted to rho_e_int through the closure chain).
- ``hydrostatic`` — equilibrium moisture profile with the water table at
  ``z_table`` (``SoilWaterParameterizations.jl:290-306``), plus uniform
  ``T`` for dynamic energy.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from landhydrology import timestepping
from landhydrology.segment import REMOVED_OPTIONS, reject_removed_options

STEPPERS = {
    "ForwardEuler": timestepping.ForwardEuler,
    "SSPRK22": timestepping.SSPRK22,
    "SSPRK33": timestepping.SSPRK33,
    "SSPRK104": timestepping.SSPRK104,
}


IMPLICIT_STEPPERS = ("BackwardEulerRichards", "BackwardEulerSoil", "TRBDF2Soil")


def _build_stepper(name: str, model=None, iters=None, tridiag=None):
    if name in STEPPERS:
        return STEPPERS[name]()
    if name in IMPLICIT_STEPPERS:
        from landhydrology import imex
        from landhydrology.domains import make_function_space

        soil = getattr(model, "soil", model)
        if soil is None or not hasattr(soil, "domain"):
            raise TypeError(
                f"{name} is an implicit soil stepper and needs the model "
                "(tridiagonal assembly closes over the grid)"
            )
        grid = make_function_space(soil.domain, soil.float_dtype)
        kwargs = {"model": soil, "grid": grid}
        if iters is not None:
            kwargs["iters"] = int(iters)
        if tridiag is not None:
            # "thomas" (serial sweep) or "pcr" (parallel cyclic reduction,
            # log2(nz) rounds)
            kwargs["tridiag"] = str(tridiag)
        return getattr(imex, name)(**kwargs)
    raise KeyError(
        f"unknown stepper {name!r}; available: "
        f"{sorted(STEPPERS) + sorted(IMPLICIT_STEPPERS)}"
    )


def _build_ic(model, spec: dict):
    import jax.numpy as jnp

    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.initial_conditions import initialize_states
    from landhydrology.models.soil.model import SoilEnergyModel
    from landhydrology.models.soil.water import hydrostatic_profile

    is_land = hasattr(model, "soil") and hasattr(model, "surface")
    if is_land:
        # soil IC spec applies to the soil component; the pond starts at
        # ``h_s0`` (m, default dry)
        from landhydrology.models.land import (
            initialize_states as land_init,
        )

        soil_spec = dict(spec)
        h_s0 = float(soil_spec.pop("h_s0", 0.0))
        if soil_spec.get("kind", "default") == "default":
            raise KeyError(
                "LandModel configs need an explicit initial_conditions kind "
                "('constant' or 'hydrostatic') plus optional h_s0 — the "
                "soil default-IC shortcut does not cover the pond"
            )
        Y_soil_fn = _soil_ic_fn(model.soil, soil_spec)
        return land_init(model, Y_soil_fn, soil_spec.get("t0", 0.0), h_s0=h_s0)

    kind = spec.get("kind", "default")
    if kind == "default":
        return model.default_initial_conditions()
    return initialize_states(model, _soil_ic_fn(model, spec), spec.get("t0", 0.0))


def _soil_ic_fn(model, spec: dict):
    """The (z, model) -> state-dict IC closure for the declarative kinds."""
    import jax.numpy as jnp

    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.model import SoilEnergyModel
    from landhydrology.models.soil.water import hydrostatic_profile

    kind = spec.get("kind", "constant")
    dynamic_energy = isinstance(model.energy_model, SoilEnergyModel)

    def ic(z, m):
        if kind == "constant":
            vartheta_l = jnp.full_like(z, spec["vartheta_l"])
        elif kind == "hydrostatic":
            vartheta_l = hydrostatic_profile(
                m.hydrology_model.hydraulic_model,
                z,
                spec["z_table"],
                m.soil_param_set.nu,
                m.soil_param_set.S_s,
            )
        else:
            raise KeyError(f"unknown initial_conditions.kind {kind!r}")
        theta_i = jnp.full_like(z, spec.get("theta_i", 0.0))
        out = {"vartheta_l": vartheta_l, "theta_i": theta_i}
        if dynamic_energy:
            T = jnp.full_like(z, spec.get("T", 288.0))
            theta_l = jnp.minimum(vartheta_l, m.soil_param_set.nu - theta_i)
            rho_c_s = volumetric_heat_capacity(
                theta_l, theta_i, m.soil_param_set.rho_c_ds, m.earth_param_set
            )
            out["rho_e_int"] = volumetric_internal_energy(
                theta_i, rho_c_s, T, m.earth_param_set
            )
        return out

    return ic


def load_run(path: str):
    """Parse a config file into (model, stepper, Y, Ya, sim_kwargs, cfg)."""
    from landhydrology.config import from_config

    with open(path) as f:
        cfg = json.load(f)
    model = from_config(cfg["model"])
    sim = cfg.get("simulation", {})
    stepper = _build_stepper(
        sim.get("stepper", "SSPRK33"), model, sim.get("iters"),
        sim.get("tridiag"),
    )
    Y, Ya = _build_ic(model, cfg.get("initial_conditions", {"kind": "default"}))
    sim_kwargs = dict(
        dt=float(sim["dt"]),
        tspan=(float(sim.get("t0", 0.0)), float(sim["t_final"])),
        saveat=float(sim["saveat"]) if "saveat" in sim else None,
    )
    reject_removed_options(
        f"{path}: simulation",
        {k: sim[k] for k in REMOVED_OPTIONS if k in sim},
    )
    return model, stepper, Y, Ya, sim_kwargs, cfg


def cmd_run(path: str) -> int:
    import numpy as np

    from landhydrology.compile_cache import enable_compile_cache
    from landhydrology.simulations import Simulation

    enable_compile_cache()
    model, stepper, Y, Ya, sim_kwargs, cfg = load_run(path)

    adaptive_cfg = cfg.get("simulation", {}).get("adaptive")
    if adaptive_cfg:
        return _run_adaptive_cfg(
            model, stepper, Y, Ya, sim_kwargs, cfg, adaptive_cfg
        )
    sim = Simulation(model, stepper, Y_init=Y, Ya_init=Ya, **sim_kwargs)

    ckpt_cfg = cfg.get("checkpoint")
    manager = None
    if ckpt_cfg:
        from landhydrology.checkpoint import CheckpointManager

        manager = CheckpointManager(ckpt_cfg["directory"])
        latest = manager.latest()
        if latest is not None:
            Y_res, t_res, _ = manager.restore(Y, latest)
            sim = Simulation(
                model,
                stepper,
                Y_init=Y_res,
                Ya_init=Ya,
                dt=sim_kwargs["dt"],
                tspan=(float(t_res), sim_kwargs["tspan"][1]),
                saveat=sim_kwargs["saveat"],
            )
            print(f"resumed from checkpoint step {latest} (t={t_res})")

    sol = sim.run()

    out_cfg = cfg.get("output", {})
    out_path = out_cfg.get("path", "trajectory.npz")
    arrays = {"t": np.asarray(sol.ts)}
    last = sol.state(len(sol) - 1)
    for group, fields in last.items():  # soil, surface, ... (LandModel)
        for k in fields:
            key = k if group == "soil" else f"{group}/{k}"
            arrays[key] = np.stack(
                [np.asarray(sol.state(i)[group][k]) for i in range(len(sol))]
            )
    np.savez(out_path, **arrays)
    if manager is not None:
        nsteps = int(
            round((sim_kwargs["tspan"][1] - sim_kwargs["tspan"][0]) / sim_kwargs["dt"])
        )
        manager.save(nsteps, sol.state(len(sol) - 1), sim_kwargs["tspan"][1])
    print(
        f"wrote {out_path}: {len(sol)} saves x fields "
        f"{sorted(k for k in arrays if k != 't')}"
    )
    return 0


def _run_adaptive_cfg(model, stepper, Y, Ya, sim_kwargs, cfg, adaptive_cfg) -> int:
    """Error-controlled integration (``"simulation": {"adaptive": {...}}``):
    one on-device while_loop from t0 to t_final; saves the final state (the
    adaptive loop has no fixed save grid)."""
    import numpy as np

    from landhydrology.adaptive import AdaptiveConfig, run_adaptive

    rhs = model.make_rhs()
    t0, tf = sim_kwargs["tspan"]
    acfg = AdaptiveConfig(
        **{k: v for k, v in adaptive_cfg.items() if not isinstance(v, dict)}
    )
    Yf, stats = run_adaptive(
        rhs, Y, Ya, t0, tf, sim_kwargs["dt"], stepper=stepper, config=acfg,
        model=model,
    )
    if not bool(stats["converged"]):
        raise RuntimeError(
            f"adaptive integration did not reach t_final={tf}: {stats}"
        )
    out_path = cfg.get("output", {}).get("path", "trajectory.npz")
    arrays = {"t": np.asarray([t0, tf])}
    for group, fields in Yf.items():
        for k in fields:
            key = k if group == "soil" else f"{group}/{k}"
            arrays[key] = np.stack(
                [np.asarray(Y[group][k]), np.asarray(fields[k])]
            )
    np.savez(out_path, **arrays)
    print(
        f"wrote {out_path} (adaptive: {int(stats['n_accepted'])} accepted / "
        f"{int(stats['n_rejected'])} rejected steps, "
        f"dt_final={float(stats['dt_final']):.4g}s)"
    )
    return 0


def cmd_describe(path: str) -> int:
    model, stepper, Y, Ya, sim_kwargs, _ = load_run(path)
    import jax

    n_state = sum(x.size for x in jax.tree_util.tree_leaves(Y))
    soil = getattr(model, "soil", model)
    print(f"model: {type(model).__name__} (name={model.name!r})")
    print(f"  energy:    {type(soil.energy_model).__name__}")
    print(f"  hydrology: {type(soil.hydrology_model).__name__}")
    print(f"  domain:    {soil.domain}")
    if hasattr(model, "surface"):
        sw = model.surface
        print(
            f"  surface:   {type(sw).__name__} "
            f"(precipitation={type(sw.precipitation).__name__}, "
            f"runoff={type(sw.runoff).__name__ if sw.runoff else None})"
        )
    print(f"stepper: {type(stepper).__name__} ({stepper.stages} stage(s))")
    print(f"tspan: {sim_kwargs['tspan']}, dt: {sim_kwargs['dt']}")
    print(f"state: {n_state} scalars in {sorted(Y)}: "
          f"{ {g: sorted(v) for g, v in Y.items()} }")
    return 0


EXAMPLE = {
    "model": None,  # filled in below
    "simulation": {"dt": 100.0, "t_final": 86400.0, "saveat": 21600.0,
                   "stepper": "SSPRK33"},
    "initial_conditions": {"kind": "default"},
    "output": {"path": "trajectory.npz"},
}


def cmd_example(flagship: bool = False) -> int:
    from landhydrology import (
        Column,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology.config import to_config
    from landhydrology.models.soil import vanGenuchten

    if flagship:
        return _example_flagship()

    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=32),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten()),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(),
    )
    cfg = dict(EXAMPLE)
    cfg["model"] = to_config(model)
    json.dump(cfg, sys.stdout, indent=2)
    print()
    return 0


def _example_flagship() -> int:
    """The rain + pond + MOST + energy + runoff-routing catchment config —
    the full model zoo expressed declaratively (VERDICT r2 item 7)."""
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
    from landhydrology.config import to_config
    from landhydrology.models.land import (
        LandModel,
        PulsePrecipitation,
        RunoffRouting,
        SurfaceWaterModel,
    )
    from landhydrology.models.soil import vanGenuchten

    soil = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=24, batch_shape=(16, 16)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=3e-7,
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
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0,
                                             t_stop=1800.0),
            tau_pond=300.0,
            runoff=RunoffRouting(conductance=1e-3, dx=10.0),
        ),
    )
    cfg = {
        "model": to_config(land),
        "simulation": {"dt": 5.0, "t_final": 3600.0, "saveat": 900.0,
                       "stepper": "SSPRK33"},
        "initial_conditions": {"kind": "constant", "vartheta_l": 0.18,
                               "T": 291.0, "h_s0": 0.0},
        "output": {"path": "flagship_trajectory.npz"},
    }
    json.dump(cfg, sys.stdout, indent=2)
    print()
    return 0


def main(argv: Any = None) -> int:
    p = argparse.ArgumentParser(prog="landhydrology")
    sub = p.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run a simulation from a JSON config")
    p_run.add_argument("config")
    p_desc = sub.add_parser("describe", help="summarize a config without running")
    p_desc.add_argument("config")
    p_ex = sub.add_parser("example", help="print an example config to stdout")
    p_ex.add_argument(
        "--flagship", action="store_true",
        help="the full LandModel catchment config (rain + pond + MOST + "
             "energy + runoff routing)",
    )
    args = p.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args.config)
    if args.cmd == "describe":
        return cmd_describe(args.config)
    return cmd_example(flagship=getattr(args, "flagship", False))


if __name__ == "__main__":
    raise SystemExit(main())
