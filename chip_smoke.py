"""Smoke run of the column solver on one GPU through its normal entry points.

Every phase runs in this one process (a second JAX process on the card
would fail for want of memory) and checks its result against a reference:

  a. ``Simulation.run()`` of the flagship coupled water + energy model with
     MOST top forcing, nz=64 x 65,536 columns in f32, against the same
     sampled columns integrated on the CPU in f64;
  b. the CLI (``landhydrology.cli.main(["run", cfg])``) on the flagship
     LandModel config widened to 256 x 256 columns: finite output and a
     closed soil + pond water budget;
  c. every f64 golden trajectory of ``tests/data`` through the XLA path;
  d. a few windows of ``run_forced`` streaming a forcing file (generated
     from a seed) through the native reader, against one forced scan;
  e. the segment schemes: the lateral Lie split of
     ``make_fused_sharded_run`` on a 1-device mesh and
     ``run_adaptive_fused``, each against its per-step sibling.

``--four-cards`` runs only the sharded path on a (2, 2) mesh of four GPUs:
``make_sharded_step`` in pjit and shard_map modes with lateral coupling,
and the Lie-split segment scheme, each against a 1-card run of the same
global problem.

For each phase a line reports compile seconds (JAX's own trace, lowering
and backend-compile durations), steady wall seconds (a second call, ended
by ``block_until_ready``), the device's peak bytes in use so far, and the
deviation from the reference beside its tolerance.  The script exits
non-zero if there is no GPU or any phase fails; the last line of a
successful run is one JSON object naming the device.

Usage:  python chip_smoke.py                 # one GPU, phases a-e
        python chip_smoke.py --four-cards    # four GPUs, sharded path only
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: full sizes of the one-card phases; the tests call the phases smaller
FULL = dict(nz=64, ncol=65536, steps=300, sample=512, cli_side=256,
            forced_ncol=65536, window=64, windows=3)

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def check_device(n_devices=1):
    """The JAX devices, which must be ``n_devices`` GPUs or more; anything
    else (in particular a CPU-only host) raises."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this smoke run needs a CUDA device"
        )
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    return devs


def _deviation(a, b):
    """max |a - b| / max |b|: the error relative to the field's scale."""
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def _tree_deviation(A, B):
    import jax

    return max(
        _deviation(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(A), jax.tree_util.tree_leaves(B))
    )


def _check(ok, what):
    if not ok:
        raise RuntimeError(what)


def _timed(fn):
    """(first_s, wall_s, out): call ``fn`` twice, each ended by
    ``block_until_ready``; the second call is the steady wall time."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return first, time.perf_counter() - t0, out


# --------------------------------------------------------------------------
# a. Simulation.run() of the flagship coupled model
# --------------------------------------------------------------------------


def phase_simulation(nz, ncol, steps, sample, dt=10.0, seed=0):
    """Flagship coupled soil model with MOST top forcing in f32 through
    ``Simulation.run()`` with ``saveat``; ``sample`` columns are rerun on
    the CPU in f64 from the same initial values.

    Tolerance 1e-4 of each field's scale: the card computes in f32 (about
    6e-8 per operation) with its own exp/log/pow and summation order, and
    the difference to the f64 run accumulates over ``steps`` steps."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build
    from landhydrology import PrescribedAtmosForcing, Simulation, SoilColumnBC
    from landhydrology.timestepping import SSPRK33

    def flagship(n, dtype):
        model, Y, Ya = build(nz, n, dtype)
        most = PrescribedAtmosForcing(
            u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
            rho_a_sfc=1.2, q_atm=0.005,
        )
        bc = SoilColumnBC(top=most, bottom=model.boundary_conditions.bottom)
        return dataclasses.replace(model, boundary_conditions=bc), Y, Ya

    model, Y, Ya = flagship(ncol, jnp.float32)
    tf = steps * dt
    kw = dict(dt=dt, tspan=(0.0, tf), saveat=tf / 5)

    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, **kw)

    def run():
        # rewind and rerun: the second call reuses the compiled loop
        sim.Y, sim.t = Y, 0.0
        return sim.run().us

    _, wall, us = _timed(run)
    Yf = jax.tree_util.tree_map(lambda x: x[-1], us)
    _check(all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(Yf)),
           "phase a state left f32")
    _check(next(iter(us["soil"].values())).shape[0] == 6, "expected 6 saves")

    idx = np.sort(np.random.default_rng(seed).choice(ncol, sample, replace=False))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        model64, _, Ya64 = flagship(sample, jnp.float64)
        Y64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x)[:, idx], dtype=jnp.float64), Y
        )
        ref = Simulation(model64, SSPRK33(), Y_init=Y64, Ya_init=Ya64, **kw).run()
        Yref = jax.tree_util.tree_map(lambda x: np.asarray(x[-1]), ref.us)
    Ysub = jax.tree_util.tree_map(lambda x: np.asarray(x)[:, idx], Yf)
    _check(all(np.isfinite(x).all() for x in jax.tree_util.tree_leaves(Ysub)),
           "phase a produced non-finite values")
    return {
        "deviation": _tree_deviation(Ysub, Yref),
        "tolerance": 1e-4,
        "wall_s": wall,
        "grid_points_per_s": nz * ncol * steps / wall,
    }


# --------------------------------------------------------------------------
# b. the CLI on the flagship LandModel config
# --------------------------------------------------------------------------


def phase_cli(side):
    """``landhydrology.cli.main(["run", cfg])`` on the flagship catchment
    config (rain + pond + MOST + runoff routing) at ``side`` x ``side``
    columns.  Water budget: total (soil + pond) change against integrated
    rain minus evaporation; evaporation is integrated by the trapezoid rule
    over the saved states (every 900 s), so the tolerance is 1% of the
    rain volume."""
    import jax.numpy as jnp
    import numpy as np

    from landhydrology import cli
    from landhydrology.config import from_config
    from landhydrology.domains import make_function_space
    from landhydrology.models.land import _diagnose_state_T, surface_exchange

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["example", "--flagship"])
    cfg = json.loads(buf.getvalue())
    cfg["model"]["soil"]["domain"]["batch_shape"] = [side, side]

    with tempfile.TemporaryDirectory() as tmp:
        cfg["output"]["path"] = os.path.join(tmp, "trajectory.npz")
        path = os.path.join(tmp, "run.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        # the CLI returns after writing its .npz, which waits for the device
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", path])
        wall = time.perf_counter() - t0
        _check(rc == 0, f"CLI run returned {rc}")
        out = dict(np.load(cfg["output"]["path"]))

    land = from_config(cfg["model"])
    _check(all(np.isfinite(v).all() for v in out.values()),
           "CLI output not finite")
    grid = make_function_space(land.soil.domain, land.float_dtype)
    dz = float(grid.dz)
    ts = out["t"]
    total = out["vartheta_l"].sum(axis=(1, 2, 3)) * dz + out["surface/h_s"].sum(
        axis=(1, 2)
    )
    evap = []
    for i in range(len(ts)):
        X = {"vartheta_l": jnp.asarray(out["vartheta_l"][i]),
             "theta_i": jnp.asarray(out["theta_i"][i])}
        X["T"] = _diagnose_state_T(
            land.soil, {**X, "rho_e_int": jnp.asarray(out["rho_e_int"][i])}, {}
        )
        ex = surface_exchange(land, grid, X, jnp.asarray(out["surface/h_s"][i]),
                              float(ts[i]))
        evap.append(float(jnp.sum(ex["evap_soil"] + ex["evap_pond"])))
    p = land.surface.precipitation
    rain = p.rate * max(0.0, min(p.t_stop, ts[-1]) - max(p.t_start, ts[0]))
    rain_volume = rain * side * side
    budget = rain_volume - float(np.trapezoid(evap, ts))
    change = float(total[-1] - total[0])
    return {
        "deviation": abs(change - budget) / rain_volume,
        "tolerance": 1e-2,
        "wall_s": wall,
        "saves": int(len(ts)),
    }


# --------------------------------------------------------------------------
# c. f64 golden trajectories
# --------------------------------------------------------------------------


def _data_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")


def _golden_config():
    """``tests/data/golden_config.py``, loaded by path: an installed
    package named ``tests`` may shadow the repository's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_config", os.path.join(_data_dir(), "golden_config.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def golden_runs():
    """name -> (run() -> {field: array}, golden file) for every committed
    f64 golden, each through the XLA path exactly as it was generated."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil.lagged import wrap_stepper_for_soil
    from landhydrology.models.soil.rhs import make_rhs
    from landhydrology.runtime import make_forced_segment_run
    from landhydrology.timestepping import SSPRK33

    gc = _golden_config()
    f64 = jnp.float64

    def scan(rhs, stepper, Y, Ya, dt, n):
        @jax.jit
        def run(Y):
            def body(c, _):
                Yc, t = c
                return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt, f64)),
                        t + dt), None

            (Yf, _), _ = jax.lax.scan(body, (Y, jnp.asarray(0.0, f64)), None,
                                      length=n)
            return Yf

        return run(Y)

    def coupled():
        model, Y, Ya, dt = gc.build_model_and_state(f64)
        return scan(make_rhs(model), SSPRK33(), Y, Ya, dt, gc.N_STEPS)

    def land():
        model, Y, Ya, dt = gc.build_land_model_and_state(f64)
        return scan(model.make_rhs(), SSPRK33(), Y, Ya, dt, gc.LAND_STEPS)

    def freeze():
        model, Y, Ya, dt = gc.build_freeze_model_and_state(f64)
        return scan(make_rhs(model), SSPRK33(), Y, Ya, dt, gc.FREEZE_STEPS)

    def forced():
        model, Y, Ya, rows, dt = gc.build_forced_model_state_and_rows(f64)
        seg = make_forced_segment_run(model, SSPRK33(), dt=dt,
                                      field_names=sorted(rows))
        return seg(Y, Ya, 0.0, rows)[0]

    def lagged():
        model, Y, Ya, dt = gc.build_model_and_state(f64)
        model = dataclasses.replace(model, coefficient_update="step")
        grid = make_function_space(model.domain, f64)
        st = wrap_stepper_for_soil(SSPRK33(), model, grid)
        return scan(make_rhs(model, grid), st, Y, Ya, dt, gc.N_STEPS)

    def implicit():
        model, Y, Ya, _ = gc.build_model_and_state(f64)
        grid = make_function_space(model.domain, f64)
        st = TRBDF2Soil(model=model, grid=grid, iters=3, tridiag="thomas")
        return scan(make_rhs(model, grid), st, Y, Ya, 120.0, gc.N_STEPS // 4)

    return {
        "coupled": (coupled, "golden_coupled_f64.npz"),
        "land": (land, "golden_land_f64.npz"),
        "freeze": (freeze, "golden_freeze_f64.npz"),
        "forced": (forced, "golden_forced_f64.npz"),
        "lagged": (lagged, "golden_lagged_f64.npz"),
        "implicit": (implicit, "golden_implicit_f64.npz"),
    }


def _infiltration(stepper_name, dt):
    """The reference's sand infiltration (``richards_equation.jl:98-190``)
    at its own nz=150 for 0.8 h in f64; returns the final profile."""
    import jax.numpy as jnp
    import numpy as np

    from landhydrology import (
        Column,
        Dirichlet,
        FreeDrainage,
        PrescribedTemperatureModel,
        Simulation,
        SoilColumnBC,
        SoilComponentBC,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        initialize_states,
    )
    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.timestepping import SSPRK33

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=150),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(
            n=3.96, alpha=2.7, Ksat=34 / 3600 / 100, theta_r=0.075)),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
        dtype=jnp.float64,
    )
    Y, Ya = initialize_states(model, lambda z, m: {
        "vartheta_l": jnp.full_like(z, 0.1), "theta_i": jnp.zeros_like(z)}, 0.0)
    if stepper_name == "TRBDF2":
        grid = make_function_space(model.domain, jnp.float64)
        # PCR: the Thomas sweep is unrolled over nz, and at nz=150 its
        # graph takes minutes to compile
        stepper = TRBDF2Soil(model=model, grid=grid, iters=2, tridiag="pcr")
    else:
        stepper = SSPRK33()
    sim = Simulation(model, stepper, Y_init=Y, Ya_init=Ya, dt=dt,
                     tspan=(0.0, 0.8 * 3600))
    sim.run()
    return np.asarray(Ya["zc"]).ravel(), np.asarray(sim.Y["soil"]["vartheta_l"])


def phase_goldens(names=None, infiltration=True):
    """Every f64 golden through the XLA path on the device.  Tolerance 1e-9
    of each field's scale: the CPU reproduces them to 1e-13, and the card's
    own exp/log/pow (a few ulp apart) and summation order add differences
    that grow over the <= 64 steps.  The sand-infiltration golden is a
    grid-converged profile, judged by the reference's own l2 < 0.1, for
    explicit SSPRK33 at the reference's dt and for TR-BDF2 at 20x it."""
    import numpy as np

    import jax

    data_dir = _data_dir()
    runs = golden_runs()
    names = list(runs) if names is None else names
    per = {}
    t0 = time.perf_counter()
    for name in names:
        run, fname = runs[name]
        golden = np.load(os.path.join(data_dir, fname))
        Yf = jax.block_until_ready(run())
        dev = 0.0
        for group, fields in Yf.items():
            for k, v in fields.items():
                key = k if group == "soil" else f"{group}__{k}"
                dev = max(dev, _deviation(v, golden[key]))
        per[name] = dev
    l2 = {}
    if infiltration:
        fine = np.load(os.path.join(data_dir, "golden_infiltration_fine.npz"))
        for stepper_name, dt in (("SSPRK33", 0.25), ("TRBDF2", 5.0)):
            z, v = _infiltration(stepper_name, dt)
            ref = np.interp(z, fine["z"], fine["vartheta_l"])
            l2[stepper_name] = float(np.sqrt(np.sum((v - ref) ** 2)))
        _check(all(x < 0.1 for x in l2.values()),
               f"infiltration l2 {l2} not below the reference's 0.1")
    return {
        "deviation": max(per.values()),
        "tolerance": 1e-9,
        "wall_s": time.perf_counter() - t0,
        "per_golden": per,
        "infiltration_l2": l2,
    }


# --------------------------------------------------------------------------
# d. forced windows through the native reader
# --------------------------------------------------------------------------


def phase_forced(nz, ncol, window, windows, dt=60.0, seed=0):
    """``run_forced`` over ``windows`` windows of a forcing file written
    from a seed (per-column rain, air temperature and humidity) on the
    flagship land model, against one forced scan over the same rows.  Both
    run the same per-step program on the card, so the tolerance is f32
    roundoff: 1e-6 of each field's scale."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_land
    from landhydrology.runtime import (
        ForcingReader,
        make_forced_segment_run,
        run_forced,
        write_forcing,
    )
    from landhydrology.runtime.forcing import native_available
    from landhydrology.timestepping import SSPRK33

    _check(native_available(), "native forcing reader did not build")
    land, Y, Ya = build_land(nz, ncol, jnp.float32)
    n = window * windows
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    day = 2 * np.pi * t[:, None] / 86400.0 + rng.uniform(0, 2 * np.pi, ncol)
    fields = {
        "precipitation": np.where(rng.random((n, ncol)) < 0.3,
                                  rng.uniform(0, 2e-5, (n, ncol)), 0.0),
        "theta_atm": 295.0 + 8.0 * np.sin(day),
        "q_atm": 0.004 + 0.002 * np.cos(day),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forcing.bin")
        write_forcing(path, t, fields)

        def streamed():
            with ForcingReader(path) as reader:
                _check(reader.is_native, "forcing reader fell back to numpy")
                return run_forced(land, Y, Ya, reader, SSPRK33(), dt=dt,
                                  window=window)[0]

        _, wall, Ys = _timed(streamed)
    seg = make_forced_segment_run(land, SSPRK33(), dt=dt,
                                  field_names=sorted(fields))
    rows = {k: jnp.asarray(v) for k, v in fields.items()}
    Yref = jax.block_until_ready(seg(Y, Ya, 0.0, rows)[0])
    _check(all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(Ys)), "forced run not finite")
    return {
        "deviation": _tree_deviation(Ys, Yref),
        "tolerance": 1e-6,
        "wall_s": wall,
        "steps": n,
    }


# --------------------------------------------------------------------------
# e. segment schemes against their per-step siblings
# --------------------------------------------------------------------------


def _lateral_model(nz, nx, ny, conductance=5e-5):
    import dataclasses

    import jax.numpy as jnp

    from bench import build
    from landhydrology.models.soil.model import LateralSurfaceCoupling

    model, Y, Ya = build(nz, nx * ny, jnp.float32)
    model = dataclasses.replace(
        model,
        domain=dataclasses.replace(model.domain, batch_shape=(nx, ny)),
        lateral_coupling=LateralSurfaceCoupling(conductance=conductance,
                                                dx=1.0),
    )
    Y = {"soil": {k: v.reshape(nz, nx, ny) for k, v in Y["soil"].items()}}
    Ya = dict(Ya, zc=Ya["zc"].reshape(nz, 1, 1))
    return model, Y, Ya


def phase_segments(nz, nx, ny, dt=10.0, steps=16):
    """(1) the Lie split of ``make_fused_sharded_run`` on a 1-device mesh
    against the unsplit per-step pjit step.  The split freezes the lateral
    term for a window of ``steps_per_call * dt`` and is first order in it,
    so halving the window must halve the error: the deviation is
    ``|log2(e(4) / e(2)) - 1|`` for windows of 4 and 2 steps, within 0.45
    (ratios 1.46-2.73, the band of ``tests/parallel/test_sharding.py``).
    (2) ``run_adaptive_fused`` with one-step segments against
    ``run_adaptive``: the same step-doubling controller, so accept counts
    agree within one and states within 1e-5 of each field's scale (f32,
    two different programs)."""
    import dataclasses
    import math

    import jax
    import jax.numpy as jnp

    from landhydrology.adaptive import (
        AdaptiveConfig,
        run_adaptive,
        run_adaptive_fused,
    )
    from landhydrology.parallel import (
        make_column_mesh,
        make_fused_sharded_run,
        make_sharded_step,
    )
    from landhydrology.timestepping import SSPRK33

    model, Y, Ya = _lateral_model(nz, nx, ny)
    mesh = make_column_mesh(shape=(1, 1), devices=jax.devices()[:1])
    t0 = jnp.asarray(0.0, jnp.float32)
    step = make_sharded_step(model, mesh, SSPRK33(), dt=dt, mode="pjit")
    Yu, t = Y, t0
    for _ in range(steps):
        Yu, t = step(Yu, Ya, t)
    err, wall = {}, None
    for spc in (4, 2):
        split = make_fused_sharded_run(model, mesh, SSPRK33(), dt=dt,
                                       steps_per_call=spc,
                                       n_calls=steps // spc)
        _, w, (Ys, _) = _timed(lambda: split(Y, Ya, t0))
        wall = w if wall is None else wall
        err[spc] = _tree_deviation(Ys, Yu)

    flat = dataclasses.replace(model, lateral_coupling=None)
    cfg = AdaptiveConfig(rtol=1e-3, atol=1e-6)
    # the state's dtype for run_adaptive's clock (it follows t0 and dt0)
    t_span = [jnp.asarray(x, jnp.float32) for x in (0.0, 600.0, 10.0)]
    Yad, s_ad = run_adaptive_fused(flat, Y, Ya, *t_span, config=cfg,
                                   steps_per_call=1)
    Yx, s_x = run_adaptive(flat.make_rhs(), Y, Ya, *t_span, config=cfg,
                           model=flat)
    _check(bool(s_ad["converged"]) and bool(s_x["converged"]),
           "adaptive runs did not reach t_final")
    _check(abs(int(s_ad["n_accepted"]) - int(s_x["n_accepted"])) <= 1,
           f"accept counts differ: {int(s_ad['n_accepted'])} vs "
           f"{int(s_x['n_accepted'])}")
    dev_ad = _tree_deviation(Yad, Yx)
    _check(dev_ad <= 1e-5, f"run_adaptive_fused deviates {dev_ad:.3g} > 1e-5")
    return {
        "deviation": abs(math.log2(err[4] / err[2]) - 1.0),
        "tolerance": 0.45,
        "wall_s": wall,
        "split_error_window4": err[4],
        "split_error_window2": err[2],
        "adaptive_deviation": dev_ad,
        "adaptive_accepted": int(s_ad["n_accepted"]),
    }


# --------------------------------------------------------------------------
# four cards: the sharded path against one card
# --------------------------------------------------------------------------


def phase_four_cards(nz, nx, ny, dt=10.0, steps=16, spc=4):
    """pjit and shard_map ``make_sharded_step`` with lateral coupling, and
    the Lie-split segment scheme, on a (2, 2) mesh against the same global
    problem on one card.  The halo Laplacian is numerically identical to
    the roll Laplacian, so the tolerance is f32 roundoff: 1e-6 of each
    field's scale."""
    import jax
    import jax.numpy as jnp

    from landhydrology.parallel import (
        make_column_mesh,
        make_fused_sharded_run,
        make_sharded_step,
        shard_state,
    )
    from landhydrology.timestepping import SSPRK33

    devs = jax.devices()
    model, Y, Ya = _lateral_model(nz, nx, ny)
    mesh4 = make_column_mesh(shape=(2, 2), devices=devs[:4])
    mesh1 = make_column_mesh(shape=(1, 1), devices=devs[:1])
    t0 = jnp.asarray(0.0, jnp.float32)
    devs_out, walls = {}, {}

    def stepped(mode, mesh):
        step = make_sharded_step(model, mesh, SSPRK33(), dt=dt, mode=mode)
        Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)

        def run():
            Yc, t = Ys, t0
            for _ in range(steps):
                Yc, t = step(Yc, Yas, t)
            return Yc

        return _timed(run)

    ref = {}
    for mode in ("pjit", "shard_map"):
        _, _, ref[mode] = stepped(mode, mesh1)
        _, walls[mode], Y4 = stepped(mode, mesh4)
        devs_out[mode] = _tree_deviation(Y4, ref[mode])

    def split(mesh):
        run = make_fused_sharded_run(model, mesh, SSPRK33(), dt=dt,
                                     steps_per_call=spc, n_calls=steps // spc)
        Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
        return _timed(lambda: run(Ys, Yas, t0)[0])

    _, _, Y1 = split(mesh1)
    _, walls["lie_split"], Y4 = split(mesh4)
    devs_out["lie_split"] = _tree_deviation(Y4, Y1)
    return {
        "deviation": max(devs_out.values()),
        "tolerance": 1e-6,
        "wall_s": sum(walls.values()),
        "per_path": devs_out,
        "per_path_wall_s": walls,
    }


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


def one_card_phases(s):
    side = int(round(s["ncol"] ** 0.5))
    return [
        ("a", phase_simulation,
         dict(nz=s["nz"], ncol=s["ncol"], steps=s["steps"], sample=s["sample"])),
        ("b", phase_cli, dict(side=s["cli_side"])),
        ("c", phase_goldens, {}),
        ("d", phase_forced,
         dict(nz=s["nz"], ncol=s["forced_ncol"], window=s["window"],
              windows=s["windows"])),
        ("e", phase_segments, dict(nz=s["nz"], nx=side, ny=s["ncol"] // side)),
    ]


def run_phases(phases, device=None):
    """Run each phase, print its line, and return the names that failed.
    A failed phase prints its traceback and the run goes on to the next."""
    failed = []
    for name, fn, kw in phases:
        _compile_s[0] = 0.0
        t0 = time.perf_counter()
        try:
            r = fn(**kw)
            ok = r["deviation"] <= r["tolerance"]
        except Exception:
            traceback.print_exc()
            r, ok = {}, False
        stats = device.memory_stats() if device is not None else None
        peak = (stats or {}).get("peak_bytes_in_use")
        extra = {k: v for k, v in r.items()
                 if k not in ("deviation", "tolerance", "wall_s")}
        print(
            f"phase {name} ({fn.__name__}): {'ok' if ok else 'FAILED'} "
            f"compile_s={_compile_s[0]:.2f} wall_s={r.get('wall_s', float('nan')):.3f} "
            f"phase_s={time.perf_counter() - t0:.1f} peak_bytes={peak} "
            f"deviation={r.get('deviation', float('nan')):.3e} "
            f"tolerance={r.get('tolerance', float('nan')):.1e} "
            f"{json.dumps(extra)}",
            flush=True,
        )
        if not ok:
            failed.append(name)
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on a (2, 2) mesh of four "
                        "GPUs against one card")
    args = p.parse_args(argv)

    import jax

    devs = check_device(4 if args.four_cards else 1)
    jax.config.update("jax_enable_x64", True)  # phases a and c compare in f64
    from bench import gpu_name_and_power_limit
    from landhydrology.compile_cache import enable_compile_cache

    print(f"cache: {enable_compile_cache()}")
    print(f"card: {gpu_name_and_power_limit()}")
    print(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
          f"{len(devs)} device(s)", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    if args.four_cards:
        phases = [("four_cards", phase_four_cards,
                   dict(nz=FULL["nz"], nx=512, ny=512))]
    else:
        phases = one_card_phases(FULL)
    failed = run_phases(phases, devs[0])
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        sys.exit(2)
