"""Generate the golden regression trajectories (run once; output committed).

These freeze the validated f64 numerics (the path proven against the
analytic oracles in tests/soil/) so any future change that silently alters
the math — operator reordering, clamp changes, kernel rewrites — fails the
allclose regression in test_golden_trajectories.py (the practical analogue
of BASELINE.md's "allclose vs reference after N steps" criterion).

Usage: python tests/data/make_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from tests.data.golden_config import (
    FREEZE_STEPS,
    FORCED_STEPS,
    LAND_STEPS,
    N_STEPS,
    build_forced_model_state_and_rows,
    build_freeze_model_and_state,
    build_land_model_and_state,
    build_model_and_state,
)

from landhydrology.models.soil.rhs import make_rhs
from landhydrology.domains import make_function_space
from landhydrology.timestepping import SSPRK33


def _save(name, Y, t):
    out = os.path.join(os.path.dirname(__file__), name)
    arrays = {"t": float(t)}
    for group, fields in Y.items():
        for k, v in fields.items():
            key = k if group == "soil" else f"{group}__{k}"
            arrays[key] = np.asarray(v)
    np.savez(out, **arrays)
    print(f"wrote {out}")


def main():
    stepper = SSPRK33()

    # 1. coupled SoilModel (the original golden)
    model, Y, Ya, dt = build_model_and_state(jnp.float64)
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    t = jnp.asarray(0.0)
    for _ in range(N_STEPS):
        Y = stepper.step(rhs, Y, Ya, t, jnp.asarray(dt))
        t = t + dt
    _save("golden_coupled_f64.npz", Y, t)

    # 2. LandModel flagship (pond + MOST + kinematic routing)
    land, Yl, Yal, dt_l = build_land_model_and_state(jnp.float64)
    rhs_l = land.make_rhs()
    t = jnp.asarray(0.0)
    for _ in range(LAND_STEPS):
        Yl = stepper.step(rhs_l, Yl, Yal, t, jnp.asarray(dt_l))
        t = t + dt_l
    assert float(jnp.max(Yl["surface"]["h_s"])) > 1e-4  # rain pulse ponded
    _save("golden_land_f64.npz", Yl, t)

    # 3. freeze-thaw (rate-based phase change under a -10C surface)
    mf, Yf, Yaf, dt_f = build_freeze_model_and_state(jnp.float64)
    rhs_f = make_rhs(mf)
    t = jnp.asarray(0.0)
    for _ in range(FREEZE_STEPS):
        Yf = stepper.step(rhs_f, Yf, Yaf, t, jnp.asarray(dt_f))
        t = t + dt_f
    assert float(jnp.max(Yf["soil"]["theta_i"])) > 1e-4  # ice actually formed
    _save("golden_freeze_f64.npz", Yf, t)

    # 4. forced run (time-varying MOST atmosphere from a forcing table)
    from landhydrology.runtime import make_forced_segment_run

    mo, Yo, Yao, rows, dt_o = build_forced_model_state_and_rows(jnp.float64)
    seg = make_forced_segment_run(
        mo, stepper, dt=dt_o, field_names=sorted(rows)
    )
    Yo, t = seg(Yo, Yao, 0.0, rows)
    _save("golden_forced_f64.npz", Yo, t)

    # 5. lagged-coefficient production mode (coefficient_update="step"):
    # the configuration the throughput headline actually runs in — frozen
    # separately because its trajectory is a first-order-split NEIGHBOR of
    # the stage trajectory, not the same numbers (VERDICT r4 item 7)
    import dataclasses

    from landhydrology.models.soil.lagged import wrap_stepper_for_soil

    model5, Y5, Ya5, dt5 = build_model_and_state(jnp.float64)
    model5 = dataclasses.replace(model5, coefficient_update="step")
    grid5 = make_function_space(model5.domain, jnp.float64)
    rhs5 = make_rhs(model5, grid5)
    st5 = wrap_stepper_for_soil(stepper, model5, grid5)
    t = jnp.asarray(0.0)
    for _ in range(N_STEPS):
        Y5 = st5.step(rhs5, Y5, Ya5, t, jnp.asarray(dt5))
        t = t + dt5
    _save("golden_lagged_f64.npz", Y5, t)

    # 6. implicit TR-BDF2 (Thomas backend) at dt far beyond the explicit
    # CFL — freezes the Newton/tridiagonal numerics (clamp, boundary
    # boosts, elimination order); the PCR backend and the segment runner
    # are regression-tested against this same file at solver-appropriate
    # tolerances
    from landhydrology.imex import TRBDF2Soil

    model6, Y6, Ya6, _ = build_model_and_state(jnp.float64)
    grid6 = make_function_space(model6.domain, jnp.float64)
    rhs6 = make_rhs(model6, grid6)
    st6 = TRBDF2Soil(model=model6, grid=grid6, iters=3, tridiag="thomas")
    dt6 = 120.0  # 12x the explicit DT of the coupled golden
    t = jnp.asarray(0.0)
    for _ in range(N_STEPS // 4):
        Y6 = st6.step(rhs6, Y6, Ya6, t, jnp.asarray(dt6))
        t = t + dt6
    _save("golden_implicit_f64.npz", Y6, t)


if __name__ == "__main__":
    main()
