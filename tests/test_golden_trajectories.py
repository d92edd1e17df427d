"""Cross-implementation allclose regressions against the committed golden
f64 trajectory (tests/data/golden_coupled_f64.npz) — the practical analogue
of BASELINE.md's "vartheta_l / rho_e_int allclose after N steps" criterion.

Every execution path must reproduce the frozen numerics:
- the jit XLA scan path in f64 (exact),
- the multi-step segment runner (exact — same traced physics),
- the f32 path (loose tolerance — dtype is a config axis).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.data.golden_config import DT, N_STEPS, build_model_and_state

from landhydrology.domains import make_function_space
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.segment import make_segment_run
from landhydrology.timestepping import SSPRK33

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_coupled_f64.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _run_scan(dtype):
    model, Y, Ya, dt = build_model_and_state(dtype)
    grid = make_function_space(model.domain, dtype)
    rhs = make_rhs(model, grid)
    stepper = SSPRK33()

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Y, t = carry
            return (stepper.step(rhs, Y, Ya, t, jnp.asarray(dt, dtype=dtype)),
                    t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=N_STEPS)
        return Yf

    return run(Y, jnp.asarray(0.0, dtype=dtype))


def test_xla_f64_matches_golden(golden):
    Yf = _run_scan(jnp.float64)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=k,
        )


def test_segment_matches_golden(golden):
    model, Y, Ya, dt = build_model_and_state(jnp.float64)
    run = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=N_STEPS
    )
    Yf = run(Y, 0.0)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), golden[k], rtol=1e-12, atol=1e-16,
            err_msg=k,
        )


GOLDEN_LAND = os.path.join(os.path.dirname(__file__), "data", "golden_land_f64.npz")
GOLDEN_FREEZE = os.path.join(
    os.path.dirname(__file__), "data", "golden_freeze_f64.npz"
)
GOLDEN_FORCED = os.path.join(
    os.path.dirname(__file__), "data", "golden_forced_f64.npz"
)


def test_land_flagship_matches_golden():
    """LandModel pond + MOST + kinematic routing: the XLA path reproduces
    the frozen f64 trajectory (a kernel/closure rewrite can no longer move
    the flagship numerics with only co-moving equivalence tests watching)."""
    from tests.data.golden_config import LAND_STEPS, build_land_model_and_state

    golden = np.load(GOLDEN_LAND)
    land, Y, Ya, dt = build_land_model_and_state(jnp.float64)
    rhs = land.make_rhs()
    stepper = SSPRK33()

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=LAND_STEPS)
        return Yf

    Yf = run(Y, jnp.asarray(0.0))
    assert float(jnp.max(Yf["surface"]["h_s"])) > 1e-4  # ponded as frozen
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=k,
        )
    np.testing.assert_allclose(
        np.asarray(Yf["surface"]["h_s"]), golden["surface__h_s"],
        rtol=1e-13, atol=1e-20,
    )


def test_freeze_thaw_matches_golden_both_engines():
    """Rate-based freeze-thaw under a -10C surface: XLA scan AND the
    segment runner reproduce the frozen trajectory (ice mass included)."""
    from tests.data.golden_config import (
        FREEZE_STEPS,
        build_freeze_model_and_state,
    )

    golden = np.load(GOLDEN_FREEZE)
    model, Y, Ya, dt = build_freeze_model_and_state(jnp.float64)
    rhs = make_rhs(model)
    stepper = SSPRK33()

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=FREEZE_STEPS)
        return Yf

    Yx = run(Y, jnp.asarray(0.0))
    assert float(jnp.max(Yx["soil"]["theta_i"])) > 1e-4  # ice formed
    segment = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=FREEZE_STEPS
    )
    Yp = segment(Y, 0.0)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yx["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=f"xla/{k}",
        )
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), golden[k], rtol=1e-12, atol=1e-16,
            err_msg=f"segment/{k}",
        )


def test_forced_run_matches_golden_both_engines():
    """Time-varying MOST forcing from a deterministic table: the forced
    scan AND the segment runner's step-indexed forcing rows reproduce the
    frozen trajectory."""
    from tests.data.golden_config import build_forced_model_state_and_rows

    from landhydrology.runtime import make_forced_segment_run

    golden = np.load(GOLDEN_FORCED)
    model, Y, Ya, rows, dt = build_forced_model_state_and_rows(jnp.float64)
    seg_x = make_forced_segment_run(
        model, SSPRK33(), dt=dt, field_names=sorted(rows)
    )
    Yx, _ = seg_x(Y, Ya, 0.0, rows)
    n_rows = next(iter(rows.values())).shape[0]
    seg_f = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=n_rows,
        forcing_fields=sorted(rows),
    )
    Yf = seg_f(Y, 0.0, forcing=rows)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yx["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=f"xla/{k}",
        )
        np.testing.assert_allclose(
            np.asarray(Yf["soil"][k]), golden[k], rtol=1e-12, atol=1e-16,
            err_msg=f"segment/{k}",
        )


def test_f32_matches_golden_loosely(golden):
    Yf = _run_scan(jnp.float32)
    np.testing.assert_allclose(
        np.asarray(Yf["soil"]["vartheta_l"]), golden["vartheta_l"],
        rtol=0, atol=2e-4,
    )
    # energy is large in magnitude; compare via diagnosed relative error
    rel = np.abs(
        np.asarray(Yf["soil"]["rho_e_int"], dtype=np.float64)
        - golden["rho_e_int"]
    ) / (np.abs(golden["rho_e_int"]) + 1e3)
    assert np.max(rel) < 5e-4


GOLDEN_LAGGED = os.path.join(
    os.path.dirname(__file__), "data", "golden_lagged_f64.npz"
)


def test_lagged_production_mode_matches_golden_both_engines():
    """coefficient_update='step' (the production throughput mode) has its
    OWN frozen trajectory — a first-order-split neighbor of the stage
    trajectory, not the same numbers — reproduced by the wrapped XLA scan
    and the segment runner (which applies the lagged policy itself)."""
    import dataclasses

    from tests.data.golden_config import build_model_and_state
    from landhydrology.models.soil.lagged import wrap_stepper_for_soil

    golden = np.load(GOLDEN_LAGGED)
    model, Y, Ya, dt = build_model_and_state(jnp.float64)
    model = dataclasses.replace(model, coefficient_update="step")
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    st = wrap_stepper_for_soil(SSPRK33(), model, grid)

    @jax.jit
    def run(Y, t0):
        def body(carry, _):
            Yc, t = carry
            return (st.step(rhs, Yc, Ya, t, jnp.asarray(dt)), t + dt), None

        (Yf, _), _ = jax.lax.scan(body, (Y, t0), None, length=N_STEPS)
        return Yf

    Yx = run(Y, jnp.asarray(0.0))
    segment = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=N_STEPS
    )
    Yp = segment(Y, 0.0)
    stage = np.load(GOLDEN)  # the stage-mode golden: must NOT be identical
    assert (
        float(np.max(np.abs(np.asarray(Yx["soil"]["vartheta_l"])
                            - stage["vartheta_l"]))) > 0.0
    )
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yx["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=f"xla/{k}",
        )
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), golden[k], rtol=1e-12, atol=1e-16,
            err_msg=f"segment/{k}",
        )


GOLDEN_IMPLICIT = os.path.join(
    os.path.dirname(__file__), "data", "golden_implicit_f64.npz"
)


def test_implicit_trbdf2_matches_golden_both_backends_and_engines():
    """TR-BDF2 at 12x the coupled golden's dt has its own frozen
    trajectory: the Thomas backend reproduces it exactly (XLA scan and
    segment runner), and the PCR backend lands within the Newton-convergence
    neighborhood (different elimination order, same fixed point)."""
    from tests.data.golden_config import build_model_and_state
    from landhydrology.imex import TRBDF2Soil

    golden = np.load(GOLDEN_IMPLICIT)
    model, Y, Ya, _ = build_model_and_state(jnp.float64)
    grid = make_function_space(model.domain, jnp.float64)
    n, dt = N_STEPS // 4, 120.0

    def run_xla(st):
        rhs = make_rhs(model, grid)
        Yc, t = Y, jnp.asarray(0.0)
        for _ in range(n):
            Yc = st.step(rhs, Yc, Ya, t, jnp.asarray(dt))
            t = t + dt
        return Yc

    st_th = TRBDF2Soil(model=model, grid=grid, iters=3, tridiag="thomas")
    Yx = run_xla(st_th)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yx["soil"][k]), golden[k], rtol=1e-13, atol=1e-18,
            err_msg=f"thomas-xla/{k}",
        )

    segment = make_segment_run(model, st_th, dt=dt, steps_per_call=n)
    Yp = segment(Y, 0.0)
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), golden[k], rtol=1e-12, atol=1e-16,
            err_msg=f"thomas-segment/{k}",
        )

    st_pcr = TRBDF2Soil(model=model, grid=grid, iters=3, tridiag="pcr")
    Yq = run_xla(st_pcr)
    np.testing.assert_allclose(
        np.asarray(Yq["soil"]["vartheta_l"]), golden["vartheta_l"],
        rtol=0, atol=1e-9,
    )
