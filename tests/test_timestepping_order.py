"""Numerical order verification of the time steppers on a smooth nonlinear
ODE with a known solution — catches any tableau/low-storage-form mistake.

Problem: y' = y * cos(t), y(0) = 1  =>  y(t) = exp(sin(t))  (scalar,
wrapped in the framework's (Y, Ya, t) state convention).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology.timestepping import (
    ForwardEuler,
    SSPRK22,
    SSPRK33,
    SSPRK104,
)


def _rhs(Y, Ya, t):
    return {"m": {"y": Y["m"]["y"] * jnp.cos(t)}}


def _solve(stepper, dt, tf=2.0):
    Y = {"m": {"y": jnp.asarray(1.0)}}
    t = jnp.asarray(0.0)
    for _ in range(int(round(tf / dt))):
        Y = stepper.step(_rhs, Y, {}, t, jnp.asarray(dt))
        t = t + dt
    return float(Y["m"]["y"])


@pytest.mark.parametrize(
    "stepper,expected_order",
    [
        (ForwardEuler(), 1),
        (SSPRK22(), 2),
        (SSPRK33(), 3),
        (SSPRK104(), 4),
    ],
)
def test_observed_convergence_order(stepper, expected_order):
    exact = float(np.exp(np.sin(2.0)))
    dts = [0.2, 0.1, 0.05]
    errs = [abs(_solve(stepper, dt) - exact) for dt in dts]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    # the asymptotic order must show up (within 0.35) on refinement
    assert orders[-1] > expected_order - 0.35, (errs, orders)
    # and errors must actually decrease
    assert errs[-1] < errs[0]


def test_ssprk104_accuracy_beats_ssprk33_per_work():
    """At matched rhs-evaluation budget (10 stages vs ~3x finer SSPRK33),
    SSPRK104 is at least as accurate on the smooth problem."""
    exact = float(np.exp(np.sin(2.0)))
    err_104 = abs(_solve(SSPRK104(), 0.2) - exact)  # 10 evals / 0.2
    err_33 = abs(_solve(SSPRK33(), 0.06) - exact)  # ~10 evals / 0.2
    assert err_104 < err_33
