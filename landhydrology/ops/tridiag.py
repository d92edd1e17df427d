"""Batched tridiagonal (Thomas) solve along the vertical axis.

The reference integrates explicitly only (SSPRK33 everywhere,
``test/runtests.jl:5-10``); this package adds an implicit vertical solver as
the backbone of IMEX stepping for the stiff Richards/heat diffusion
(SURVEY.md §7 hard part 3).  Columns are independent, so the solve is a
sequential sweep over axis 0 vectorized over all batch dims.

The sweep is **statically unrolled** over the (compile-time) vertical extent
rather than expressed as a ``lax.scan``: the unrolled form is pure static
row slicing + arithmetic that XLA can schedule as one region instead of
materializing scan carries.  The graph grows with nz, and so does compile
time: at the reference's nz=150 a TR-BDF2 step with this solver takes
minutes to compile, where :func:`pcr_solve` takes seconds.  Each row costs one reciprocal + two multiplies on the
serial dependency chain (vs. two divides for the textbook form) — the divide
latency dominates the chain, so the reciprocal form halves it.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

Array = Any


def thomas_solve(dl: Array, d: Array, du: Array, b: Array) -> Array:
    """Solve tridiagonal systems ``A x = b`` batched over trailing dims.

    ``dl`` (sub-diagonal, entry i multiplies x[i-1]; dl[0] ignored),
    ``d`` (diagonal), ``du`` (super-diagonal, entry i multiplies x[i+1];
    du[n-1] ignored), ``b``: all shape ``(n, *batch)``.

    Standard Thomas forward elimination + back substitution; no pivoting
    (diffusion systems here are strictly diagonally dominant).  The ignored
    corner entries ``dl[0]``/``du[n-1]`` are never read (no masking needed),
    and no negative indices / dynamic slices appear.
    """
    n = d.shape[0]
    if n == 1:
        return (b[0] / d[0])[None]

    inv = 1.0 / d[0]
    cp = [du[0] * inv]
    dp = [b[0] * inv]
    for i in range(1, n):
        inv = 1.0 / (d[i] - dl[i] * cp[i - 1])
        cp.append(du[i] * inv)
        dp.append((b[i] - dl[i] * dp[i - 1]) * inv)

    x = [dp[n - 1]]
    for i in range(n - 2, -1, -1):
        x.append(dp[i] - cp[i] * x[-1])
    x.reverse()
    return jnp.stack(x, axis=0)


def _shift_down(x: Array, s: int, fill: float) -> Array:
    """``y[i] = x[i-s]`` with ``fill`` for i < s (static concat)."""
    n = x.shape[0]
    pad = jnp.full_like(x[0:1], fill)
    if s >= n:
        return jnp.broadcast_to(pad, x.shape)
    return jnp.concatenate([jnp.broadcast_to(pad, x[0:s].shape), x[0 : n - s]], axis=0)


def _shift_up(x: Array, s: int, fill: float) -> Array:
    """``y[i] = x[i+s]`` with ``fill`` for i >= n-s."""
    n = x.shape[0]
    pad = jnp.full_like(x[0:1], fill)
    if s >= n:
        return jnp.broadcast_to(pad, x.shape)
    return jnp.concatenate([x[s:n], jnp.broadcast_to(pad, x[0:s].shape)], axis=0)


def pcr_solve(dl: Array, d: Array, du: Array, b: Array) -> Array:
    """Parallel cyclic reduction: same systems as :func:`thomas_solve`, but
    **latency-parallel over the vertical axis** — ceil(log2(n)) levels of
    fully elementwise ``(n, *batch)`` updates (one reciprocal + ~12
    mul/add + static shifted slices per level) instead of a 2n-long serial
    recurrence.

    Why it exists: the Thomas sweep is a serial chain of one dependent
    reciprocal-multiply per level of nz, while PCR's levels are full-array
    elementwise work that pipelines with everything else, and its graph
    is logarithmic in nz.  Rounding
    differs from Thomas at the ulp level (different elimination order);
    both are stable on the strictly diagonally dominant diffusion systems
    here, and the implicit steppers' inexact-Newton fixed point is set by
    the rhs, not the linear solve.

    At each stride ``s`` every row eliminates its +-s neighbors:

        alpha_i = -a_i / d_{i-s},  gamma_i = -c_i / d_{i+s}
        a'_i = alpha_i a_{i-s},    c'_i = gamma_i c_{i+s}
        d'_i = d_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        b'_i = b_i + alpha_i b_{i-s} + gamma_i b_{i+s}

    with out-of-range neighbors the identity row (d=1, a=c=b=0); the
    invariant ``a_i = 0 for i < s`` / ``c_i = 0 for i >= n-s`` makes the
    out-of-range contributions vanish exactly, so the edge fills never
    leak.  After the last level each equation is diagonal: x = b/d.
    """
    n = d.shape[0]
    if n == 1:
        return (b[0] / d[0])[None]
    zero = jnp.zeros_like(d[0:1])
    # enforce the ignored-corner convention (dl[0], du[n-1] never read)
    a = jnp.concatenate([zero, dl[1:n]], axis=0)
    c = jnp.concatenate([du[0 : n - 1], zero], axis=0)
    s = 1
    while s < n:
        inv_d = 1.0 / d
        alpha = -a * _shift_down(inv_d, s, 1.0)
        gamma = -c * _shift_up(inv_d, s, 1.0)
        d = (
            d
            + alpha * _shift_down(c, s, 0.0)
            + gamma * _shift_up(a, s, 0.0)
        )
        b = (
            b
            + alpha * _shift_down(b, s, 0.0)
            + gamma * _shift_up(b, s, 0.0)
        )
        a = alpha * _shift_down(a, s, 0.0)
        c = gamma * _shift_up(c, s, 0.0)
        s *= 2
    return b / d
