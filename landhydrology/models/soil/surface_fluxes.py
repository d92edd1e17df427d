"""Turbulent land-atmosphere surface fluxes via Monin-Obukhov similarity.

Replacement for the reference's SurfaceFluxes.jl /
Thermodynamics.jl dependency
(``/root/reference/src/SoilModel/boundary_conditions.jl:555-620``): a
vectorized, fixed-iteration-count MOST solver (SURVEY.md §7 hard part 4),
plus the few saturation-humidity helpers the soil model needs.

Scheme: Businger (1971) universal functions with point-value (DG-style)
profile relations as in Nishizawa & Kitamura (2018):

    x_star = kappa * (x_atm - x_sfc)
             / (ln(z/z_0) - psi(z/L) + psi(z_0/L))

iterated to a fixed point of the Obukhov length
``L = u_star^2 theta_scale / (kappa g theta_v_star)``.  Everything is
elementwise over the column batch, with a compile-time-fixed iteration
count (``lax.fori_loop``) so the solve jits and vmaps cleanly; branchy
stability functions are masked, NaN-safe selects.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from landhydrology.constants import EarthParameterSet
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.model import (
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any

#: Businger stable-regime slope and turbulent Prandtl number
_BUSINGER_A = 4.7
_PRANDTL_0 = 0.74
#: the Obukhov-length root find is an 8-point **multisection** search: each
#: round evaluates the consistency equation at 8 equally spaced interior
#: points *as one stacked (8, batch) array* and keeps the first
#: sign-change subinterval, shrinking the bracket 9x per round.  Two
#: reasons over plain bisection (which this replaced):
#:
#: - **wide rounds**: the 8 probes of a round are independent, so a round
#:   is one wide elementwise sweep; 6 rounds + a regula-falsi polish (f32)
#:   replace the ~57 dependent bisection steps of equivalent resolution;
#: - **unconditional convergence** is inherited from bracketing (a damped
#:   fixed point diverged in low-wind stable states; found by the Brent
#:   oracle in tests/soil/test_most_oracle.py).
#:
#: Rounds: 9^20 > 2^62 reaches f64 machine precision.  For f32 the right
#: target is the FLUX resolution, not the Linv bit pattern: the fluxes
#: depend on Linv only through psi(zeta), so the flux error from a
#: half-bracket of width d(zeta) is ~ psi' d(zeta)/ln(z/z0) <~ d(zeta).
#: The bracket is sign-restricted to the root's half (width _ZETA_BRACKET
#: = 50 — the root's sign is analytically sign(c0), see the solve body)
#: and finished with one regula-falsi polish over the final, single-
#: Businger-branch bracket, whose error is quadratic in the final width:
#: after 6 rounds w = 50 * 9^-6 = 9.4e-5 in zeta and the polished error
#: lands at ~w^2 ~ 1e-8, below f32 eps on every star/flux (validated: the
#: f64 Brent-oracle grid re-run in f32 agrees to ~1e-6 relative, the f32
#: representation error of the states themselves).  6 rounds + 2 thin
#: endpoint evaluations replace the former 9 rounds (50 vs 72 probe
#: h-evaluations per solve).  The count is picked from the operand dtype.
_N_SECTIONS = 8
_N_ROUNDS_F64 = 20
#: f32: 4 multisection rounds + a two-step falsi polish (see the polish
#: block in the solve body) replace the former 6 + 1 — final pre-polish
#: width 50 * 9^-4 = 7.6e-3 zeta, double-falsi error ~ w^2.6 ~ 3e-6, below
#: the f32 state representation noise (Brent-oracle-validated)
_N_ROUNDS_F32 = 4
#: f32 root-find method: "multisection" (8-point stacked probes) or
#: "illinois" (safeguarded regula falsi — fewer, thinner evaluations in a
#: longer dependent chain).  Which is faster on a given device is a
#: measurement, not a given.  f64 always runs the 20-round multisection
#: (the oracle-grade path).
_F32_METHOD = "multisection"
#: Illinois iteration count (thin h evaluations after the 2 endpoints).
#: 14 is the measured count for convergence parity with the multisection
#: on a 4k-state random grid (8 leaves ~9% of columns short near the
#: decoupling regime)
_N_ILLINOIS = 14
#: bisection bracket in zeta = z_atm/L units; beyond |zeta|=50 Businger
#: similarity has no credible solution (critical-stability decoupling) and
#: the bracketed answer saturates at the edge (a regularization, flagged by
#: the returned residual)
_ZETA_BRACKET = 50.0
#: stability-parameter clamp — keeps the universal functions in-domain
_ZETA_MIN, _ZETA_MAX = -100.0, 100.0


# --------------------------------------------------------------------------
# Moist-thermodynamics helpers (Thermodynamics.jl surface)
# --------------------------------------------------------------------------


def saturation_vapor_pressure_liquid(param_set: EarthParameterSet, T: Array) -> Array:
    """Clausius-Clapeyron saturation vapor pressure over liquid with
    constant heat capacities (Thermodynamics.jl `saturation_vapor_pressure`
    with `Liquid()`)."""
    dcp = param_set.cp_v - param_set.cp_l
    return (
        param_set.press_triple
        * (T / param_set.T_triple) ** (dcp / param_set.R_v)
        * jnp.exp(
            (param_set.LH_v0 - dcp * param_set.T_0)
            / param_set.R_v
            * (1.0 / param_set.T_triple - 1.0 / T)
        )
    )


def q_vap_saturation_liquid(
    param_set: EarthParameterSet, T: Array, rho: Array
) -> Array:
    """Saturation specific humidity over a plane liquid surface
    (Thermodynamics.jl `q_vap_saturation_generic(..., Liquid())`)."""
    return saturation_vapor_pressure_liquid(param_set, T) / (
        rho * param_set.R_v * T
    )


def cp_m(param_set: EarthParameterSet, q_tot: Array) -> Array:
    """Isobaric specific heat of moist air with all moisture in vapor
    (Thermodynamics.jl `cp_m(PhasePartition(q_tot))`)."""
    return param_set.cp_d + (param_set.cp_v - param_set.cp_d) * q_tot


# --------------------------------------------------------------------------
# Businger universal functions — masked, NaN-safe
# --------------------------------------------------------------------------


def arctan_kernel_safe(x: Array) -> Array:
    """arctan via half-angle argument reduction + odd Taylor polynomial.

    Uses only mul/add/sqrt and is accurate to ~1e-11 over the
    stability-function range; the frozen f64 golden trajectories of the
    MOST-forced configurations were generated with it."""
    s = jnp.sign(x)
    r = jnp.abs(x)
    # three half-angle reductions: atan(r) = 2 atan(r / (1 + sqrt(1 + r^2)))
    for _ in range(3):
        r = r / (1.0 + jnp.sqrt(1.0 + r * r))
    r2 = r * r
    poly = r * (
        1.0
        + r2
        * (
            -1.0 / 3.0
            + r2
            * (
                1.0 / 5.0
                + r2 * (-1.0 / 7.0 + r2 * (1.0 / 9.0 + r2 * (-1.0 / 11.0)))
            )
        )
    )
    return s * 8.0 * poly


def psi_m(zeta: Array) -> Array:
    """Integrated momentum stability function (Businger 1971)."""
    zeta = jnp.clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_un = jnp.minimum(zeta, 0.0)
    # quartic root as two sqrts: exact to ulp-level agreement with pow(x,
    # 1/4) but two cheap ops instead of an exp/log pair — the MOST root
    # find evaluates this ~2x per probe
    x = jnp.sqrt(jnp.sqrt(1.0 - 15.0 * zeta_un))
    unstable = (
        jnp.log((1.0 + x) ** 2 * (1.0 + x * x) / 8.0)
        - 2.0 * arctan_kernel_safe(x)
        + jnp.pi / 2.0
    )
    stable = -_BUSINGER_A * jnp.maximum(zeta, 0.0)
    return jnp.where(zeta < 0.0, unstable, stable)


def psi_h(zeta: Array) -> Array:
    """Integrated scalar (heat/moisture) stability function (Businger 1971)."""
    zeta = jnp.clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_un = jnp.minimum(zeta, 0.0)
    y = jnp.sqrt(1.0 - 9.0 * zeta_un)
    unstable = 2.0 * jnp.log((1.0 + y) / 2.0)
    stable = -_BUSINGER_A / _PRANDTL_0 * jnp.maximum(zeta, 0.0)
    return jnp.where(zeta < 0.0, unstable, stable)


def _arctan_reduced(r: Array) -> Array:
    """arctan for |r| <= ~0.75 (the difference-identity range): two
    half-angle reductions + the odd Taylor polynomial — error < 2e-11 over
    the domain, at a third of the general version's transcendental
    count."""
    s = jnp.sign(r)
    r = jnp.abs(r)
    for _ in range(2):
        r = r / (1.0 + jnp.sqrt(1.0 + r * r))
    r2 = r * r
    poly = r * (
        1.0
        + r2
        * (
            -1.0 / 3.0
            + r2
            * (
                1.0 / 5.0
                + r2 * (-1.0 / 7.0 + r2 * (1.0 / 9.0 + r2 * (-1.0 / 11.0)))
            )
        )
    )
    return s * 4.0 * poly


def psi_m_diff(zeta: Array, zeta_0: Array) -> Array:
    """``psi_m(zeta) - psi_m(zeta_0)`` for same-sign pairs (``zeta_0`` is
    always ``zeta * z_0/z_atm``) — the only form the MOST solve consumes.

    Algebraically identical to the two-call difference but with the
    dominant transcendentals fused: the two logs combine into one log of a
    ratio, and ``atan x - atan x_0 = atan((x - x_0)/(1 + x x_0))`` (valid
    here since x, x_0 >= 1) needs ONE arctan of a small argument, where the
    general form needs two full-range arctans.  This halves the hot cost
    of every multisection probe (mathematically exact rewrite; floating-
    point results differ at ulp level only)."""
    zeta = jnp.clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_0 = jnp.clip(zeta_0, _ZETA_MIN, _ZETA_MAX)
    x = jnp.sqrt(jnp.sqrt(1.0 - 15.0 * jnp.minimum(zeta, 0.0)))
    x0 = jnp.sqrt(jnp.sqrt(1.0 - 15.0 * jnp.minimum(zeta_0, 0.0)))
    one_px = 1.0 + x
    one_px0 = 1.0 + x0
    ratio = (one_px * one_px * (1.0 + x * x)) / (
        one_px0 * one_px0 * (1.0 + x0 * x0)
    )
    atan_arg = (x - x0) / (1.0 + x * x0)
    unstable = jnp.log(ratio) - 2.0 * _arctan_reduced(atan_arg)
    stable = -_BUSINGER_A * (jnp.maximum(zeta, 0.0) - jnp.maximum(zeta_0, 0.0))
    return jnp.where(zeta < 0.0, unstable, stable)


def psi_h_diff(zeta: Array, zeta_0: Array) -> Array:
    """``psi_h(zeta) - psi_h(zeta_0)`` for same-sign pairs — one log of a
    ratio instead of two (see :func:`psi_m_diff`)."""
    zeta = jnp.clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_0 = jnp.clip(zeta_0, _ZETA_MIN, _ZETA_MAX)
    y = jnp.sqrt(1.0 - 9.0 * jnp.minimum(zeta, 0.0))
    y0 = jnp.sqrt(1.0 - 9.0 * jnp.minimum(zeta_0, 0.0))
    unstable = 2.0 * jnp.log((1.0 + y) / (1.0 + y0))
    stable = (
        -_BUSINGER_A
        / _PRANDTL_0
        * (jnp.maximum(zeta, 0.0) - jnp.maximum(zeta_0, 0.0))
    )
    return jnp.where(zeta < 0.0, unstable, stable)


# --------------------------------------------------------------------------
# The MOST fixed-point solve
# --------------------------------------------------------------------------


def surface_conditions(
    param_set: EarthParameterSet,
    u_atm: Array,
    theta_atm: Array,
    q_atm: Array,
    u_sfc: Array,
    theta_sfc: Array,
    q_sfc: Array,
    z_atm: Array,
    z_0m: Array,
    z_0s: Array,
    theta_scale: Array,
) -> dict:
    """Solve MOST for the scales ``(u_star, theta_star, q_star)`` and the
    Obukhov length ``L`` (the role of SurfaceFluxes.jl `surface_conditions`,
    ``boundary_conditions.jl:595-604``).

    Fully vectorized over any broadcastable batch of columns: a fixed-round
    8-point **multisection** root find of the Obukhov consistency equation
    ``f(1/L) = 1/L - kappa g theta_v_star / (u_star^2 theta_scale)`` on the
    bracket ``|zeta| <= _ZETA_BRACKET`` (see the ``_N_SECTIONS`` note for
    why multisection) — branch-free, so it jits and vmaps.  Bracketing
    converges unconditionally to the first sign change; the
    returned ``residual`` is the final half-bracket width on 1/L (machine
    precision when a root exists; large when the state sits in the
    critical-stability decoupling regime where the bracketed answer
    saturates at the edge).  Validated against an independent scipy Brent
    solve in ``tests/soil/test_most_oracle.py``.
    """
    kappa = param_set.von_karman_const
    g = param_set.grav
    du = u_atm - u_sfc
    dtheta = theta_atm - theta_sfc
    dq = q_atm - q_sfc

    log_m = jnp.log(z_atm / z_0m)
    log_s = jnp.log(z_atm / z_0s)

    # derive the batch-shaped zero from the inputs so it inherits their
    # sharding/varying-axes under shard_map (a fresh jnp.zeros would be
    # unvarying and break the loop's carry typing)
    zero = (
        du * 0.0 + dtheta * 0.0 + dq * 0.0 + z_atm * 0.0 + z_0m * 0.0
        + z_0s * 0.0 + theta_scale * 0.0
    )

    def denoms(Linv):
        zeta = z_atm * Linv
        zeta_0m = z_0m * Linv
        zeta_0s = z_0s * Linv
        denom_m = log_m - psi_m_diff(zeta, zeta_0m)
        # scalar profile carries the turbulent Prandtl number:
        # phi_h(0) = Pr_0 (Businger), so the integrated denominator is
        # Pr_0 * (ln(z/z0) - psi_h(zeta) + psi_h(zeta_0)) with psi_h in its
        # Pr-stripped form
        denom_s = _PRANDTL_0 * (log_s - psi_h_diff(zeta, zeta_0s))
        # keep denominators away from 0 (can cross in extreme instability)
        denom_m = jnp.maximum(denom_m, 1e-3)
        denom_s = jnp.maximum(denom_s, 1e-3)
        return denom_m, denom_s

    def stars(Linv):
        denom_m, denom_s = denoms(Linv)
        u_star = kappa * du / denom_m
        theta_star = kappa * dtheta / denom_s
        q_star = kappa * dq / denom_s
        return u_star, theta_star, q_star

    eps_vi = param_set.molmass_ratio - 1.0  # ~0.608
    # hoisted constant of the consistency equation: the buoyancy numerator
    # kappa^2 g [(1+eps q_atm) dtheta + eps theta_scale dq] / theta_scale
    # (one div per column, OUTSIDE the multisection loop)
    b_const = (1.0 + eps_vi * q_atm) * dtheta + eps_vi * theta_scale * dq
    c0 = kappa * kappa * g * b_const / theta_scale
    kdu = kappa * du

    def f(Linv):
        u_star, theta_star, q_star = stars(Linv)
        # virtual potential temperature scale (moisture buoyancy included)
        theta_v_star = (
            theta_star * (1.0 + eps_vi * q_atm) + eps_vi * theta_scale * q_star
        )
        u_star_safe = jnp.maximum(u_star, 1e-6)
        return Linv - kappa * g * theta_v_star / (u_star_safe**2 * theta_scale)

    def h(Linv):
        """The consistency equation cleared of divisions: ``f`` multiplied
        through by the (strictly positive) ``denom_s * u_star_safe^2 *
        denom_m^2``, so

            h = Linv * denom_s * M^2 - c0 * denom_m^2,
            M = max(kappa du, 1e-6 denom_m)   [= u_star_safe * denom_m].

        Same roots and same signs as ``f`` everywhere — but each
        multisection probe costs zero array divides (the old form spent
        4 per probe: u*, theta*, q*, and the final quotient)."""
        denom_m, denom_s = denoms(Linv)
        M = jnp.maximum(kdu, 1e-6 * denom_m)
        return Linv * denom_s * (M * M) - c0 * (denom_m * denom_m)

    # The root's sign is known ANALYTICALLY: at any root of h,
    # Linv = c0 * denom_m^2 / (denom_s * M^2) with every factor on the
    # right strictly positive except c0 — so sign(Linv_root) = sign(c0),
    # and c0 == 0 is the exactly neutral solution Linv = 0.  Restricting
    # the bracket to the root's half [0, sgn*B] therefore loses no roots,
    # halves the starting width (a factor-2 head start, ~log9(2) = 0.32 of
    # a 9x round — the accuracy budget itself rests on the quadratic
    # regula-falsi polish below, oracle-validated), and
    # makes h SINGLE-BRANCHED over the whole bracket (stable-only or
    # unstable-only Businger form, no kink at zeta = 0 inside it) — the
    # smoothness the terminal regula-falsi polish below relies on.
    B = _ZETA_BRACKET / z_atm + zero
    sgn = jnp.sign(c0)
    lo = jnp.minimum(sgn, 0.0) * B
    hi = jnp.maximum(sgn, 0.0) * B
    # only the SIGN of h(lo) matters: every kept subinterval has its left
    # endpoint on the same side of the (first) root as the original lo, so
    # s_lo is loop-invariant and h never needs re-evaluating at an endpoint
    s_lo = jnp.sign(h(lo))
    s_lo = jnp.where(s_lo == 0.0, 1.0, s_lo)
    n_rounds = (
        _N_ROUNDS_F64 if zero.dtype == jnp.float64 else _N_ROUNDS_F32
    )
    if zero.dtype != jnp.float64 and _F32_METHOD == "illinois":
        # --- Illinois (safeguarded regula falsi) f32 path ---
        # Each stacked multisection probe evaluates h at 8 points; Illinois
        # converges superlinearly on the smooth single-branch h over the
        # sign-restricted bracket in ~8 THIN evaluations (10 including the
        # endpoints): fewer evaluations per solve than 4 stacked rounds +
        # polish, at the price of a longer dependent chain.  Accuracy is
        # pinned by the same Brent oracle
        # (tests/soil/test_most_oracle.py runs the grid under BOTH
        # methods).
        lo0, hi0 = lo, hi
        a, b_ = lo, hi
        fa = h(a)
        fb = h(b_)
        bracketed = fa * fb <= 0.0
        prev_left = None
        for _i in range(_N_ILLINOIS):
            den = fb - fa
            ok = jnp.abs(den) > 0.0
            x = (a * fb - b_ * fa) / jnp.where(ok, den, 1.0)
            x = jnp.clip(jnp.where(ok, x, 0.5 * (a + b_)), a, b_)
            fx = h(x)
            left = fa * fx <= 0.0  # root in [a, x]
            if prev_left is not None:
                # Illinois anti-stagnation: replacing the SAME endpoint
                # twice halves the stale endpoint's value, forcing the
                # secant through the interval
                same = left == prev_left
                fa = jnp.where(left & same, 0.5 * fa, fa)
                fb = jnp.where((~left) & same, 0.5 * fb, fb)
            a, fa, b_, fb = (
                jnp.where(left, a, x),
                jnp.where(left, fa, fx),
                jnp.where(left, x, b_),
                jnp.where(left, fx, fb),
            )
            prev_left = left
        den = fb - fa
        ok = bracketed & (jnp.abs(den) > 0.0)
        Linv = jnp.clip(
            (a * fb - b_ * fa) / jnp.where(ok, den, 1.0), a, b_
        )
        # no sign change in the bracket (critical-stability decoupling /
        # exact neutral): same midpoint regularization + large-residual
        # flag as the multisection path
        Linv = jnp.where(ok, Linv, 0.5 * (lo0 + hi0))
        delta = 0.5 * (b_ - a)
        return _finish_surface_conditions(
            param_set, Linv, delta, denoms, f, du, dtheta, dq
        )
    k = _N_SECTIONS
    inv = 1.0 / (k + 1.0)

    def body(i, carry):
        lo, hi = carry
        w = hi - lo
        # (k, batch) probe stack built from Python-float coefficients
        mids = jnp.stack([lo + ((r + 1.0) * inv) * w for r in range(k)])
        h_mids = h(mids)
        # j = number of leading probes still on lo's side (prefix-AND,
        # unrolled over the static k — no gathers)
        alive = h_mids[0] * s_lo > 0.0
        j = alive.astype(zero.dtype)
        for r in range(1, k):
            alive = alive & (h_mids[r] * s_lo > 0.0)
            j = j + alive.astype(zero.dtype)
        # equally spaced probes: the bracketing subinterval is
        # [lo + j w/(k+1), lo + (j+1) w/(k+1)] without any indexing
        lo_next = lo + j * inv * w
        hi_next = lo + jnp.minimum(j + 1.0, k + 1.0) * inv * w
        return (lo_next, hi_next)

    if n_rounds <= 8:
        # statically unroll the f32 rounds: a fori_loop lowers to a while
        # loop, a scheduling barrier between the probe evaluations and the
        # independent nz-wide soil sweep of the same rhs; unrolled, the
        # whole step is one region the compiler can fuse and interleave.
        # f64 (20 rounds) keeps the compact loop, where compile size
        # matters more.
        carry = (lo, hi)
        for _i in range(n_rounds):
            carry = body(_i, carry)
        lo, hi = carry
    else:
        lo, hi = jax.lax.fori_loop(0, n_rounds, body, (lo, hi))
    # Terminal regula-falsi polish: one false-position step on the final
    # bracket.  h is smooth (single Businger branch) over the sign-
    # restricted bracket, so the polished error is O(w^2 h''/h') for final
    # width w — this is what lets the f32 round count drop from 9 to
    # _N_ROUNDS_F32 while keeping every star/flux at f32 machine accuracy
    # (validated against the f64 scipy-Brent oracle grid,
    # tests/soil/test_most_oracle.py).  Where the bracket holds no sign
    # change (critical-stability decoupling: the multisection collapsed
    # onto an edge) or is degenerate (c0 == 0: the exact neutral root
    # Linv = 0), fall back to the midpoint — same regularization + large
    # |f| residual flag as before.
    h_lo2 = h(lo)
    h_hi2 = h(hi)
    if n_rounds == _N_ROUNDS_F32:
        # f32 runs 4 multisection rounds + TWO falsi steps instead of the
        # former 6 + 1: the second false-position iteration is superlinear
        # (error ~ w^2.6 for final width w = 50 * 9^-4 = 7.6e-3 in zeta ->
        # ~3e-6, still below the f32 state noise the Brent oracle measures)
        # and costs ONE extra (1, batch) h evaluation, where the two extra
        # rounds cost 16 stacked probes + 2 bracket reductions on the
        # serial chain — 26% fewer probe evaluations per solve, the hot
        # cost of the land model's surface exchange.
        den1 = h_hi2 - h_lo2
        ok1 = (h_lo2 * h_hi2 <= 0.0) & (jnp.abs(den1) > 0.0)
        x1 = (lo * h_hi2 - hi * h_lo2) / jnp.where(ok1, den1, 1.0)
        x1 = jnp.clip(x1, lo, hi)
        h1 = h(x1)
        # keep the sign-change subinterval around x1 (falls back to the
        # original bracket when ok1 is false — the same degenerate cases)
        left = h_lo2 * h1 <= 0.0
        lo_n = jnp.where(ok1 & ~left, x1, lo)
        hlo_n = jnp.where(ok1 & ~left, h1, h_lo2)
        hi_n = jnp.where(ok1 & left, x1, hi)
        hhi_n = jnp.where(ok1 & left, h1, h_hi2)
        lo, hi, h_lo2, h_hi2 = lo_n, hi_n, hlo_n, hhi_n
    den = h_hi2 - h_lo2
    use_falsi = (h_lo2 * h_hi2 <= 0.0) & (jnp.abs(den) > 0.0)
    Linv_falsi = (lo * h_hi2 - hi * h_lo2) / jnp.where(use_falsi, den, 1.0)
    Linv_falsi = jnp.clip(Linv_falsi, lo, hi)
    Linv = jnp.where(use_falsi, Linv_falsi, 0.5 * (lo + hi))
    delta = 0.5 * (hi - lo)
    return _finish_surface_conditions(
        param_set, Linv, delta, denoms, f, du, dtheta, dq
    )


def _finish_surface_conditions(param_set, Linv, delta, denoms, f, du, dtheta, dq):
    """Shared epilogue of :func:`surface_conditions`: stars, Obukhov
    length, and the convergence monitor from the solved ``Linv``."""
    kappa = param_set.von_karman_const
    denom_m, denom_s = denoms(Linv)
    u_star = kappa * du / denom_m
    theta_star = kappa * dtheta / denom_s
    q_star = kappa * dq / denom_s
    L = jnp.where(jnp.abs(Linv) > 1e-30, 1.0 / Linv, jnp.inf)
    # convergence monitor: half-bracket width AND the consistency-equation
    # defect — in the decoupling regime bisection collapses onto a bracket
    # edge with a tiny width but a large defect, and the defect flags it
    return {
        "x_star": (u_star, theta_star, q_star),
        "L_mo": L,
        "residual": jnp.maximum(jnp.abs(delta), jnp.abs(f(Linv))),
        # the converged profile denominators: fluxes for any OTHER surface
        # humidity over the same (wind, temperature) state are linear in
        # q_sfc through kappa (q_atm - q_sfc) / denom_s — what the blended
        # pond/bare-soil split consumes (compute_blended_surface_fluxes)
        "denoms": (denom_m, denom_s),
    }


# --------------------------------------------------------------------------
# The soil-facing flux computation (boundary_conditions.jl:555-620)
# --------------------------------------------------------------------------


def _resolve_atmos(atmos, t):
    """Atmospheric-state fields of the top BC may be constants, per-column
    arrays, or callables of time (diurnal cycles / reanalysis forcing —
    the extension the reference anticipates at
    ``boundary_conditions.jl:113-114``); resolve callables at ``t``."""
    import dataclasses as _dc

    if any(callable(getattr(atmos, f.name)) for f in _dc.fields(atmos)):
        atmos = _dc.replace(
            atmos,
            **{
                f.name: (
                    getattr(atmos, f.name)(t)
                    if callable(getattr(atmos, f.name))
                    else getattr(atmos, f.name)
                )
                for f in _dc.fields(atmos)
            },
        )
    return atmos


def _soil_surface_humidity(model, hydrology, vartheta_l, theta_i, T, rho_a):
    """(q_sat, q_surf): saturation humidity at the surface and the
    soil-moisture-corrected surface specific humidity
    ``q_surf = q_sat exp(g psi / R_v T)``
    (``boundary_conditions.jl:575-587``)."""
    sp = model.soil_param_set
    param_set = model.earth_param_set
    hm = hydrology.hydraulic_model
    q_sat = q_vap_saturation_liquid(param_set, T, rho_a)
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
    S_l_eff = jnp.minimum(
        sw.effective_saturation(nu_eff, theta_l, hm.theta_r), 1.0
    )
    psi = sw.matric_potential(hm, S_l_eff)
    correction = jnp.exp(param_set.grav * psi / param_set.R_v / T)
    return q_sat, q_sat * correction


def _require_dynamic(energy, hydrology):
    if not isinstance(energy, SoilEnergyModel) or not isinstance(
        hydrology, SoilHydrologyModel
    ):
        raise TypeError(
            "Turbulent surface fluxes require dynamic SoilEnergyModel and "
            "SoilHydrologyModel components."
        )


def _assemble_fluxes(param_set, atmos, T, q_sfc, u_star, t_star, q_star):
    """(heat flux, water volume flux), positive along +z, from the MOST
    scales (``boundary_conditions.jl:606-619``)."""
    cpm = cp_m(param_set, q_sfc)
    T_ref = param_set.T_0
    h_d = param_set.cp_d * (T - T_ref) + param_set.R_d * T_ref
    E = -atmos.rho_a_sfc * u_star * q_star
    dry_static_energy_flux = -cpm * atmos.rho_a_sfc * u_star * t_star - h_d * E
    vapor_static_energy_flux = (
        param_set.cp_v * (T - T_ref) + param_set.LH_v0
    ) * E
    E_vol = E / param_set.rho_cloud_liq  # soil model needs a volume flux
    return dry_static_energy_flux + vapor_static_energy_flux, E_vol


def compute_turbulent_surface_fluxes(
    energy,
    hydrology,
    model: SoilModel,
    vartheta_l: Array,
    theta_i: Array,
    T: Array,
    t: Array = 0.0,
) -> tuple:
    """Surface (heat flux, water volume flux) from MOST given the soil
    surface state (cf. ``boundary_conditions.jl:555-620``).

    Requires dynamic energy + hydrology components (the reference raises a
    MethodError otherwise; ``test_prescribed_atmos_bc.jl:161-184``).
    Returns fluxes positive along +z (upward).

    Atmospheric-state fields of the top BC may be constants, per-column
    arrays, or callables of time; ``t`` is forwarded to them (see
    :func:`_resolve_atmos`).
    """
    _require_dynamic(energy, hydrology)
    atmos = _resolve_atmos(model.boundary_conditions.top, t)
    sp = model.soil_param_set
    param_set = model.earth_param_set

    _, q_surf = _soil_surface_humidity(
        model, hydrology, vartheta_l, theta_i, T, atmos.rho_a_sfc
    )

    conditions = surface_conditions(
        param_set,
        u_atm=atmos.u_atm,
        theta_atm=atmos.theta_atm,
        q_atm=atmos.q_atm,
        u_sfc=jnp.zeros_like(T),
        theta_sfc=T,
        q_sfc=q_surf,
        z_atm=atmos.z_atm,
        z_0m=sp.z_0m,
        z_0s=sp.z_0s,
        theta_scale=atmos.theta_scale,
    )
    u_star, t_star, q_star = conditions["x_star"]
    return _assemble_fluxes(param_set, atmos, T, q_surf, u_star, t_star, q_star)


def compute_blended_surface_fluxes(
    energy,
    hydrology,
    model: SoilModel,
    vartheta_l: Array,
    theta_i: Array,
    T: Array,
    w: Array,
    t: Array = 0.0,
) -> dict:
    """Pond/bare-soil surface fluxes from ONE MOST solve over a blended
    surface — the LandModel exchange's hot path.

    The surface is a fraction ``w`` ponded (saturated, ``q_sfc = q_sat``)
    and ``1-w`` bare soil (moisture-corrected ``q_sfc = q_sat exp(g psi /
    R_v T)``); both share the soil surface temperature and the wind.  The
    Monin-Obukhov similarity solve therefore sees ONE effective surface
    humidity

        q_eff = (1-w) q_soil + w q_sat

    — physically, one atmospheric surface layer over a partially ponded
    surface — where the previous design ran two full multisection solves
    (bare-soil and pond) and blended the resulting fluxes.  At ``w = 0``
    and ``w = 1`` the blended solve is *bitwise* the corresponding
    single-surface solve (``q_eff`` degenerates exactly); for
    ``0 < w < 1`` (the thin transition band ``h_s < h_evap_smoothing``)
    it differs from flux-blending by O(w(1-w) (q_soil-q_sat)^2) through
    the solve's nonlinearity — far inside the MOST closure uncertainty —
    while costing HALF the exchange.

    The per-component split is exact: given the converged scales, the
    latent flux is linear in the surface humidity
    (``q_star_c = kappa (q_atm - q_c) / denom_s``), so

        E_eff = (1-w) E_soil + w E_pond

    holds identically and the water budget closes by construction
    (``tests/test_land_model.py::test_rain_pond_evaporation_budget_closes``).

    Returns ``{"heat_flux", "evap_soil", "evap_pond"}`` with
    ``evap_soil = (1-w) E_soil``, ``evap_pond = w E_pond`` (already
    weighted, volume fluxes positive upward) and ``heat_flux`` the
    w-blended surface energy flux.
    """
    _require_dynamic(energy, hydrology)
    atmos = _resolve_atmos(model.boundary_conditions.top, t)
    sp = model.soil_param_set
    param_set = model.earth_param_set

    q_sat, q_soil = _soil_surface_humidity(
        model, hydrology, vartheta_l, theta_i, T, atmos.rho_a_sfc
    )
    one_m_w = 1.0 - w
    q_eff = one_m_w * q_soil + w * q_sat

    conditions = surface_conditions(
        param_set,
        u_atm=atmos.u_atm,
        theta_atm=atmos.theta_atm,
        q_atm=atmos.q_atm,
        u_sfc=jnp.zeros_like(T),
        theta_sfc=T,
        q_sfc=q_eff,
        z_atm=atmos.z_atm,
        z_0m=sp.z_0m,
        z_0s=sp.z_0s,
        theta_scale=atmos.theta_scale,
    )
    u_star, t_star, _ = conditions["x_star"]
    _, denom_s = conditions["denoms"]
    kappa = param_set.von_karman_const
    # per-component humidity scales at the converged profile
    r_s = kappa / denom_s
    q_star_soil = (atmos.q_atm - q_soil) * r_s
    q_star_pond = (atmos.q_atm - q_sat) * r_s

    heat_soil, E_soil = _assemble_fluxes(
        param_set, atmos, T, q_soil, u_star, t_star, q_star_soil
    )
    heat_pond, E_pond = _assemble_fluxes(
        param_set, atmos, T, q_sat, u_star, t_star, q_star_pond
    )
    return {
        "heat_flux": one_m_w * heat_soil + w * heat_pond,
        "evap_soil": one_m_w * E_soil,
        "evap_pond": w * E_pond,
    }
