"""Implicit vertical solver — IMEX stepping for the stiff diffusion.

The reference integrates explicitly only (SSPRK33 everywhere; dt down to
1e-4 s in the heat test, 0.25 s in the infiltration test) and its north star
asks for IMEX (SURVEY.md §7 hard part 3).  Columns are independent, so the
implicit solve is a batched per-column tridiagonal system
(:func:`~landhydrology.ops.tridiag.thomas_solve`).

:class:`BackwardEulerRichards` advances the Richards equation with backward
Euler + inexact (modified-Picard / Newton) iterations:

    g(v) = v - v^n - dt f(v) = 0,
    (I - dt A) delta = v^n - v^m + dt f(v^m),   v^{m+1} = v^m + delta

where ``f`` is the *exact* rhs (including the full BC flux conversion — the
fixed point is therefore exact) and ``A`` is the frozen-coefficient
linearization of the vertical diffusion,

    (A delta)_i = [K_{i+1/2}(C_{i+1} d_{i+1} - C_i d_i)
                   - K_{i-1/2}(C_i d_i - C_{i-1} d_{i-1})] / dz^2,

with ``C = d psi / d vartheta_l`` obtained by automatic differentiation of
the pressure-head closure (the NaN-safe masked branches of ``water.py`` make
this derivative well-defined across the saturation boundary).  Boundary
faces carry no Jacobian contribution (inexact for Dirichlet; affects only
the convergence rate, not the converged solution).

Stability: unconditionally stable in dt; accuracy first-order.  Typical use:
dt 20-100x the explicit CFL limit with 2-3 iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from landhydrology.domains import ColumnGrid
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.model import SoilHydrologyModel, SoilModel
from landhydrology.ops.stencil import interp_c2f_interior
from landhydrology.ops.tridiag import pcr_solve, thomas_solve
from landhydrology.timestepping import AbstractTimestepper

Array = Any


def _backward_euler_delta(
    K: Array,
    C: Array,
    b: Array,
    dt: Array,
    grid: ColumnGrid,
    diag_boost_bot: Array = 0.0,
    diag_boost_top: Array = 0.0,
    solver: str = "thomas",
) -> Array:
    """Solve ``(I - dt A) delta = b`` for one frozen-coefficient diffusion
    linearization — the shared tridiagonal assembly of the implicit
    steppers.

    ``A`` is the vertical diffusion Jacobian with center coefficient ``K``
    (interpolated to faces, zero at the boundary faces) and pointwise state
    derivative ``C`` (``d psi/d vartheta`` for water, ``1/rho_c_s`` for
    heat):

        (A d)_i = [K_{i+1/2}(C_{i+1} d_{i+1} - C_i d_i)
                   - K_{i-1/2}(C_i d_i - C_{i-1} d_{i-1})] / dz^2

    ``diag_boost_*`` add the (negative) Dirichlet boundary-face diagonal
    terms ``-K_face C_i / (dz_half dz)``.
    """
    dz = grid.dz
    nz = K.shape[0]
    if nz == 1:
        # single-cell column: no interior faces, the system is diagonal
        # (the three-part concat below would duplicate the lone row)
        d = 1.0 - dt * (diag_boost_bot + diag_boost_top)
        return b / d
    Kf = interp_c2f_interior(K)  # (nz-1, *batch) interior faces
    zeros = jnp.zeros_like(K[0:1])
    K_minus = jnp.concatenate([zeros, Kf], axis=0)  # face below cell i
    K_plus = jnp.concatenate([Kf, zeros], axis=0)  # face above cell i

    inv_dz2 = 1.0 / (dz * dz)
    diag_A = -(K_minus + K_plus) * C * inv_dz2
    # neighbor C shifts as static concatenations; the wrap rows are
    # multiplied by the zero boundary faces, so any in-range value works
    # there
    C_down = jnp.concatenate([C[0:1], C[0 : nz - 1]], axis=0)  # C[i-1]
    C_up = jnp.concatenate([C[1:nz], C[nz - 1 : nz]], axis=0)  # C[i+1]
    sub_A = K_minus * C_down * inv_dz2
    sup_A = K_plus * C_up * inv_dz2
    # Dirichlet boundary-face diagonal boosts on the first/last rows only
    diag_A = jnp.concatenate(
        [
            diag_A[0:1] + diag_boost_bot,
            diag_A[1 : nz - 1],
            diag_A[nz - 1 : nz] + diag_boost_top,
        ],
        axis=0,
    )

    dl = -dt * sub_A
    d = 1.0 - dt * diag_A
    du = -dt * sup_A
    if solver == "pcr":
        return pcr_solve(dl, d, du, b)
    if solver != "thomas":
        raise ValueError(f"unknown tridiagonal solver {solver!r}")
    return thomas_solve(dl, d, du, b)


def _dpsi_dtheta(hm, vartheta_l: Array, nu_eff: Array, S_s: Array) -> Array:
    """Elementwise C = d psi / d vartheta_l via AD of the pressure-head
    closure (pointwise, so grad-of-sum gives the elementwise derivative)."""
    def total(v):
        return jnp.sum(sw.pressure_head(hm, v, nu_eff, S_s))

    return jax.grad(total)(vartheta_l)


def _water_newton_sweep(
    model, grid, rhs, Ybase: dict, Ya: dict, v_m: Array,
    c_const: Array, w: Array, t_eval: Array, solver: str = "thomas",
) -> Array:
    """One frozen-coefficient Newton update for the water **stage equation**

        v = c_const + w * f_w(v)    (other state variables frozen at Ybase)

    i.e. solve ``(I - w A) delta = c_const - v_m + w f(v_m)``.  Backward
    Euler is the special case ``c_const = v^n, w = dt``; the TR-BDF2 stages
    use their own (c_const, w).
    """
    name = model.name
    hydrology = model.hydrology_model
    hm = hydrology.hydraulic_model
    sp = model.soil_param_set
    dz = grid.dz
    theta_i = Ybase[name]["theta_i"]

    Ym = {name: dict(Ybase[name], vartheta_l=v_m)}
    f = rhs(Ym, Ya, t_eval)[name]["vartheta_l"]

    # frozen coefficients at the current iterate
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(v_m, nu_eff)
    f_i = sw.ice_fraction_of_water(theta_l, theta_i)
    if isinstance(hydrology.viscosity_factor, sw.TemperatureDependentViscosity):
        if "rho_e_int" in Ybase[name]:
            # dynamic energy: diagnose T from the energy state
            from landhydrology.models.soil import heat as sh

            rho_c_s = sh.volumetric_heat_capacity(
                theta_l, theta_i, sp.rho_c_ds, model.earth_param_set
            )
            T = sh.temperature_from_rho_e_int(
                Ybase[name]["rho_e_int"], theta_i, rho_c_s,
                model.earth_param_set,
            )
        else:
            T = jnp.broadcast_to(Ya[name]["T"], v_m.shape)
    else:
        T = jnp.ones_like(v_m)  # NoEffect: value irrelevant
    visc = sw.viscosity_factor(hydrology.viscosity_factor, T)
    imp = sw.impedance_factor(hydrology.impedance_factor, f_i)
    S = sw.effective_saturation(sp.nu, v_m, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, visc, imp)
    C = _dpsi_dtheta(hm, v_m, nu_eff, sp.S_s)

    # Dirichlet boundary faces contribute a stabilizing diagonal
    # term -K_face C_i / (dz_half * dz).  K_face is evaluated at the
    # Dirichlet state (boundary_conditions.jl:395 uses K[face]) — in
    # dry-soil infiltration it is orders of magnitude larger than
    # the center K, and the half-cell distance doubles the weight;
    # omitting either lets the Newton step overshoot at sharp fronts.
    from landhydrology.models.soil.boundary import Dirichlet, _value_at

    bcs = model.boundary_conditions
    dz_half = grid.dz_boundary
    nz_top = v_m.shape[0] - 1

    def k_at_value(v_dir):
        S_f = sw.effective_saturation(sp.nu, v_dir, hm.theta_r)
        return sw.hydraulic_conductivity(
            hm, S_f, jnp.ones_like(S_f), jnp.ones_like(S_f)
        )

    boost_bot = boost_top = 0.0
    bc_bot = getattr(bcs.bottom, "hydrology", None)
    bc_top = getattr(bcs.top, "hydrology", None)
    if isinstance(bc_bot, Dirichlet):
        K_f = k_at_value(_value_at(bc_bot.state_value, t_eval))
        boost_bot = -K_f * C[0] / (dz_half * dz)
    if isinstance(bc_top, Dirichlet):
        K_f = k_at_value(_value_at(bc_top.state_value, t_eval))
        boost_top = -K_f * C[nz_top] / (dz_half * dz)

    b = c_const - v_m + w * f
    delta = _backward_euler_delta(
        K, C, b, w, grid, boost_bot, boost_top, solver=solver
    )
    # trust region: one frozen-coefficient Newton update moving vartheta_l
    # by more than ~half the porosity is outside the linearization's
    # validity — at very large dt on coarse grids the unclamped iterate
    # can oscillate divergently (measured: +-6e3 at 40x CFL, nz=16).
    # The bound scales with the column's own porosity (per-column nu
    # broadcasts), so high-porosity soils keep their legitimately larger
    # updates.  Inactive near convergence (delta -> 0): converged fixed
    # points and temporal order are untouched.
    lim = 0.5 * sp.nu
    delta = jnp.clip(delta, -lim, lim)
    return v_m + delta


def _heat_newton_sweep(
    model, grid, rhs, Ybase: dict, Ya: dict, e_m: Array,
    c_const: Array, w: Array, t_eval: Array, solver: str = "thomas",
) -> Array:
    """One frozen-coefficient Newton update for the heat stage equation
    ``e = c_const + w * f_e(e)`` (water/ice frozen at Ybase); linear in the
    conduction term, so a single sweep is exact for pure conduction."""
    from landhydrology.models.soil.boundary import Dirichlet
    from landhydrology.models.soil.rhs import energy_center_fields

    name = model.name
    sp = model.soil_param_set
    theta_i = Ybase[name]["theta_i"]
    v_base = Ybase[name]["vartheta_l"]
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(v_base, nu_eff)

    Ym = {name: dict(Ybase[name], rho_e_int=e_m)}
    f = rhs(Ym, Ya, t_eval)[name]["rho_e_int"]
    _, kappa, rho_c_s = energy_center_fields(
        model, theta_l, theta_i, rho_e_int=e_m
    )
    C = 1.0 / rho_c_s  # dT/d rho_e_int

    bcs = model.boundary_conditions
    dz = grid.dz
    dz_half = grid.dz_boundary
    top = e_m.shape[0] - 1
    boost_bot = boost_top = 0.0
    if isinstance(getattr(bcs.bottom, "energy", None), Dirichlet):
        boost_bot = -kappa[0] * C[0] / (dz_half * dz)
    if isinstance(getattr(bcs.top, "energy", None), Dirichlet):
        boost_top = -kappa[top] * C[top] / (dz_half * dz)

    b = c_const - e_m + w * f
    delta = _backward_euler_delta(
        kappa, C, b, w, grid, boost_bot, boost_top, solver=solver
    )
    return e_m + delta


@dataclasses.dataclass(frozen=True)
class BackwardEulerRichards(AbstractTimestepper):
    """Backward-Euler Richards stepper with frozen-coefficient Newton
    iterations and a batched Thomas solve.

    Applies the implicit update to ``vartheta_l``; any other prognostic
    variables present (theta_i, rho_e_int) are advanced explicitly with
    their rhs tendencies (IMEX splitting: the water diffusion carries the
    stiffness).
    """

    model: SoilModel
    grid: ColumnGrid
    iters: int = 2
    #: tridiagonal backend: "thomas" (serial sweep) or "pcr" (parallel
    #: cyclic reduction — latency-parallel over nz; see ops/tridiag.py)
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 1

    @property
    def stages(self) -> int:
        return self.iters

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        v_new = self.water_solve(rhs, Y, Ya, t, dt)
        model = self.model
        name = model.name
        t_new = t + dt
        out = dict(Y[name], vartheta_l=v_new)
        # explicit update for any remaining prognostic variables
        if "rho_e_int" in Y[name] or "theta_i" in Y[name]:
            Ym = {name: dict(Y[name], vartheta_l=v_new)}
            f_all = rhs(Ym, Ya, t_new)[name]
            for k in Y[name]:
                if k != "vartheta_l":
                    out[k] = Y[name][k] + dt * f_all[k]
        return {name: out}

    def water_solve(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> Array:
        """The implicit Newton update of ``vartheta_l`` alone (shared with
        :class:`BackwardEulerSoil`, which advances the other variables
        implicitly itself)."""
        model, grid = self.model, self.grid
        name = model.name
        if not isinstance(model.hydrology_model, SoilHydrologyModel):
            raise TypeError("BackwardEulerRichards needs a dynamic hydrology model")
        t_new = t + dt
        v_n = Y[name]["vartheta_l"]

        # Python-unrolled Newton iterations (iters is small and static)
        v_new = v_n
        for _ in range(self.iters):
            v_new = _water_newton_sweep(
                model, grid, rhs, Y, Ya, v_new, v_n, dt, t_new,
                solver=self.tridiag,
            )
        return v_new


@dataclasses.dataclass(frozen=True)
class BackwardEulerSoil(AbstractTimestepper):
    """Fully implicit (operator-split) backward-Euler step for the coupled
    soil model: the Richards update of :class:`BackwardEulerRichards`
    followed by a backward-Euler heat update that solves the linear
    tridiagonal system in ``rho_e_int`` with frozen kappa and frozen
    ``dT/d rho_e_int = 1/rho_c_s`` (exact for the conduction term; the
    advective energy flux rides the rhs).  First order; unconditionally
    stable for both diffusion operators."""

    model: SoilModel
    grid: ColumnGrid
    iters: int = 2
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 1

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        from landhydrology.models.soil import heat as sh
        from landhydrology.models.soil.model import SoilEnergyModel
        from landhydrology.models.soil.rhs import energy_center_fields

        model, grid = self.model, self.grid
        name = model.name
        if not isinstance(model.energy_model, SoilEnergyModel):
            raise TypeError("BackwardEulerSoil needs a dynamic energy model")

        # 1) implicit water update (Newton tridiagonal) on the full state —
        # the Newton coefficients may need rho_e_int (T-dependent viscosity);
        # water_solve skips the explicit tail BackwardEulerRichards.step
        # would add for the variables this stepper advances implicitly
        water = BackwardEulerRichards(
            model=model, grid=grid, iters=self.iters, tridiag=self.tridiag
        )
        v_new = water.water_solve(rhs, Y, Ya, t, dt)

        # 2) implicit heat update with the new water field
        t_new = t + dt
        e_n = Y[name]["rho_e_int"]
        Ybase = {name: dict(Y[name], vartheta_l=v_new)}

        e_new = e_n  # Python-unrolled, as in water_solve
        for _ in range(self.iters):
            e_new = _heat_newton_sweep(
                model, grid, rhs, Ybase, Ya, e_new, e_n, dt, t_new,
                solver=self.tridiag,
            )
        out = dict(Y[name], vartheta_l=v_new, rho_e_int=e_new)
        if model.freeze_thaw is not None:
            # phase-change source advanced explicitly on the updated state
            Yf = {name: dict(out)}
            d = rhs(Yf, Ya, t_new)[name]
            out["theta_i"] = Y[name]["theta_i"] + dt * d["theta_i"]
        return {name: out}


#: TR-BDF2 stage fraction gamma = 2 - sqrt(2) (the L-stable choice)
_TRBDF2_GAMMA = 2.0 - 2.0**0.5


@dataclasses.dataclass(frozen=True)
class TRBDF2Soil(AbstractTimestepper):
    """Second-order, L-stable TR-BDF2 step (Bank et al. 1985) for the soil
    model — the higher-order implicit option the north star's IMEX target
    asks for beyond backward Euler (SURVEY.md §7 hard part 3).

    Two implicit stages per step with gamma = 2 - sqrt(2):

        TR   stage:  u* = u^n + (g dt/2) [f(u^n) + f(u*)]
        BDF2 stage:  u+ = a1 u* + a2 u^n + b dt f(u+),
                     a1 = 1/(g(2-g)),  a2 = -(1-g)^2/(g(2-g)),  b = (1-g)/(2-g)

    Each stage equation ``u = c + w f(u)`` is solved by ``iters``
    Gauss-Seidel sweeps of the frozen-coefficient Newton tridiagonal solves
    (water then heat; theta_i by fixed point when a freeze-thaw source is
    active).  Because ``f`` is the exact rhs, the converged stages are the
    exact TR-BDF2 stages — no operator-splitting error; second order is
    verified at 30x the explicit CFL in ``tests/soil/test_imex.py``.

    Works for every dynamic-component combo: water-only (Richards), heat
    only, or fully coupled.
    """

    model: SoilModel
    grid: ColumnGrid
    iters: int = 3
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 2

    @property
    def stages(self) -> int:
        """rhs evaluations per step: 1 up-front ``f(u^n)`` plus, in each of
        the two implicit stages, ``iters`` Gauss-Seidel sweeps that each
        evaluate the rhs once per active component (water, heat, and the
        relaxation freeze-thaw fixed point when configured) — the count the
        throughput/cost accounting divides by."""
        from landhydrology.models.soil.freeze_thaw import (
            EquilibriumFreezeThaw,
        )
        from landhydrology.models.soil.model import SoilEnergyModel

        n_active = int(
            isinstance(self.model.hydrology_model, SoilHydrologyModel)
        ) + int(isinstance(self.model.energy_model, SoilEnergyModel))
        if self.model.freeze_thaw is not None and not isinstance(
            self.model.freeze_thaw, EquilibriumFreezeThaw
        ):
            n_active += 1
        return 1 + 2 * self.iters * max(n_active, 1)

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        from landhydrology.models.soil.model import SoilEnergyModel

        model = self.model
        name = model.name
        g = _TRBDF2_GAMMA
        d = 2.0 - g
        a1 = 1.0 / (g * d)
        a2 = -((1.0 - g) ** 2) / (g * d)
        b = (1.0 - g) / d

        water = isinstance(model.hydrology_model, SoilHydrologyModel)
        heat = isinstance(model.energy_model, SoilEnergyModel)
        if not (water or heat):
            raise TypeError(
                "TRBDF2Soil needs at least one dynamic component "
                "(SoilHydrologyModel and/or SoilEnergyModel)"
            )

        f_n = rhs(Y, Ya, t)[name]
        u_n = Y[name]

        # --- TR stage to t + g dt ---
        w1 = 0.5 * g * dt
        c1 = {k: u_n[k] + w1 * f_n[k] for k in u_n}
        u_star = self._solve_stage(rhs, Y, Ya, u_n, c1, w1, t + g * dt,
                                   water, heat)

        # --- BDF2 stage to t + dt ---
        w2 = b * dt
        c2 = {k: a1 * u_star[k] + a2 * u_n[k] for k in u_n}
        u_new = self._solve_stage(rhs, Y, Ya, u_star, c2, w2, t + dt,
                                  water, heat)
        return {name: u_new}

    def _solve_stage(self, rhs, Y, Ya, init: dict, c: dict, w, t_eval,
                     water: bool, heat: bool) -> dict:
        """Solve the stage equation ``u = c + w f(u)`` by Gauss-Seidel
        sweeps of the per-variable Newton updates."""
        from landhydrology.models.soil.freeze_thaw import (
            EquilibriumFreezeThaw,
        )

        model, grid = self.model, self.grid
        name = model.name
        # relaxation freeze-thaw rides the rhs as a rate source; the
        # equilibrium variant projects after the step (PhaseEquilibriumStepper)
        has_ft = model.freeze_thaw is not None and not isinstance(
            model.freeze_thaw, EquilibriumFreezeThaw
        )

        def sweep(st):
            if water:
                v = _water_newton_sweep(
                    model, grid, rhs, {name: st}, Ya,
                    st["vartheta_l"], c["vartheta_l"], w, t_eval,
                    solver=self.tridiag,
                )
                st = dict(st, vartheta_l=v)
            if heat:
                e = _heat_newton_sweep(
                    model, grid, rhs, {name: st}, Ya,
                    st["rho_e_int"], c["rho_e_int"], w, t_eval,
                    solver=self.tridiag,
                )
                st = dict(st, rho_e_int=e)
            if has_ft and "theta_i" in st:
                # non-stiff phase-change source: fixed-point on its stage
                # equation (converges because d f_ti/d theta_i ~ 1/tau and
                # w/tau < 1 for the supported tau >= 3 dt regime)
                f_ti = rhs({name: st}, Ya, t_eval)[name]["theta_i"]
                st = dict(st, theta_i=c["theta_i"] + w * f_ti)
            elif "theta_i" in st:
                # zero tendency: the stage equation is theta_i = c exactly
                st = dict(st, theta_i=c["theta_i"])
            return st

        # Python-unrolled Gauss-Seidel sweeps (iters static/small)
        st = dict(init)
        for _ in range(self.iters):
            st = sweep(st)
        return st
