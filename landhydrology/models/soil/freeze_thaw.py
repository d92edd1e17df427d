"""Freeze-thaw phase change — the north-star extension beyond the reference.

The reference carries theta_i as a prognostic variable but hard-codes its
tendency to zero (``/root/reference/src/SoilModel/right_hand_side.jl:182``,
``:359``); its energy accounting ``rho_e_int = rho_c_s (T - T_0) -
theta_i rho_i LH_f0`` is already structured for phase change (SURVEY.md §2
"physics scope note").  This module supplies the missing source terms
(driver ``BASELINE.json`` config 3: "freeze-thaw column ... Stefan-like
front propagation").

Scheme — relaxation toward the freezing-point-depression equilibrium
(Niu & Yang 2006 form):

- For T < T_0 the matric potential in equilibrium with ice is
  ``psi_f(T) = LH_f0 (T - T_0) / (g T)`` (Clapeyron); the maximum
  unfrozen liquid is ``theta_l_max = theta_r + (nu - theta_r) *
  S(psi_f)`` with S the inverse van Genuchten retention curve.
- Excess liquid freezes, ice melts above T_0, both at rate 1/tau:

    freeze = max(theta_l - theta_l_max, 0) / tau          (liquid volume)
    melt   = theta_i * [T > T_0] / tau                    (ice volume)

    d theta_i/dt     += (rho_l/rho_i) freeze - melt
    d vartheta_l/dt  += -freeze + (rho_i/rho_l) melt

- ``rho_e_int`` needs **no** source: its definition already books
  ``-theta_i rho_i LH_f0``, so freezing at fixed rho_e_int raises the
  diagnosed temperature (latent-heat release) and melting lowers it —
  energy is conserved identically.

Mass of water (``vartheta_l + (rho_i/rho_l) theta_i``) is conserved
identically by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from landhydrology.constants import EarthParameterSet
from landhydrology.models.soil import water as sw

Array = Any


@dataclasses.dataclass(frozen=True)
class FreezeThaw:
    """Phase-change config: relaxation timescale ``tau`` (s).

    ``tau`` should resolve a few time steps (tau >= ~3 dt) — for the stiff
    limit tau -> 0 use :class:`EquilibriumFreezeThaw` instead, which
    replaces the rate equation with an exact per-cell equilibrium
    projection (dt-independent, no timescale to tune).
    """

    tau: Array = 3600.0


@dataclasses.dataclass(frozen=True)
class EquilibriumFreezeThaw:
    """Instantaneous (tau -> 0) phase equilibrium — the stiff limit real
    freeze-thaw columns want (VERDICT r1 item 7).

    Instead of a source term in the rhs, every step ends with an exact
    per-cell **projection onto the phase-equilibrium manifold** at fixed
    total water mass ``w = vartheta_l + (rho_i/rho_l) theta_i`` and fixed
    ``rho_e_int`` (both conserved identically):

        find T with   rho_c_s(theta_l, theta_i) (T - T_0)
                      - theta_i rho_i LH_f0  =  rho_e_int,
        where  theta_l = min(w, theta_l_max(T)),
               theta_i = (rho_l/rho_i) (w - theta_l),

    i.e. the liquid fraction sits exactly on the freezing-point-depression
    curve whenever ice is present (complementarity holds by construction:
    ``theta_i > 0  =>  theta_l = theta_l_max(T)``; ``T >= T_0  =>
    theta_i = 0``).  The scalar equation is monotone in T, solved by a
    fixed-count branch-free bisection (jnp.where interval updates inside
    ``lax.fori_loop``) — jits and vmaps, and composes with any stepper (explicit, backward Euler,
    TR-BDF2) via :func:`wrap_stepper_with_projection`.

    Results are dt-independent: the projection depends only on the
    conserved (w, rho_e_int) pair, never on the step size.
    """

    #: bisection iterations: 60 halvings of [T_lo, T_hi] reach ~1e-16 K
    n_iter: int = 60
    T_lo: float = 150.0
    T_hi: float = 350.0


def equilibrium_unfrozen_liquid(
    hm: sw.vanGenuchten, T: Array, nu: Array, param_set: EarthParameterSet
) -> Array:
    """Maximum unfrozen liquid fraction theta_l_max(T) from freezing-point
    depression; +inf above T_0 (no constraint)."""
    T_0 = param_set.T_0
    T_safe = jnp.maximum(T, 200.0)  # keep Clapeyron ratio finite
    psi_f = param_set.LH_f0 * (jnp.minimum(T_safe, T_0) - T_0) / (
        param_set.grav * T_safe
    )
    S_max = sw.inverse_matric_potential(hm, psi_f)
    theta_l_max = hm.theta_r + (nu - hm.theta_r) * S_max
    return jnp.where(T >= T_0, jnp.inf, theta_l_max)


def phase_change_sources(
    ft: FreezeThaw,
    hm: sw.vanGenuchten,
    theta_l: Array,
    theta_i: Array,
    T: Array,
    nu: Array,
    rho_c_s: Array,
    param_set: EarthParameterSet,
) -> tuple:
    """(d vartheta_l/dt, d theta_i/dt) phase-change source pair.

    Both directions are **energy-limited** (Stefan condition): the amount
    frozen (melted) per relaxation time cannot release (absorb) more latent
    heat than would bring the cell to T_0, so the diagnosed temperature
    relaxes to the freezing point instead of chattering across it.
    """
    rho_l = param_set.rho_cloud_liq
    rho_i = param_set.rho_cloud_ice
    L = param_set.LH_f0
    T_0 = param_set.T_0

    theta_l_max = equilibrium_unfrozen_liquid(hm, T, nu, param_set)
    excess = jnp.where(
        jnp.isinf(theta_l_max), 0.0, jnp.maximum(theta_l - theta_l_max, 0.0)
    )
    # energy headroom to T_0, expressed as an ice-volume equivalent
    deficit_ice = jnp.maximum(rho_c_s * (T_0 - T), 0.0) / (rho_i * L)
    surplus_ice = jnp.maximum(rho_c_s * (T - T_0), 0.0) / (rho_i * L)

    freeze_ice = jnp.minimum((rho_l / rho_i) * excess, deficit_ice) / ft.tau
    melt_ice = jnp.minimum(theta_i, surplus_ice) / ft.tau

    d_theta_i = freeze_ice - melt_ice
    d_vartheta_l = (rho_i / rho_l) * (melt_ice - freeze_ice)
    return d_vartheta_l, d_theta_i


def equilibrium_phase_projection(model, Y: dict) -> dict:
    """Project every cell of the state onto phase equilibrium at fixed
    total water mass and fixed ``rho_e_int`` (see
    :class:`EquilibriumFreezeThaw`).  Pure jnp."""
    ft = model.freeze_thaw
    name = model.name
    sp = model.soil_param_set
    hm = model.hydrology_model.hydraulic_model
    param_set = model.earth_param_set
    rho_l = param_set.rho_cloud_liq
    rho_i = param_set.rho_cloud_ice
    L = param_set.LH_f0
    T_0 = param_set.T_0

    vartheta = Y[name]["vartheta_l"]
    theta_i = Y[name]["theta_i"]
    e = Y[name]["rho_e_int"]
    w = vartheta + (rho_i / rho_l) * theta_i  # liquid-volume-equivalent mass

    def partition(T):
        """(theta_l, theta_i) on the equilibrium manifold at temperature T."""
        tlm = equilibrium_unfrozen_liquid(hm, T, sp.nu, param_set)
        theta_l = jnp.where(T >= T_0, w, jnp.minimum(w, tlm))
        ti = (rho_l / rho_i) * (w - theta_l)
        return theta_l, ti

    def residual(T):
        theta_l, ti = partition(T)
        # rho_c_s uses the capped liquid fraction, matching the rhs's
        # volumetric_liquid_fraction convention
        theta_l_cap = jnp.minimum(theta_l, sp.nu - ti)
        rho_c_s = (
            sp.rho_c_ds
            + theta_l_cap * param_set.rho_cp_l
            + ti * param_set.rho_cp_i
        )
        return rho_c_s * (T - T_0) - ti * rho_i * L - e

    lo = jnp.full_like(e, ft.T_lo)
    hi = jnp.full_like(e, ft.T_hi)
    f_lo = residual(lo)

    def body(i, carry):
        lo, hi, f_lo = carry
        mid = 0.5 * (lo + hi)
        f_mid = residual(mid)
        same = f_mid * f_lo > 0.0
        return (
            jnp.where(same, mid, lo),
            jnp.where(same, hi, mid),
            jnp.where(same, f_mid, f_lo),
        )

    lo, hi, _ = jax.lax.fori_loop(0, ft.n_iter, body, (lo, hi, f_lo))
    T_eq = 0.5 * (lo + hi)
    theta_l_new, theta_i_new = partition(T_eq)
    return {
        **Y,
        name: {
            **Y[name],
            "vartheta_l": theta_l_new,
            "theta_i": jnp.maximum(theta_i_new, 0.0),
        },
    }


@dataclasses.dataclass(frozen=True)
class PhaseEquilibriumStepper:
    """Stepper decorator: advance with ``inner``, then apply the
    equilibrium phase projection (Strang-style split; the projection is
    exact and conservative, so it does not reduce the inner stepper's
    temporal order for the conserved variables)."""

    inner: Any
    model: Any

    @property
    def stages(self) -> int:
        return self.inner.stages

    @property
    def order(self) -> int:
        return getattr(self.inner, "order", 1)

    @property
    def unconditionally_stable(self) -> bool:
        return getattr(self.inner, "unconditionally_stable", False)

    def step(self, rhs, Y, Ya, t, dt):
        Y2 = self.inner.step(rhs, Y, Ya, t, dt)
        return equilibrium_phase_projection(self.model, Y2)


def wrap_stepper_with_projection(stepper, model):
    """Wrap ``stepper`` with the equilibrium projection when the model uses
    :class:`EquilibriumFreezeThaw` (idempotent; no-op otherwise)."""
    if isinstance(model.freeze_thaw, EquilibriumFreezeThaw) and not isinstance(
        stepper, PhaseEquilibriumStepper
    ):
        return PhaseEquilibriumStepper(inner=stepper, model=model)
    return stepper
