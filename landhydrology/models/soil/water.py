"""Soil-water (hydraulics) parameterizations — van Genuchten closures.

Re-design of
``/root/reference/src/SoilModel/SoilWaterParameterizations.jl``: every scalar
closure of the reference becomes a branch-free jnp ufunc over batched
``(nz, *batch)`` arrays.  Julia's scalar ``if``/``else`` branches become
``jnp.where`` with *NaN-safe masked operands* — the untaken branch is clamped
into its valid domain before the power laws are evaluated so no NaN (or NaN
cotangent under AD) leaks out of ``where`` (SURVEY.md §7 hard part 2).

All hydraulics parameters may be scalars or arrays broadcastable against the
state (heterogeneous per-column soils, SURVEY.md §2 row 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp

Array = Any


def _eps_of(x) -> Array:
    """Machine epsilon of the dtype of ``x`` (Julia ``eps(FT)``)."""
    return jnp.finfo(jnp.result_type(x)).eps


def _tiny_of(x) -> Array:
    """Smallest positive normal of the dtype of ``x`` (log-domain guard)."""
    return jnp.finfo(jnp.result_type(x)).tiny


# --------------------------------------------------------------------------
# Conductivity factors
# --------------------------------------------------------------------------


class AbstractConductivityFactor:
    """Multiplicative hydraulic-conductivity factor
    (cf. ``SoilWaterParameterizations.jl:30``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NoEffect(AbstractConductivityFactor):
    """Unity factor (cf. ``SoilWaterParameterizations.jl:38``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TemperatureDependentViscosity(AbstractConductivityFactor):
    """Temperature-dependent viscosity factor Theta = exp(gamma (T - T_ref))
    (cf. ``SoilWaterParameterizations.jl:46-52``)."""

    gamma: Array = 2.64e-2
    T_ref: Array = 288.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IceImpedance(AbstractConductivityFactor):
    """Ice-impedance factor 10^(-Omega f_i), Lundin (1990)
    (cf. ``SoilWaterParameterizations.jl:62-65``)."""

    omega: Array = 7.0


def viscosity_factor(factor: AbstractConductivityFactor, T: Array) -> Array:
    """Viscosity multiplicative factor
    (cf. ``SoilWaterParameterizations.jl:104-126``).

    ``NoEffect`` returns 1; ``TemperatureDependentViscosity`` returns
    exp(gamma (T - T_ref)).  Dispatch on the factor type is static (part of
    the model config), so jit specializes away the untaken branch.
    """
    if isinstance(factor, TemperatureDependentViscosity):
        return jnp.exp(factor.gamma * (T - factor.T_ref))
    return jnp.ones_like(T)


def impedance_factor(factor: AbstractConductivityFactor, f_i: Array) -> Array:
    """Ice impedance multiplicative factor
    (cf. ``SoilWaterParameterizations.jl:76-93``).

    ``NoEffect`` returns 1; ``IceImpedance`` returns 10^(-Omega f_i),
    evaluated as exp(-Omega ln10 f_i) — one transcendental instead of the
    exp∘log pair a generic ``pow`` costs.
    """
    if isinstance(factor, IceImpedance):
        return jnp.exp((-math.log(10.0)) * factor.omega * f_i)
    return jnp.ones_like(f_i)


# --------------------------------------------------------------------------
# Hydraulics model
# --------------------------------------------------------------------------


class AbstractHydraulicsModel:
    """Soil-water retention/conductivity model
    (cf. ``SoilWaterParameterizations.jl:139``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class vanGenuchten(AbstractHydraulicsModel):
    """van Genuchten hydraulics parameters; defaults are loam with residual
    water content zero (cf. ``SoilWaterParameterizations.jl:151-170``).

    ``m`` is derived as 1 - 1/n exactly as in the reference constructor.
    Every field may be a scalar or a per-column array.
    """

    n: Array = 1.56
    alpha: Array = 3.6  # 1/m
    Ksat: Array = 2.9e-7  # m/s
    theta_r: Array = 0.0

    @property
    def m(self) -> Array:
        return 1.0 - 1.0 / self.n


# --------------------------------------------------------------------------
# Closures
# --------------------------------------------------------------------------


def volumetric_liquid_fraction(vartheta_l: Array, nu_eff: Array) -> Array:
    """theta_l = min(vartheta_l, nu_eff)
    (cf. ``SoilWaterParameterizations.jl:181-188``)."""
    return jnp.minimum(vartheta_l, nu_eff)


def effective_saturation(porosity: Array, vartheta_l: Array, theta_r: Array) -> Array:
    """Effective saturation S_l = (vartheta_l - theta_r)/(porosity - theta_r)
    with the reference's safety clamp vartheta_l >= theta_r + eps(FT)
    (cf. ``SoilWaterParameterizations.jl:213-217``)."""
    vartheta_l_safe = jnp.maximum(vartheta_l, theta_r + _eps_of(vartheta_l))
    return (vartheta_l_safe - theta_r) / (porosity - theta_r)


def matric_potential(hm: vanGenuchten, S: Array) -> Array:
    """psi_m = -((S^(-1/m) - 1) alpha^(-n))^(1/n) for S in (0, 1]
    (cf. ``SoilWaterParameterizations.jl:196-200``).

    NaN-safe for S >= 1: returns exactly 0 there (the reference formula's
    value at S = 1), while the power law is evaluated on a strict-interior
    clamp of S so no infinite derivative leaks a NaN cotangent through the
    selecting ``where`` under AD.  Callers needing the saturated
    (compressibility) pressure head use :func:`pressure_head`.

    The power laws are evaluated in the log domain (``pow`` is exp∘log
    anyway); ``log(S_safe)`` is shared with
    :func:`hydraulic_conductivity` by CSE when both see the same ``S``.
    """
    n, alpha, m = hm.n, hm.alpha, hm.m
    eps = _eps_of(S)
    S_safe = jnp.clip(S, eps, 1.0 - eps)
    # S_safe <= 1 - eps  =>  S^(-1/m) - 1 >= eps/m > 0; the tiny-guard only
    # protects the log from underflow-to-zero rounding.  S^(-1/m) is taken
    # as exp of the NEGATED log-domain exponent, which replaces an array
    # divide 1/u, and log(S_safe) still CSEs with hydraulic_conductivity's
    # u term.
    u_inv = jnp.exp(jnp.log(S_safe) * (-1.0 / m))
    base = (u_inv - 1.0) * alpha ** (-n)
    psi_unsat = -jnp.exp(jnp.log(jnp.maximum(base, _tiny_of(S))) * (1.0 / n))
    return jnp.where(S < 1.0, psi_unsat, 0.0)


def inverse_matric_potential(hm: vanGenuchten, psi: Array) -> Array:
    """S = (1 + (alpha |psi|)^n)^(-m), psi <= 0
    (cf. ``SoilWaterParameterizations.jl:253-258``).

    The reference errors on positive psi (``:254``); here the check runs
    eagerly on concrete inputs (under jit the caller guarantees the domain).
    """
    if not isinstance(psi, jax.core.Tracer):
        if bool(jnp.any(jnp.asarray(psi) > 0)):
            raise ValueError("Matric potential is positive")
    n, alpha, m = hm.n, hm.alpha, hm.m
    return (1.0 + (alpha * jnp.abs(psi)) ** n) ** (-m)


def pressure_head(hm: vanGenuchten, vartheta_l: Array, nu_eff: Array, S_s: Array) -> Array:
    """Pressure head: matric potential when unsaturated (S_l_eff <= 1), else
    the positive compressibility head (vartheta_l - nu_eff)/S_s
    (cf. ``SoilWaterParameterizations.jl:229-242``).

    Vectorized masked form of the reference's branch: both operands are
    evaluated on their clamped-valid domains, then selected.
    """
    S_l_eff = effective_saturation(nu_eff, vartheta_l, hm.theta_r)
    psi_unsat = matric_potential(hm, S_l_eff)  # internally clamps S <= 1
    psi_sat = (vartheta_l - nu_eff) / S_s
    return jnp.where(S_l_eff <= 1.0, psi_unsat, psi_sat)


def hydraulic_conductivity(
    hm: vanGenuchten, S: Array, viscosity_f: Array, impedance_f: Array
) -> Array:
    """Mualem-van Genuchten conductivity
    K = Ksat sqrt(S) (1 - (1 - S^(1/m))^m)^2 * viscosity_f * impedance_f,
    clamped to K = Ksat for S >= 1
    (cf. ``SoilWaterParameterizations.jl:269-282``).

    NaN-safe: S is clamped into [eps, 1 - eps] before the power laws (the
    strict interior keeps derivatives finite under AD), then the saturated
    branch is selected with ``where``.

    Log-domain evaluation: u = S^(1/m) = exp(log(S)/m) (clamp keeps
    u <= (1-eps)^(1/m) < 1, so 1-u stays positive), (1-u)^m likewise, and
    the outer square is a multiply.  ``log(S_safe)`` CSEs with
    :func:`matric_potential` when both closures see the same ``S``.
    """
    m, Ksat = hm.m, hm.Ksat
    eps = _eps_of(S)
    S_safe = jnp.clip(S, eps, 1.0 - eps)
    u = jnp.exp(jnp.log(S_safe) * (1.0 / m))  # S^(1/m) in (0, 1)
    f = 1.0 - jnp.exp(jnp.log(jnp.maximum(1.0 - u, _tiny_of(S))) * m)
    K_unsat = jnp.sqrt(S_safe) * f * f
    K = jnp.where(S < 1.0, K_unsat, 1.0)
    return K * Ksat * viscosity_f * impedance_f


def hydrostatic_profile(
    hm: vanGenuchten, z: Array, z_interface: Array, nu: Array, S_s: Array
) -> Array:
    """Augmented liquid fraction of the hydrostatic equilibrium profile with
    the water table at ``z_interface``
    (cf. ``SoilWaterParameterizations.jl:290-306``).

    Above the water table: vartheta_l = S(z) (nu - theta_r) + theta_r with
    S = (1 + (alpha (z - z_nabla))^n)^(-m); below: the supersaturated linear
    storage profile -S_s (z - z_nabla) + nu.
    """
    alpha, m, n, theta_r = hm.alpha, hm.m, hm.n, hm.theta_r
    dz = jnp.maximum(z - z_interface, 0.0)  # clamp: untaken branch stays real
    S = (1.0 + (alpha * dz) ** n) ** (-m)
    unsat = S * (nu - theta_r) + theta_r
    sat = -S_s * (z - z_interface) + nu
    return jnp.where(z > z_interface, unsat, sat)


def ice_fraction_of_water(theta_l: Array, theta_i: Array) -> Array:
    """f_i = theta_i / (theta_l + theta_i), the mass fraction of soil water in
    ice, as consumed by the impedance factor (cf. ``right_hand_side.jl:159``,
    ``:308``).  Guarded against 0/0 when the column is completely dry (the
    reference would produce NaN there; it only evaluates this with NoEffect
    impedance in that regime)."""
    theta_w = theta_l + theta_i
    # reciprocal-multiply, spelled identically to the theta_w guard in
    # heat.saturated_thermal_conductivity so the coupled sweep's two
    # theta_w divides CSE into one (see the note there)
    return theta_i * (1.0 / jnp.maximum(theta_w, _eps_of(theta_w)))
