"""Soil thermal parameterizations.

Re-design of
``/root/reference/src/SoilModel/SoilHeatParameterizations.jl``: branch-free
jnp ufuncs over batched arrays; the Julia branches on ``theta_w < eps`` and
``theta_i < eps`` become masked selects with clamped operands.
"""

from __future__ import annotations

import math
from typing import Any

import jax.numpy as jnp

from landhydrology.constants import EarthParameterSet

Array = Any


def _eps_of(x) -> Array:
    return jnp.finfo(jnp.result_type(x)).eps


def temperature_from_rho_e_int(
    rho_e_int: Array, theta_i: Array, rho_c_s: Array, param_set: EarthParameterSet
) -> Array:
    """T = T_0 + (rho_e_int + theta_i rho_i LH_f0) / rho_c_s
    (cf. ``SoilHeatParameterizations.jl:42-53``)."""
    return param_set.T_0 + (
        rho_e_int + theta_i * param_set.rho_cloud_ice * param_set.LH_f0
    ) / rho_c_s


def volumetric_heat_capacity(
    theta_l: Array, theta_i: Array, rho_c_ds: Array, param_set: EarthParameterSet
) -> Array:
    """rho_c_s = rho_c_ds + theta_l rho cp_l + theta_i rho cp_i
    (cf. ``SoilHeatParameterizations.jl:65-79``)."""
    return rho_c_ds + theta_l * param_set.rho_cp_l + theta_i * param_set.rho_cp_i


def volumetric_internal_energy(
    theta_i: Array, rho_c_s: Array, T: Array, param_set: EarthParameterSet
) -> Array:
    """rho_e_int = rho_c_s (T - T_0) - theta_i rho_i LH_f0
    (cf. ``SoilHeatParameterizations.jl:91-102``)."""
    return (
        rho_c_s * (T - param_set.T_0)
        - theta_i * param_set.rho_cloud_ice * param_set.LH_f0
    )


def volumetric_internal_energy_liq(T: Array, param_set: EarthParameterSet) -> Array:
    """rho_e_int_l = rho cp_l (T - T_0)
    (cf. ``SoilHeatParameterizations.jl:198-207``)."""
    return param_set.rho_cp_l * (T - param_set.T_0)


def saturated_thermal_conductivity(
    theta_l: Array, theta_i: Array, kappa_sat_unfrozen: Array, kappa_sat_frozen: Array
) -> Array:
    """kappa_sat = kappa_sat_unf^(theta_l/theta_w) kappa_sat_fr^(theta_i/theta_w),
    0 when theta_w < eps (cf. ``SoilHeatParameterizations.jl:114-128``).

    Masked form: the fractions are computed with theta_w clamped away from 0,
    then the dry branch selects 0.  The two power laws collapse to a single
    exponential, exp((theta_l ln k_unf + theta_i ln k_fr)/theta_w) — one
    transcendental per point instead of the two exp∘log pairs the pows lower
    to (the logs are trace-time constants for scalar parameters, and O(batch)
    once-per-sweep values for per-column parameter arrays).
    """
    theta_w = theta_l + theta_i
    # reciprocal-multiply: spelled identically to ice_fraction_of_water's
    # guard (water.py) so XLA CSEs the two theta_w reciprocals of the
    # coupled sweep into ONE divide
    r_theta_w = 1.0 / jnp.maximum(theta_w, _eps_of(theta_w))
    ln_unf = (
        math.log(kappa_sat_unfrozen)
        if isinstance(kappa_sat_unfrozen, (int, float))
        else jnp.log(kappa_sat_unfrozen)
    )
    ln_fr = (
        math.log(kappa_sat_frozen)
        if isinstance(kappa_sat_frozen, (int, float))
        else jnp.log(kappa_sat_frozen)
    )
    kappa = jnp.exp((theta_l * ln_unf + theta_i * ln_fr) * r_theta_w)
    return jnp.where(theta_w < _eps_of(theta_w), 0.0, kappa)


def relative_saturation(theta_l: Array, theta_i: Array, porosity: Array) -> Array:
    """S_r = (theta_l + theta_i)/porosity
    (cf. ``SoilHeatParameterizations.jl:139-142``)."""
    return (theta_l + theta_i) / porosity


def kersten_number(theta_i: Array, S_r: Array, soil_params) -> Array:
    """Balland & Arp Kersten number, with the reference's branch on
    ``theta_i < eps`` (cf. ``SoilHeatParameterizations.jl:152-174``).

    Unfrozen: K_e = S_r^((1 + nu_ss_om - a nu_ss_quartz - nu_ss_gravel)/2)
    * ((1 + exp(-b S_r))^-3 - ((1 - S_r)/2)^3)^(1 - nu_ss_om);
    frozen: K_e = S_r^(1 + nu_ss_om).

    The cube of ``(1 - S_r)/2`` is expanded as an odd integer power so a
    (numerically) negative base cannot NaN, and the bracket is clamped >= 0
    before the fractional power.

    Transcendental budget: (1 + e)^-3 is a reciprocal cube (multiplies, no
    pow), the unfrozen product collapses into a single fused exponential,
    and both branches share one log(S_r) — 3 exps + 2 logs per point versus
    the 1 exp + 4 exp∘log pairs of the naive form.  Positive exponents make
    the tiny-clamped log exact at S_r = 0 (exp(c log tiny) underflows to the
    correct 0 limit).
    """
    a = soil_params.a
    b = soil_params.b
    nu_ss_om = soil_params.nu_ss_om
    nu_ss_quartz = soil_params.nu_ss_quartz
    nu_ss_gravel = soil_params.nu_ss_gravel

    S_r_safe = jnp.maximum(S_r, 0.0)
    half = (1.0 - S_r_safe) / 2.0
    t = 1.0 + jnp.exp(-b * S_r_safe)
    bracket = 1.0 / (t * t * t) - half * half * half
    tiny = jnp.finfo(jnp.result_type(S_r)).tiny
    ln_S = jnp.log(jnp.maximum(S_r_safe, tiny))
    ln_bracket = jnp.log(jnp.maximum(bracket, tiny))
    K_e_unfrozen = jnp.exp(
        ln_S * ((1.0 + nu_ss_om - a * nu_ss_quartz - nu_ss_gravel) / 2.0)
        + ln_bracket * (1.0 - nu_ss_om)
    )
    K_e_frozen = jnp.exp(ln_S * (1.0 + nu_ss_om))
    return jnp.where(theta_i < _eps_of(S_r), K_e_unfrozen, K_e_frozen)


def thermal_conductivity(kappa_dry: Array, K_e: Array, kappa_sat: Array) -> Array:
    """kappa = K_e kappa_sat + (1 - K_e) kappa_dry
    (cf. ``SoilHeatParameterizations.jl:185-188``)."""
    return K_e * kappa_sat + (1.0 - K_e) * kappa_dry


def k_solid(
    nu_ss_om: Array,
    nu_ss_quartz: Array,
    kappa_quartz: Array,
    kappa_minerals: Array,
    kappa_om: Array,
) -> Array:
    """Geometric-mean solids conductivity
    (cf. ``SoilHeatParameterizations.jl:223-233``)."""
    return (
        kappa_om**nu_ss_om
        * kappa_quartz**nu_ss_quartz
        * kappa_minerals ** (1.0 - nu_ss_om - nu_ss_quartz)
    )


def ksat_frozen(kappa_solid: Array, porosity: Array, kappa_ice: Array) -> Array:
    """kappa_solid^(1-porosity) kappa_ice^porosity
    (cf. ``SoilHeatParameterizations.jl:245-247``)."""
    return kappa_solid ** (1.0 - porosity) * kappa_ice**porosity


def ksat_unfrozen(kappa_solid: Array, porosity: Array, kappa_l: Array) -> Array:
    """kappa_solid^(1-porosity) kappa_l^porosity
    (cf. ``SoilHeatParameterizations.jl:258-260``)."""
    return kappa_solid ** (1.0 - porosity) * kappa_l**porosity


def rho_b_ss(porosity: Array, rho_p: Array) -> Array:
    """Dry-soil bulk density (1 - porosity) rho_p
    (cf. ``SoilHeatParameterizations.jl:268-270``)."""
    return (1.0 - porosity) * rho_p


def k_dry(param_set: EarthParameterSet, soil_params) -> Array:
    """Dry thermal conductivity, Balland & Arp
    (cf. ``SoilHeatParameterizations.jl:280-294``)."""
    kappa_dry_parameter = soil_params.kappa_dry_parameter
    porosity = soil_params.nu
    rho_p = soil_params.rho_p
    kappa_solid = soil_params.kappa_solid
    kappa_air = param_set.K_therm
    rho_b = rho_b_ss(porosity, rho_p)
    numerator = (kappa_dry_parameter * kappa_solid - kappa_air) * rho_b + kappa_air * rho_p
    denom = rho_p - (1.0 - kappa_dry_parameter) * rho_b
    return numerator / denom
