"""Initial conditions / state allocation.

Re-design of
``/root/reference/src/SoilModel/initial_conditions.jl``: the state is a dict
pytree of ``(nz, *batch)`` arrays instead of a ClimaCore FieldVector.

Prognostic state ``Y = {model.name: {...}}`` holds, per component combo:
``vartheta_l`` + ``theta_i`` (dynamic hydrology) and/or ``rho_e_int``
(dynamic energy) (``initial_conditions.jl:85-89``).  Auxiliary state
``Ya = {'zc': ..., model.name: {...}}`` holds coordinates plus prescribed
fields ``T`` and/or ``vartheta_l``/``theta_i`` (``initial_conditions.jl:14-77``).
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp

from landhydrology.domains import make_function_space
from landhydrology.models.soil import heat as sh
from landhydrology.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any


def prognostic_vars(model: SoilModel) -> tuple:
    """Names of the prognostic variables for the model's component combo."""
    out = ()
    if isinstance(model.hydrology_model, SoilHydrologyModel):
        out += ("vartheta_l", "theta_i")
    if isinstance(model.energy_model, SoilEnergyModel):
        out += ("rho_e_int",)
    return out


def aux_vars(model: SoilModel) -> Callable[[Array, Array], dict]:
    """Init function ``(t, z) -> {aux fields}`` for the model's prescribed
    components (cf. ``initial_conditions.jl:27-77``)."""

    def init_aux_soil(t, z):
        aux: dict = {}
        if isinstance(model.energy_model, PrescribedTemperatureModel):
            aux["T"] = model.energy_model.T_profile(z, t)
        if isinstance(model.hydrology_model, PrescribedHydrologyModel):
            aux["vartheta_l"] = model.hydrology_model.vartheta_l_profile(z, t)
            aux["theta_i"] = model.hydrology_model.theta_i_profile(z, t)
        return aux

    return init_aux_soil


def initialize_prognostic(model: SoilModel, f: Callable, zc: Array, shape) -> dict:
    """Evaluate the IC function ``f(z, model) -> dict`` on center coordinates
    and broadcast to the full batched state shape
    (cf. ``initial_conditions.jl:85-89``)."""
    ic = f(zc, model)
    dtype = model.float_dtype
    wanted = prognostic_vars(model)
    missing = [k for k in wanted if k not in ic]
    if missing:
        raise KeyError(
            f"Initial-condition function must provide {wanted}, missing {missing}"
        )
    soil = {
        k: jnp.broadcast_to(jnp.asarray(ic[k], dtype=dtype), shape) for k in wanted
    }
    return {model.name: soil}


def initialize_auxiliary(model: SoilModel, t0: Array, zc: Array) -> dict:
    """Auxiliary state at t0 (cf. ``initial_conditions.jl:14-17``)."""
    aux = aux_vars(model)(t0, zc)
    dtype = model.float_dtype
    return {
        "zc": jnp.asarray(zc, dtype=dtype),
        model.name: {k: jnp.asarray(v, dtype=dtype) for k, v in aux.items()},
    }


def initialize_states(model: SoilModel, f: Callable, t0) -> tuple:
    """Initial (Y, Ya) for the model given an IC function ``f(z, model)``
    (cf. ``initial_conditions.jl:101-107``)."""
    grid = make_function_space(model.domain, model.float_dtype)
    zc = grid.zc
    Y0 = initialize_prognostic(model, f, zc, grid.shape)
    Ya0 = initialize_auxiliary(model, jnp.asarray(t0, dtype=model.float_dtype), zc)
    return Y0, Ya0


def default_initial_conditions(model: SoilModel) -> tuple:
    """Default ICs — only for the fully dynamic combo: isothermal at T_0,
    no ice, vartheta_l = nu/2 (cf. ``models.jl:147-166``)."""
    if not (
        isinstance(model.energy_model, SoilEnergyModel)
        and isinstance(model.hydrology_model, SoilHydrologyModel)
    ):
        raise ValueError("No default IC exist for this type of soil model.")

    def ic(z, m: SoilModel):
        param_set = m.earth_param_set
        T = jnp.full_like(z, 273.16)
        theta_i = jnp.zeros_like(z)
        theta_l = jnp.full_like(z, 0.5) * m.soil_param_set.nu
        rho_c_s = sh.volumetric_heat_capacity(
            theta_l, theta_i, m.soil_param_set.rho_c_ds, param_set
        )
        rho_e_int = sh.volumetric_internal_energy(theta_i, rho_c_s, T, param_set)
        return {"vartheta_l": theta_l, "theta_i": theta_i, "rho_e_int": rho_e_int}

    return initialize_states(model, ic, 0.0)
