"""RHS assembly — the spatial discretization of the soil PDEs.

Re-design of
``/root/reference/src/SoilModel/right_hand_side.jl``.  ``make_rhs(model)``
dispatches on the (energy, hydrology) component types at trace time and
returns a pure function ``rhs(Y, Ya, t) -> dY`` over dict pytrees of
``(nz, *batch)`` arrays:

- (Prescribed, Prescribed) -> no-op (``right_hand_side.jl:103-112``)
- (Prescribed, SoilHydrology) -> Richards only:
  d vartheta_l/dt = -div(-K grad h), h = psi + z (``:118-186``)
- (SoilEnergy, Prescribed) -> heat only:
  d rho_e_int/dt = -div(-kappa grad T) (``:192-263``)
- (SoilEnergy, SoilHydrology) -> fully coupled, adds the advected liquid
  internal energy flux -rho_e_int_liq K grad h (``:269-369``)

Everything is one pointwise sweep + 2-point vertical stencils, which XLA
fuses into a handful of kernels.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp

from landhydrology.domains import ColumnGrid, make_function_space
from landhydrology.models.soil import heat as sh
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.boundary import boundary_fluxes
from landhydrology.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology.ops.stencil import diffusive_flux_faces, div_f2c

Array = Any


# --------------------------------------------------------------------------
# Auxiliary-state update (cf. right_hand_side.jl:54-96)
# --------------------------------------------------------------------------


def make_update_aux(component) -> Callable[[dict, Array, str], dict]:
    """Return ``update_aux(Ya, t, name) -> Ya`` refreshing prescribed fields
    from their (z, t) profiles; identity for dynamic components
    (cf. ``right_hand_side.jl:54-96``).  Functional: returns a new dict."""
    if isinstance(component, PrescribedTemperatureModel):

        def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
            zc = Ya["zc"]
            soil = dict(Ya[name], T=component.T_profile(zc, t))
            return dict(Ya, **{name: soil})

        return update_aux

    if isinstance(component, PrescribedHydrologyModel):

        def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
            zc = Ya["zc"]
            soil = dict(
                Ya[name],
                vartheta_l=component.vartheta_l_profile(zc, t),
                theta_i=component.theta_i_profile(zc, t),
            )
            return dict(Ya, **{name: soil})

        return update_aux

    def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
        return Ya

    return update_aux


# --------------------------------------------------------------------------
# Shared physics sweeps
# --------------------------------------------------------------------------


def hydrology_center_fields(model: SoilModel, vartheta_l, theta_i, T):
    """Pointwise hydraulic fields on centers: (theta_l, K, psi)
    (cf. ``right_hand_side.jl:156-166``).

    With ``model.assume_no_ice`` the effective porosity equals the true
    porosity and the impedance factor is unity — an exact specialization
    for theta_i == 0 that removes the associated pows from the sweep.
    """
    sp = model.soil_param_set
    hydrology = model.hydrology_model
    hm = hydrology.hydraulic_model
    if model.assume_no_ice:
        nu_eff = sp.nu
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        impedance_f = 1.0
    else:
        nu_eff = sp.nu - theta_i
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        f_i = sw.ice_fraction_of_water(theta_l, theta_i)
        impedance_f = sw.impedance_factor(hydrology.impedance_factor, f_i)
    viscosity_f = sw.viscosity_factor(hydrology.viscosity_factor, T)
    S = sw.effective_saturation(sp.nu, vartheta_l, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, viscosity_f, impedance_f)
    psi = sw.pressure_head(hm, vartheta_l, nu_eff, sp.S_s)
    return theta_l, K, psi


def energy_center_fields(model: SoilModel, theta_l, theta_i, rho_e_int=None, T=None):
    """Pointwise thermal fields on centers: (T, kappa, rho_c_s)
    (cf. ``right_hand_side.jl:209-224``).  Either ``rho_e_int`` (dynamic
    energy: T is diagnosed) or ``T`` (prescribed) must be given.

    With ``model.assume_no_ice`` the frozen branches drop out exactly:
    kappa_sat is the unfrozen value (no geometric-mean pows), the Kersten
    number keeps only the unfrozen Balland-Arp branch, and the latent-heat
    offset in the T diagnosis vanishes.
    """
    sp = model.soil_param_set
    param_set = model.earth_param_set
    no_ice = model.assume_no_ice
    rho_c_s = sh.volumetric_heat_capacity(
        theta_l, 0.0 if no_ice else theta_i, sp.rho_c_ds, param_set
    )
    if T is None:
        if no_ice:
            T = param_set.T_0 + rho_e_int / rho_c_s
        else:
            T = sh.temperature_from_rho_e_int(
                rho_e_int, theta_i, rho_c_s, param_set
            )
    kappa_dry = sh.k_dry(param_set, sp)
    if no_ice:
        S_r = sh.relative_saturation(theta_l, 0.0, sp.nu)
        kersten = sh.kersten_number(0.0, S_r, sp)
        kappa_sat = jnp.where(
            theta_l < jnp.finfo(jnp.result_type(theta_l)).eps,
            0.0,
            sp.kappa_sat_unfrozen * jnp.ones_like(theta_l),
        )
    else:
        S_r = sh.relative_saturation(theta_l, theta_i, sp.nu)
        kersten = sh.kersten_number(theta_i, S_r, sp)
        kappa_sat = sh.saturated_thermal_conductivity(
            theta_l, theta_i, sp.kappa_sat_unfrozen, sp.kappa_sat_frozen
        )
    kappa = sh.thermal_conductivity(kappa_dry, kersten, kappa_sat)
    return T, kappa, rho_c_s


def lateral_surface_tendency(model: SoilModel, h_top: Array, dz: Array) -> Array:
    """Lateral surface-coupling tendency for the top cell:
    ``(c / dz) * lap_xy(h_top)`` on the periodic 2-D column grid
    (see :class:`~landhydrology.models.soil.model.LateralSurfaceCoupling`).

    Single-program path: neighbor access via ``jnp.roll`` (XLA lowers rolls
    on sharded axes to collective permutes automatically); the explicitly
    overlapped ``shard_map`` halo-exchange path lives in ``parallel/halo.py``.
    """
    lc = model.lateral_coupling
    if h_top.ndim < 2:
        raise ValueError(
            "LateralSurfaceCoupling requires a 2-D (nx, ny) column batch; "
            f"got surface field of shape {h_top.shape}"
        )
    lap = (
        jnp.roll(h_top, 1, axis=0)
        + jnp.roll(h_top, -1, axis=0)
        + jnp.roll(h_top, 1, axis=1)
        + jnp.roll(h_top, -1, axis=1)
        - 4.0 * h_top
    ) / (lc.dx * lc.dx)
    return lc.conductance / dz * lap


def _add_lateral(model: SoilModel, d_vartheta_l: Array, h: Array, dz: Array) -> Array:
    if model.lateral_coupling is None:
        return d_vartheta_l
    top = h.shape[0] - 1  # static index (negative would lower to dynamic_slice)
    return d_vartheta_l.at[top].add(lateral_surface_tendency(model, h[top], dz))


def _face_fluxes(model, grid, X, t, required=()):
    """Boundary fluxes at both faces (cf. ``right_hand_side.jl:134-149``).

    ``required`` names flux keys that must be present (non-NoBC) for the
    model's dynamic components; a missing one raises immediately with the
    face and key instead of failing later inside the divergence."""
    bcs = model.boundary_conditions
    fluxes = {
        "bottom": boundary_fluxes(X, bcs.bottom, "bottom", model, grid, t),
        "top": boundary_fluxes(X, bcs.top, "top", model, grid, t),
    }
    for face, per_face in fluxes.items():
        for key in required:
            if per_face.get(key) is None:
                raise ValueError(
                    f"model with dynamic components requires a boundary "
                    f"condition producing '{key}' at the {face} face "
                    f"(got NoBC)"
                )
    return fluxes


# --------------------------------------------------------------------------
# make_rhs — 4-way static dispatch (cf. right_hand_side.jl:33-44)
# --------------------------------------------------------------------------


def make_rhs(model: SoilModel, grid: ColumnGrid | None = None):
    """Build ``rhs(Y, Ya, t) -> dY`` for the model's component combination
    (cf. ``right_hand_side.jl:33-44``).

    The returned function first refreshes prescribed aux fields (the
    reference's ``update_aux!``), then evaluates the tendencies.
    """
    if grid is None:
        grid = make_function_space(model.domain, model.float_dtype)
    update_aux_en = make_update_aux(model.energy_model)
    update_aux_hydr = make_update_aux(model.hydrology_model)
    rhs_soil = _make_rhs_soil(model.energy_model, model.hydrology_model, model, grid)

    def rhs(Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux_en(Ya, t, model.name)
        Ya = update_aux_hydr(Ya, t, model.name)
        return rhs_soil(Y, Ya, t)

    return rhs


def _make_rhs_soil(energy, hydrology, model: SoilModel, grid: ColumnGrid):
    name = model.name
    dz = grid.dz

    if isinstance(energy, PrescribedTemperatureModel) and isinstance(
        hydrology, PrescribedHydrologyModel
    ):
        # no dynamics (cf. right_hand_side.jl:103-112)
        def rhs(Y, Ya, t):
            return {name: {}} if name in Y else {}

        return rhs

    if isinstance(energy, PrescribedTemperatureModel) and isinstance(
        hydrology, SoilHydrologyModel
    ):
        # Richards only (cf. right_hand_side.jl:118-186)
        def rhs(Y, Ya, t):
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
            T = jnp.broadcast_to(Ya[name]["T"], vartheta_l.shape)
            zc = Ya["zc"]

            theta_l, K, psi = hydrology_center_fields(model, vartheta_l, theta_i, T)
            h = psi + zc

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(model, grid, X, t, required=("f_vartheta_l",))

            water_flux = diffusive_flux_faces(K, h, dz)
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            d_vartheta_l = _add_lateral(model, d_vartheta_l, h, dz)
            return {
                name: {
                    "vartheta_l": d_vartheta_l,
                    "theta_i": jnp.zeros_like(theta_i),
                }
            }

        return rhs

    if isinstance(energy, SoilEnergyModel) and isinstance(
        hydrology, PrescribedHydrologyModel
    ):
        # heat only (cf. right_hand_side.jl:192-263)
        def rhs(Y, Ya, t):
            rho_e_int = Y[name]["rho_e_int"]
            vartheta_l = jnp.broadcast_to(Ya[name]["vartheta_l"], rho_e_int.shape)
            theta_i = jnp.broadcast_to(Ya[name]["theta_i"], rho_e_int.shape)

            sp = model.soil_param_set
            nu_eff = sp.nu - theta_i
            theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
            T, kappa, _ = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=rho_e_int
            )

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(model, grid, X, t, required=("f_rho_e_int",))

            heat_flux = diffusive_flux_faces(kappa, T, dz)
            d_rho_e_int = -div_f2c(
                heat_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )
            return {name: {"rho_e_int": d_rho_e_int}}

        return rhs

    if isinstance(energy, SoilEnergyModel) and isinstance(hydrology, SoilHydrologyModel):
        # fully coupled (cf. right_hand_side.jl:269-369)
        def rhs(Y, Ya, t):
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
            rho_e_int = Y[name]["rho_e_int"]
            zc = Ya["zc"]

            sp = model.soil_param_set
            param_set = model.earth_param_set
            nu_eff = sp.nu - theta_i
            theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
            T, kappa, rho_c_s = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=rho_e_int
            )
            rho_e_int_l = sh.volumetric_internal_energy_liq(T, param_set)
            _, K, psi = hydrology_center_fields(model, vartheta_l, theta_i, T)
            h = psi + zc

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(
                model, grid, X, t, required=("f_vartheta_l", "f_rho_e_int")
            )

            water_flux = diffusive_flux_faces(K, h, dz)  # -K grad h on faces
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            d_vartheta_l = _add_lateral(model, d_vartheta_l, h, dz)
            # energy flux: -kappa grad T - rho_e_int_l K grad h
            # (cf. right_hand_side.jl:361-365)
            energy_flux = diffusive_flux_faces(kappa, T, dz) + diffusive_flux_faces(
                rho_e_int_l * K, h, dz
            )
            d_rho_e_int = -div_f2c(
                energy_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )
            # freeze-thaw phase change (an extension beyond the reference; the reference
            # zeroes d theta_i — right_hand_side.jl:359).  The relaxation
            # scheme contributes rate sources here; EquilibriumFreezeThaw
            # contributes nothing to the rhs — its exact projection runs
            # after each step (freeze_thaw.PhaseEquilibriumStepper).
            d_theta_i = jnp.zeros_like(theta_i)
            from landhydrology.models.soil.freeze_thaw import (
                EquilibriumFreezeThaw as _EqFT,
            )

            if model.freeze_thaw is not None and not isinstance(
                model.freeze_thaw, _EqFT
            ):
                from landhydrology.models.soil.freeze_thaw import (
                    phase_change_sources,
                )

                src_l, src_i = phase_change_sources(
                    model.freeze_thaw,
                    model.hydrology_model.hydraulic_model,
                    theta_l,
                    theta_i,
                    T,
                    sp.nu,
                    rho_c_s,
                    param_set,
                )
                d_vartheta_l = d_vartheta_l + src_l
                d_theta_i = d_theta_i + src_i

            return {
                name: {
                    "vartheta_l": d_vartheta_l,
                    "theta_i": d_theta_i,
                    "rho_e_int": d_rho_e_int,
                }
            }

        return rhs

    raise TypeError(
        f"Unsupported component combination ({energy!r}, {hydrology!r})"
    )
