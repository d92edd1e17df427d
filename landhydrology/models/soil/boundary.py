"""Boundary conditions and the uniform state->flux conversion layer.

Re-design of
``/root/reference/src/SoilModel/boundary_conditions.jl``.  The reference's
design — every BC type is converted into a flux value that ``DivergenceF2C``
sets on the boundary face (``boundary_conditions.jl:165-489``) — carries over
directly and is ideal for vectorization: per-face flux formulas are pointwise
functions of the nearest-center state, broadcast over all batch dims.  BC
*types* are static config (jit specializes each combination); BC *values*
(Dirichlet states, prescribed fluxes, atmospheric forcing) may be scalars,
per-column arrays, or callables of time.

Sign convention: flux positive along +z (``boundary_conditions.jl:36-38``).
For Dirichlet-derived gradient fluxes the state difference changes
orientation at the bottom face while the gravitational contribution does
not (see ``_dirichlet_hydrology_flux`` for the deliberate deviation from
the reference's blanket negation); FreeDrainage is bottom-only and never
negated.  The center-to-face distance at a boundary is the half cell
``dz/2`` (``boundary_conditions.jl:196-208``; noted in
``test/SoilModel/dirichlet_bc_as_flux.jl:474-475``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import jax
import jax.numpy as jnp

from landhydrology.domains import ColumnGrid
from landhydrology.models.soil import heat as sh
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any
ValueLike = Union[float, Array, Callable[[Array], Array]]


# --------------------------------------------------------------------------
# BC types (cf. boundary_conditions.jl:17-161)
# --------------------------------------------------------------------------


class AbstractBC:
    """Per-component boundary condition (cf. ``boundary_conditions.jl:19``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NoBC(AbstractBC):
    """No boundary condition — prescribed components
    (cf. ``boundary_conditions.jl:27``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VerticalFlux(AbstractBC):
    """Prescribed vertical boundary flux F = f zhat; positive aligned with +z
    (cf. ``boundary_conditions.jl:43-46``).  ``flux`` may be a constant or a
    callable of time."""

    flux: ValueLike = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Dirichlet(AbstractBC):
    """Boundary value of the state (vartheta_l for hydrology, T for energy),
    possibly time dependent (cf. ``boundary_conditions.jl:61-64``)."""

    state_value: ValueLike = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FreeDrainage(AbstractBC):
    """Free drainage at the bottom: grad(h) = 1, flux = -K(theta_center)
    (cf. ``boundary_conditions.jl:77``, ``:328-356``)."""


class BCKind:
    """Integer codes for per-column mixed BC types (:class:`BatchedBC`)."""

    FLUX = 0
    DIRICHLET = 1
    FREE_DRAINAGE = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedBC(AbstractBC):
    """Per-column mixed boundary-condition types — capability beyond the reference
    (SURVEY.md §2 row 13; north-star config 4: heterogeneous columns with
    mixed BCs).

    ``kind`` is an int array of :class:`BCKind` codes broadcastable to the
    column batch; ``value`` is the operand (prescribed flux for FLUX,
    boundary state for DIRICHLET; ignored for FREE_DRAINAGE), a constant,
    per-column array, or callable of time.  The flux conversion evaluates
    every formula that appears in ``kind`` and selects per column — the
    masked-kernel design the reference's uniform flux-BC conversion makes
    possible (SURVEY.md §3.4).
    """

    kind: Array
    value: Array = 0.0


class AbstractFaceBC:
    """All BCs attached to one boundary face
    (cf. ``boundary_conditions.jl:82``)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SoilComponentBC(AbstractFaceBC):
    """Energy + hydrology BCs for one face
    (cf. ``boundary_conditions.jl:95-101``)."""

    energy: AbstractBC = dataclasses.field(default_factory=NoBC)
    hydrology: AbstractBC = dataclasses.field(default_factory=NoBC)

    def __post_init__(self):
        # validate energy BatchedBC kinds at attachment time, where the
        # codes are still concrete — inside jit / shard_map they become
        # tracers and the runtime check cannot fire
        e = self.energy
        if isinstance(e, BatchedBC) and not isinstance(
            e.kind, jax.core.Tracer
        ):
            if bool(jnp.any(jnp.asarray(e.kind) == BCKind.FREE_DRAINAGE)):
                raise ValueError(
                    "BatchedBC kind FREE_DRAINAGE is not defined for the "
                    "energy component (it is a hydrology-only BC)"
                )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PrescribedAtmosForcing(AbstractFaceBC):
    """Atmospheric state driving Monin-Obukhov surface fluxes at the top face
    (cf. ``boundary_conditions.jl:119-132``).  Fields may be scalars or
    per-column arrays (heterogeneous forcing)."""

    u_atm: Array  # wind speed at z_atm (m/s)
    theta_atm: Array  # potential temperature at z_atm (K)
    z_atm: Array  # measurement height (m)
    theta_scale: Array  # potential temperature scale (K)
    rho_a_sfc: Array  # moist air density at the surface (kg/m^3)
    q_atm: Array  # specific humidity at z_atm


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SoilColumnBC:
    """BCs for both boundary faces (cf. ``boundary_conditions.jl:144-161``)."""

    top: AbstractFaceBC = dataclasses.field(default_factory=SoilComponentBC)
    bottom: SoilComponentBC = dataclasses.field(default_factory=SoilComponentBC)

    def __post_init__(self):
        if isinstance(self.bottom, PrescribedAtmosForcing):
            raise ValueError(
                "Prescribed atmosphere-driven boundary conditions are only "
                "valid at the top of the soil column."
            )


# --------------------------------------------------------------------------
# State -> flux conversion (cf. boundary_conditions.jl:165-489)
# --------------------------------------------------------------------------


def _value_at(v: ValueLike, t: Array) -> Array:
    return jnp.asarray(v(t) if callable(v) else v)


def interior_values(X: dict, face: str) -> tuple:
    """Nearest-center (vartheta_l, theta_i, T) to the boundary ``face``
    (cf. ``boundary_conditions.jl:174-190``).  Fields are ``(nz, *batch)``;
    returns ``(*batch)`` slices."""
    if face not in ("top", "bottom"):
        raise ValueError("Expected 'top' or 'bottom'")
    idx = X["vartheta_l"].shape[0] - 1 if face == "top" else 0
    return X["vartheta_l"][idx], X["theta_i"][idx], X["T"][idx]


def boundary_cf_distance(face: str, grid: ColumnGrid) -> Array:
    """Distance from the last center to the boundary face: the half cell
    (cf. ``boundary_conditions.jl:196-208``)."""
    return grid.dz_boundary


def initialize_boundary_values(X: dict, face: str) -> dict:
    """(center, face) value pairs for vartheta_l, theta_i, T, with the face
    initialized to the center value
    (cf. ``boundary_conditions.jl:218-228``)."""
    vartheta_l, theta_i, T = interior_values(X, face)
    return {
        "vartheta_l": [vartheta_l, vartheta_l],
        "theta_i": [theta_i, theta_i],
        "T": [T, T],
    }


def set_boundary_values(X_cf: dict, bc: AbstractBC, component, t: Array) -> dict:
    """Overwrite the face entry of the pair for Dirichlet BCs
    (cf. ``boundary_conditions.jl:241-288``); no-op otherwise.  Thin wrapper
    over :func:`_with_face_value` (the shared face-overwrite rule)."""
    if isinstance(bc, Dirichlet) and isinstance(
        component, (SoilEnergyModel, SoilHydrologyModel)
    ):
        return _with_face_value(X_cf, component, _value_at(bc.state_value, t))
    return X_cf


def _pairwise(fn, pair_args):
    """Evaluate ``fn`` at the center (index 0) and face (index 1) entries of
    (center, face) pairs; scalar args are shared."""
    out = []
    for i in (0, 1):
        out.append(fn(*[a[i] if isinstance(a, list) else a for a in pair_args]))
    return out


def _free_drainage_flux(component, model: SoilModel, X_cf: dict) -> Array:
    """flux = -K(theta_center): grad(h) = 1 at the bottom
    (cf. ``boundary_conditions.jl:328-356``)."""
    sp = model.soil_param_set
    vartheta_l = X_cf["vartheta_l"][0]
    theta_i = X_cf["theta_i"][0]
    T = X_cf["T"][0]
    hm = component.hydraulic_model
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
    f_i = sw.ice_fraction_of_water(theta_l, theta_i)
    impedance_f = sw.impedance_factor(component.impedance_factor, f_i)
    viscosity_f = sw.viscosity_factor(component.viscosity_factor, T)
    S = sw.effective_saturation(sp.nu, vartheta_l, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, viscosity_f, impedance_f)
    return -K


def _dirichlet_hydrology_flux(
    component, model: SoilModel, X_cf: dict, dz: Array, face: str
) -> Array:
    """Dirichlet water flux from the one-sided head gradient at the face.

    Top face (center below face): flux = -K_face (psi_f - psi_c + dz)/dz.
    Bottom face (center above face): flux = -K_face (psi_c - psi_f + dz)/dz
    — only the psi difference changes orientation; the gravitational +dz
    contribution to dh/dz does not.

    NOTE — deliberate deviation from the reference: ``boundary_conditions.jl
    :396-398`` negates the whole top-face expression at the bottom, which
    also flips the gravity term and injects a spurious upward flux of 2K
    (violates hydrostatic equilibrium under a bottom water-table Dirichlet
    BC; test_bottom_dirichlet_hydrostatic_equilibrium).  The reference never
    exercises a bottom hydrology Dirichlet BC in its test suite, so the
    latent sign bug was invisible there."""
    sp = model.soil_param_set
    hm = component.hydraulic_model
    theta_i_pair = X_cf["theta_i"]
    nu_eff = [sp.nu - th for th in theta_i_pair]
    theta_l = _pairwise(sw.volumetric_liquid_fraction, [X_cf["vartheta_l"], nu_eff])
    f_i = _pairwise(sw.ice_fraction_of_water, [theta_l, theta_i_pair])
    impedance_f = [sw.impedance_factor(component.impedance_factor, f) for f in f_i]
    viscosity_f = [
        sw.viscosity_factor(component.viscosity_factor, T) for T in X_cf["T"]
    ]
    S = _pairwise(
        lambda v: sw.effective_saturation(sp.nu, v, hm.theta_r),
        [X_cf["vartheta_l"]],
    )
    K = [
        sw.hydraulic_conductivity(hm, S[i], viscosity_f[i], impedance_f[i])
        for i in (0, 1)
    ]
    psi = _pairwise(
        lambda v, ne: sw.pressure_head(hm, v, ne, sp.S_s),
        [X_cf["vartheta_l"], nu_eff],
    )
    if face == "bottom":
        return -K[1] * (psi[0] - psi[1] + dz) / dz
    return -K[1] * (psi[1] - psi[0] + dz) / dz


def _dirichlet_energy_flux(
    model: SoilModel, X_cf: dict, dz: Array, face: str
) -> Array:
    """flux = -kappa_face (T_face - T_center) / dz, negated at the bottom
    (cf. ``boundary_conditions.jl:416-444``)."""
    sp = model.soil_param_set
    kappa_dry = sh.k_dry(model.earth_param_set, sp)
    theta_i_pair = X_cf["theta_i"]
    nu_eff = [sp.nu - th for th in theta_i_pair]
    theta_l = _pairwise(sw.volumetric_liquid_fraction, [X_cf["vartheta_l"], nu_eff])
    S_r = _pairwise(
        lambda tl, ti: sh.relative_saturation(tl, ti, sp.nu),
        [theta_l, theta_i_pair],
    )
    kersten = _pairwise(
        lambda ti, sr: sh.kersten_number(ti, sr, sp), [theta_i_pair, S_r]
    )
    kappa_sat = _pairwise(
        lambda tl, ti: sh.saturated_thermal_conductivity(
            tl, ti, sp.kappa_sat_unfrozen, sp.kappa_sat_frozen
        ),
        [theta_l, theta_i_pair],
    )
    kappa = _pairwise(sh.thermal_conductivity, [kappa_dry, kersten, kappa_sat])
    T = X_cf["T"]
    flux = -kappa[1] * (T[1] - T[0]) / dz
    return -flux if face == "bottom" else flux


def _with_face_value(X_cf: dict, component, value: Array) -> dict:
    """A copy of the (center, face) pairs with the component's Dirichlet
    state overwritten at the face."""
    if isinstance(component, SoilEnergyModel):
        return dict(
            X_cf, T=[X_cf["T"][0], jnp.broadcast_to(value, jnp.shape(X_cf["T"][0]))]
        )
    return dict(
        X_cf,
        vartheta_l=[
            X_cf["vartheta_l"][0],
            jnp.broadcast_to(value, jnp.shape(X_cf["vartheta_l"][0])),
        ],
    )


def vertical_flux(
    bc: AbstractBC,
    component,
    X_cf: Optional[dict],
    model: SoilModel,
    dz: Array,
    face: str,
    t: Array,
) -> Optional[Array]:
    """Boundary flux for one (bc, component) combination — the reference's
    ``vertical_flux`` dispatch (cf. ``boundary_conditions.jl:291-444``).
    Returns ``None`` for NoBC."""
    if isinstance(bc, NoBC):
        return None

    if isinstance(bc, VerticalFlux):
        return _value_at(bc.flux, t)

    if isinstance(bc, FreeDrainage):
        if not isinstance(component, SoilHydrologyModel):
            raise TypeError("FreeDrainage applies to the hydrology component only.")
        return _free_drainage_flux(component, model, X_cf)

    if isinstance(bc, Dirichlet):
        if isinstance(component, SoilHydrologyModel):
            return _dirichlet_hydrology_flux(component, model, X_cf, dz, face)
        if isinstance(component, SoilEnergyModel):
            return _dirichlet_energy_flux(model, X_cf, dz, face)

    if isinstance(bc, BatchedBC):
        # per-column masked select among the flux formulas (SURVEY.md §3.4:
        # "per-column BC-type codes select among flux formulas")
        value = _value_at(bc.value, t)
        kind = jnp.asarray(bc.kind)
        X_dir = _with_face_value(X_cf, component, value)
        candidates = [value]  # FLUX: the prescribed value itself
        if isinstance(component, SoilHydrologyModel):
            candidates.append(
                _dirichlet_hydrology_flux(component, model, X_dir, dz, face)
            )
            candidates.append(_free_drainage_flux(component, model, X_cf))
        elif isinstance(component, SoilEnergyModel):
            # free drainage has no energy analogue: reject it eagerly when
            # the kind codes are concrete; traced kinds (jit / shard_map
            # streams) were validated at SoilComponentBC
            # construction, where they are still concrete
            if not isinstance(kind, jax.core.Tracer) and bool(
                jnp.any(kind == BCKind.FREE_DRAINAGE)
            ):
                raise ValueError(
                    "BatchedBC kind FREE_DRAINAGE is not defined for the "
                    "energy component (it is a hydrology-only BC)"
                )
            candidates.append(_dirichlet_energy_flux(model, X_dir, dz, face))
            candidates.append(jnp.zeros_like(candidates[0]))  # unused branch
        else:
            raise TypeError("BatchedBC requires a dynamic component model.")
        shape = jnp.broadcast_shapes(*(jnp.shape(c) for c in candidates), kind.shape)
        candidates = [jnp.broadcast_to(c, shape) for c in candidates]
        kind = jnp.broadcast_to(kind, shape)
        # nested elementwise selects
        return jnp.where(
            kind == BCKind.FLUX,
            candidates[0],
            jnp.where(kind == BCKind.DIRICHLET, candidates[1], candidates[2]),
        )

    raise TypeError(f"Unsupported BC {bc!r} for component {component!r}")


def boundary_fluxes(
    X: dict,
    bc: AbstractFaceBC,
    face: str,
    model: SoilModel,
    grid: ColumnGrid,
    t: Array,
) -> dict:
    """Boundary fluxes ``{'f_rho_e_int':…, 'f_vartheta_l':…}`` for all soil
    components at one face (cf. ``boundary_conditions.jl:470-536``).

    ``X`` is the extended state ``{'vartheta_l', 'theta_i', 'T'}`` on centers
    (a blend of prognostic and prescribed variables).  Values are ``None``
    for NoBC components.
    """
    if isinstance(bc, PrescribedAtmosForcing):
        if face != "top":
            raise ValueError(
                "Prescribed atmosphere-driven boundary conditions are only "
                "valid at the top of the soil column."
            )
        from landhydrology.models.soil.surface_fluxes import (
            compute_turbulent_surface_fluxes,
        )

        vartheta_l, theta_i, T = interior_values(X, face)
        f_rho_e_int, f_vartheta_l = compute_turbulent_surface_fluxes(
            model.energy_model,
            model.hydrology_model,
            model,
            vartheta_l,
            theta_i,
            T,
            t,
        )
        return {"f_rho_e_int": f_rho_e_int, "f_vartheta_l": f_vartheta_l}

    energy = model.energy_model
    hydrology = model.hydrology_model
    X_cf = initialize_boundary_values(X, face)
    X_cf = set_boundary_values(X_cf, bc.energy, energy, t)
    X_cf = set_boundary_values(X_cf, bc.hydrology, hydrology, t)

    dz = boundary_cf_distance(face, grid)
    f_rho_e_int = vertical_flux(bc.energy, energy, X_cf, model, dz, face, t)
    f_vartheta_l = vertical_flux(bc.hydrology, hydrology, X_cf, model, dz, face, t)
    return {"f_rho_e_int": f_rho_e_int, "f_vartheta_l": f_vartheta_l}
