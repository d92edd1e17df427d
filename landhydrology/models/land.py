"""LandModel: multi-component composition (soil + surface water).

The reference anticipates but never builds a multi-component land model
(``initial_conditions.jl:14``: "eventually to be called with LandModel
type"; every state is nested under a model *name* for exactly this reason).
This module supplies it, with the first concrete second component — a
ponded surface-water store with infiltration-capacity-limited exchange
into the soil column, the classic land-surface mechanism (Hortonian
ponding) the reference cannot represent:

- ``SurfaceWaterModel``: prognostic ponded water height ``h_s`` (m) per
  column, fed by a prescribed precipitation rate P(t) and drained into the
  soil at the infiltration rate

      I = min(P + h_s / tau_pond,  f_pot),

  where ``f_pot`` is the potential (saturated-surface Dirichlet) downward
  flux at the top face and ``tau_pond`` converts standing water into
  supply.  When P exceeds capacity, the excess ponds; the pond keeps
  infiltrating after rain stops.
- ``LandModel``: composes the soil model and the surface store into one
  state pytree ``{"soil": {...}, "surface": {"h_s": ...}}`` with a single
  rhs; water is conserved across the component boundary identically
  (d/dt [column water + h_s] = P - bottom outflow).

Everything vectorizes over the column batch like the soil model itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from landhydrology.domains import ColumnGrid, make_function_space
from landhydrology.models.base import AbstractModel
from landhydrology.models.soil.boundary import (
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
    _dirichlet_hydrology_flux,
    initialize_boundary_values,
    _with_face_value,
)
from landhydrology.models.soil.model import SoilHydrologyModel, SoilModel
from landhydrology.models.soil.rhs import make_rhs as make_soil_rhs

Array = Any


def _zero_precip(t):
    return 0.0


@dataclasses.dataclass(frozen=True)
class ConstantPrecipitation:
    """Declarative constant rain rate (m/s) — a callable config object so
    the flagship LandModel serializes through ``config.py`` (arbitrary
    Python closures cannot; cf. the reference's constructor-only config
    surface, SURVEY.md §5)."""

    rate: Array = 0.0

    def __call__(self, t):
        return jnp.asarray(self.rate)


@dataclasses.dataclass(frozen=True)
class PulsePrecipitation:
    """Declarative rain pulse: ``rate`` for ``t_start <= t < t_stop``, dry
    otherwise (trace-safe ``jnp.where``, so it composes with traced step
    times)."""

    rate: Array = 1e-6
    t_start: Array = 0.0
    t_stop: Array = 3600.0

    def __call__(self, t):
        t = jnp.asarray(t)
        on = (t >= self.t_start) & (t < self.t_stop)
        return jnp.where(on, jnp.asarray(self.rate), 0.0)


@dataclasses.dataclass(frozen=True)
class RunoffRouting:
    """Lateral routing of ponded water between neighboring columns on the
    2-D column grid (diffusive-wave approximation): only the pond excess
    above ``h_detention`` routes, with

        dh_s/dt += conductance * lap_xy(max(h_s - h_detention, 0)) / dx^2 .

    Conservative on the periodic grid; under pjit the neighbor rolls lower
    to collective permutes across shards (the config-5 surface coupling
    with real overland-flow hydrology rather than head diffusion).
    """

    conductance: Array = 1e-2  # m^2/s effective diffusivity
    dx: Array = 1.0  # lateral grid spacing (m)
    h_detention: Array = 0.0  # m of pond retained (micro-topography)


@dataclasses.dataclass(frozen=True)
class KinematicWaveRouting:
    """Manning kinematic/diffusive-wave overland flow over real topography —
    the roadmap refinement of :class:`RunoffRouting` (which diffuses pond
    head with a constant conductance and no elevation field).

    Per-face upwinded finite-volume fluxes on the periodic 2-D column grid:
    between two neighboring cells the unit-width discharge is Manning's

        q = sign(s) * sqrt(|s|) * h_up^(5/3) / manning_n        (m^2/s)

    where ``s`` is the driving slope at the face and ``h_up`` the pond
    depth (above ``h_detention``) of the **upwind** cell, so dry cells emit
    nothing and the scheme is conservative by construction (face fluxes
    telescope).  With ``water_surface_slope=True`` (diffusive-wave) the
    slope is of the water surface ``elevation + h_s`` — ponds can fill
    hollows and stop; with ``False`` (kinematic proper) it is the bed slope
    alone.

    ``elevation`` is the per-column terrain height (m), an ``(nx, ny)``
    array (or scalar for flat terrain).  Neighbor access uses ``jnp.roll``
    (periodic; lowers to collective permutes under pjit, like the soil
    lateral coupling).  Explicit stability: the kinematic wave speed is
    ``c = (5/3) h^(2/3) sqrt(|s|) / n``; keep ``dt < dx / max(c)``.
    """

    elevation: Array = 0.0  # terrain height (m), (nx, ny) or scalar
    manning_n: Array = 0.05  # Manning roughness (s / m^(1/3))
    dx: Array = 1.0  # lateral grid spacing (m)
    h_detention: Array = 0.0  # m of pond retained (micro-topography)
    water_surface_slope: bool = True  # diffusive-wave; False = pure kinematic


def _manning_face_flux(s: Array, h_up: Array, manning_n) -> Array:
    """Upwinded Manning unit-width discharge through a face with driving
    slope ``s`` and upwind pond depth ``h_up`` (m^2/s, positive downslope).

    NaN-safe under AD: sqrt has an infinite derivative at 0, so the zero-
    slope branch is masked with a clamped operand (the repo-wide closure
    rule) — gradients stay finite at exact equilibrium (flat water
    surface, filled hollows), where adjoint/calibration runs otherwise see
    0*inf.  Shared by the roll formulation below and the halo-exchange
    formulation (``parallel/halo.py``) so the two are bitwise identical
    per face (device-count invariance of the sharded segment Lie split).
    """
    flowing = jnp.abs(s) > 0.0
    s_safe = jnp.where(flowing, jnp.abs(s), 1.0)
    return jnp.where(
        flowing,
        jnp.sign(s) * jnp.sqrt(s_safe) * h_up ** (5.0 / 3.0) / manning_n,
        0.0,
    )


def _kinematic_wave_tendency(ro: KinematicWaveRouting, h_s: Array) -> Array:
    """dh_s/dt from upwinded Manning face fluxes in both lateral axes
    (see :func:`_manning_face_flux` for the masked closure)."""
    h_eff = jnp.maximum(h_s - ro.h_detention, 0.0)
    z = jnp.broadcast_to(jnp.asarray(ro.elevation, dtype=h_s.dtype), h_s.shape)
    w = z + h_eff if ro.water_surface_slope else z
    dh = jnp.zeros_like(h_s)
    for axis in (0, 1):
        w_dn = jnp.roll(w, -1, axis=axis)  # neighbor at i+1
        s = (w - w_dn) / ro.dx  # >0: flow from i to i+1
        h_up = jnp.where(s > 0.0, h_eff, jnp.roll(h_eff, -1, axis=axis))
        # discharge through face (i, i+1), positive toward i+1
        q = _manning_face_flux(s, h_up, ro.manning_n)
        dh = dh - (q - jnp.roll(q, 1, axis=axis)) / ro.dx
    return dh


def _diffusive_routing_tendency(ro: RunoffRouting, h_s: Array) -> Array:
    """dh_s/dt from head diffusion of the pond excess (5-point Laplacian)."""
    h_eff = jnp.maximum(h_s - ro.h_detention, 0.0)
    lap = (
        jnp.roll(h_eff, 1, axis=0)
        + jnp.roll(h_eff, -1, axis=0)
        + jnp.roll(h_eff, 1, axis=1)
        + jnp.roll(h_eff, -1, axis=1)
        - 4.0 * h_eff
    ) / (ro.dx * ro.dx)
    return ro.conductance * lap


def kinematic_wave_dt_limit(ro: KinematicWaveRouting, h_s: Array) -> Array:
    """Explicit-stability dt estimate for the kinematic wave: ``dx / max c``
    with wave speed ``c = (5/3) h^(2/3) sqrt(|s|) / n`` evaluated at every
    face (the overland-flow analogue of ``diagnostics.explicit_dt_limit``;
    the blow-up is just as silent — runs look fine until the pond deepens).
    """
    h_eff = jnp.maximum(h_s - ro.h_detention, 0.0)
    z = jnp.broadcast_to(jnp.asarray(ro.elevation, dtype=h_s.dtype), h_s.shape)
    w = z + h_eff if ro.water_surface_slope else z
    c_max = jnp.asarray(0.0, dtype=h_s.dtype)
    for axis in (0, 1):
        s = jnp.abs(w - jnp.roll(w, -1, axis=axis)) / ro.dx
        h_face = jnp.maximum(h_eff, jnp.roll(h_eff, -1, axis=axis))
        c = (5.0 / 3.0) * h_face ** (2.0 / 3.0) * jnp.sqrt(s) / ro.manning_n
        c_max = jnp.maximum(c_max, jnp.max(c))
    return ro.dx / jnp.maximum(c_max, 1e-30)


def routing_tendency(ro, h_s: Array) -> Array:
    """Lateral pond-routing tendency for any routing config (single
    dispatch point; new schemes plug in here)."""
    if h_s.ndim < 2:
        raise ValueError(
            "runoff routing requires a 2-D (nx, ny) column grid; "
            f"got pond field of shape {h_s.shape}"
        )
    if isinstance(ro, KinematicWaveRouting):
        return _kinematic_wave_tendency(ro, h_s)
    if isinstance(ro, RunoffRouting):
        return _diffusive_routing_tendency(ro, h_s)
    raise TypeError(f"unknown runoff routing config {ro!r}")


@dataclasses.dataclass(frozen=True)
class SurfaceWaterModel(AbstractModel):
    """Ponded surface-water store (see module docstring).

    ``precipitation(t)`` returns a **non-negative rainfall rate** (m/s,
    scalar or per-column) — NOT a signed vertical flux (rain is a positive
    rate here, unlike the negative downward ``VerticalFlux`` convention);
    ``tau_pond`` (s) is the pond-to-soil supply timescale; ``runoff``
    optionally routes pond excess laterally (requires a 2-D column grid).

    ``h_evap_smoothing`` (m) regularizes the pond/bare-soil evaporation
    switch under MOST forcing: the pond fraction is
    ``w = clip(h_s / h_evap_smoothing, 0, 1)``, so evaporation blends from
    the bare-soil rate to the potential (saturated-surface) rate as the
    pond deepens and shuts off smoothly as it empties (keeps the rhs
    Lipschitz for the explicit steppers and AD).
    """

    precipitation: Callable[[Array], Array] = dataclasses.field(
        default_factory=ConstantPrecipitation
    )
    tau_pond: Array = 60.0
    #: lateral pond routing: RunoffRouting (head diffusion) or
    #: KinematicWaveRouting (Manning flow over topography)
    runoff: Optional[Any] = None
    h_evap_smoothing: Array = 1e-4
    name: str = "surface"


@dataclasses.dataclass(frozen=True)
class LandModel(AbstractModel):
    """Soil column + surface-water store with conservative exchange."""

    soil: SoilModel
    surface: SurfaceWaterModel = dataclasses.field(
        default_factory=SurfaceWaterModel
    )
    name: str = "land"
    #: when to re-evaluate the surface exchange (MOST solves, potential
    #: infiltration): ``"stage"`` = inside every RK stage (the reference's
    #: semantics — SurfaceFluxes.jl runs inside each ``rhs!`` call,
    #: ``boundary_conditions.jl:595-604``); ``"step"`` = once per time step,
    #: frozen across the stages (a first-order splitting of the surface
    #: coupling, same class as the lateral Lie split — the surface state
    #: moves O(dt) per step while the blended MOST multisection solve
    #: dominates the per-stage cost, so this trades an O(dt) coupling error
    #: far below the discretization error for 3x fewer solves).  Enforced by
    #: every driver (Simulation scan, segment runner, pjit-sharded,
    #: segment-sharded) via :class:`FrozenExchangeStepper`.
    surface_update: str = "stage"

    def __post_init__(self):
        from landhydrology.models.soil.boundary import PrescribedAtmosForcing
        from landhydrology.models.soil.model import SoilEnergyModel

        if self.surface_update not in ("stage", "step"):
            raise ValueError(
                "LandModel.surface_update must be 'stage' or 'step'; got "
                f"{self.surface_update!r}"
            )

        if not isinstance(self.soil.hydrology_model, SoilHydrologyModel):
            raise TypeError(
                "LandModel surface coupling requires a dynamic soil "
                "hydrology model"
            )
        bc = self.soil.boundary_conditions
        if bc is not None and isinstance(bc.top, PrescribedAtmosForcing):
            # pond + MOST composition: evaporation/heat flux from the MOST
            # solve combine with rain/infiltration (see make_rhs); the MOST
            # solve needs the surface temperature, i.e. a dynamic energy
            # component (the reference likewise raises for prescribed
            # components, test_prescribed_atmos_bc.jl:161-184)
            if not isinstance(self.soil.energy_model, SoilEnergyModel):
                raise TypeError(
                    "LandModel with a PrescribedAtmosForcing top face needs "
                    "a dynamic SoilEnergyModel (MOST fluxes require the "
                    "soil surface temperature)"
                )

    @property
    def float_dtype(self):
        return self.soil.float_dtype

    def make_rhs(self, grid=None):
        """Composed tendency function (AbstractModel protocol)."""
        return make_rhs(self, grid)


def potential_infiltration(soil: SoilModel, grid: ColumnGrid, X: dict, t) -> Array:
    """Potential (ponded-surface) downward infiltration rate at the top
    face: the magnitude of the Dirichlet-at-saturation flux — the soil's
    own BC conversion machinery evaluated with the face pinned at
    saturation (``vartheta_l = nu``)."""
    X_cf = initialize_boundary_values(X, "top")
    X_cf = _with_face_value(
        X_cf, soil.hydrology_model,
        jnp.asarray(soil.soil_param_set.nu, dtype=soil.float_dtype),
    )
    flux_up = _dirichlet_hydrology_flux(
        soil.hydrology_model, soil, X_cf, grid.dz_boundary, "top"
    )
    # flux is positive along +z; ponded infiltration is downward
    return jnp.maximum(-flux_up, 0.0)


def _diagnose_state_T(soil: SoilModel, Y_soil: dict, Ya: dict) -> Array:
    """Column temperature for the surface-exchange closures: the prescribed
    profile when present, else diagnosed from the dynamic energy state
    (replaces the former hard-coded 288 K fallback for coupled-energy
    soils)."""
    name = soil.name
    vartheta_l = Y_soil["vartheta_l"]
    theta_i = Y_soil["theta_i"]
    if "T" in Ya.get(name, {}):
        return jnp.broadcast_to(Ya[name]["T"], vartheta_l.shape)
    if "rho_e_int" in Y_soil:
        from landhydrology.models.soil import heat as sh
        from landhydrology.models.soil import water as sw

        sp = soil.soil_param_set
        nu_eff = sp.nu - theta_i
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        rho_c_s = sh.volumetric_heat_capacity(
            theta_l, theta_i, sp.rho_c_ds, soil.earth_param_set
        )
        return sh.temperature_from_rho_e_int(
            Y_soil["rho_e_int"], theta_i, rho_c_s, soil.earth_param_set
        )
    # prescribed temperature with no aux field: the model default (288 K)
    return jnp.full_like(vartheta_l, 288.0)


def surface_exchange(land: LandModel, grid: ColumnGrid, X: dict, h_s, t) -> dict:
    """All water/energy exchange rates at the land surface for a given soil
    surface state ``X = {vartheta_l, theta_i, T}`` (full-column fields):

    - ``infiltration``: pond/rain supply into the soil, capacity-limited
      (m/s, downward positive);
    - ``evap_soil`` / ``evap_pond``: effective upward water-volume fluxes
      (m/s) leaving the bare-soil fraction / the pond under MOST forcing
      (zero without a PrescribedAtmosForcing top face).  The pond fraction
      ``w = clip(h_s/h_evap_smoothing, 0, 1)`` blends them — via ONE
      Monin-Obukhov solve over the blended surface humidity
      (:func:`~landhydrology.models.soil.surface_fluxes.
      compute_blended_surface_fluxes`): the pond evaporates at the
      potential (saturated-surface) rate while ``h_s>0``, bare soil at its
      moisture-limited rate;
    - ``heat_flux``: upward surface energy flux (W/m^2) for the soil energy
      BC, blended the same way (pond assumed at the soil surface T).

    This is the single source of truth for the coupling — the rhs and the
    conservation tests both call it (water closure:
    ``d/dt[column + h_s] = P - evap_soil - evap_pond - bottom outflow``).
    """
    from landhydrology.models.soil.boundary import PrescribedAtmosForcing

    soil = land.soil
    top_bc = soil.boundary_conditions.top
    dtype = soil.float_dtype
    P = jnp.asarray(land.surface.precipitation(t), dtype=dtype)
    if not isinstance(P, jax.core.Tracer) and bool(np.any(np.asarray(P) < 0)):
        raise ValueError(
            "SurfaceWaterModel.precipitation must return a non-negative "
            "rainfall rate (m/s); got a negative value — do not use the "
            "signed downward-flux convention here"
        )
    P = jnp.maximum(P, 0.0)

    f_pot = potential_infiltration(soil, grid, X, t)
    supply = P + jnp.maximum(h_s, 0.0) / land.surface.tau_pond
    infiltration = jnp.minimum(supply, f_pot)

    zero = jnp.zeros_like(infiltration)
    out = {
        "P": P,
        "infiltration": infiltration,
        "evap_soil": zero,
        "evap_pond": zero,
        "heat_flux": None,
    }
    if isinstance(top_bc, PrescribedAtmosForcing):
        from landhydrology.models.soil.surface_fluxes import (
            compute_blended_surface_fluxes,
        )

        top = X["vartheta_l"].shape[0] - 1
        v_top = X["vartheta_l"][top]
        ti_top = X["theta_i"][top]
        T_top = X["T"][top]
        w = jnp.clip(
            jnp.maximum(h_s, 0.0) / land.surface.h_evap_smoothing, 0.0, 1.0
        )
        # ONE MOST multisection solve over the blended pond/bare-soil
        # surface (the pond is assumed at the soil surface temperature);
        # the per-component split is exact given the converged scales, so
        # the water budget closes identically — see
        # compute_blended_surface_fluxes for the design note.
        fluxes = compute_blended_surface_fluxes(
            soil.energy_model, soil.hydrology_model, soil,
            v_top, ti_top, T_top, w, t,
        )
        out["evap_soil"] = fluxes["evap_soil"]
        out["evap_pond"] = fluxes["evap_pond"]
        out["heat_flux"] = fluxes["heat_flux"]
    return out


def _exchange_from_state(
    land: LandModel, grid: ColumnGrid, Y: dict, Ya: dict, t: Array
) -> dict:
    """The :func:`surface_exchange` rates evaluated at the state ``(Y, t)``
    (the expensive part of the land rhs — the blended MOST multisection
    solve + the potential-infiltration Dirichlet flux)."""
    soil = land.soil
    name = soil.name
    h_s = Y[land.surface.name]["h_s"]
    # the exchange consumes ONLY the top cell (interior_values /
    # X[...][top] / the half-cell Dirichlet flux), so diagnose T on a
    # 1-level top slab instead of the full column: slice-before-elementwise
    # is bitwise identical per element and spares the nz-wide diagnosis
    # (heat capacity + energy inversion) per exchange evaluation
    nz = Y[name]["vartheta_l"].shape[0]
    nd = jnp.ndim(Y[name]["vartheta_l"])
    Y_top = {k: v[nz - 1 : nz] for k, v in Y[name].items()}
    Ya_soil = Ya.get(name, {})
    # slice only column-shaped leaves: require the PROGNOSTIC rank, not
    # just a leading dim that happens to equal nz — a batch-leading aux
    # field (e.g. per-column (ncol,) data with ncol == nz) must pass
    # through untouched (ADVICE r4)
    Ya_top = {
        name: {
            k: (
                v[v.shape[0] - 1 : v.shape[0]]
                if jnp.ndim(v) == nd and jnp.shape(v)[0] == nz
                else v
            )
            for k, v in Ya_soil.items()
        }
    }
    X = {
        "vartheta_l": Y_top["vartheta_l"],
        "theta_i": Y_top["theta_i"],
        "T": _diagnose_state_T(soil, Y_top, Ya_top),
    }
    return surface_exchange(land, grid, X, h_s, t)


def _rhs_given_exchange(
    land: LandModel,
    grid: ColumnGrid,
    Y: dict,
    Ya: dict,
    t: Array,
    ex: dict,
    C: Optional[dict] = None,
) -> dict:
    """The land tendency for fixed surface-exchange rates ``ex`` (and,
    optionally, fixed soil coefficient fields ``C`` — the
    ``coefficient_update="step"`` composition, see
    ``models/soil/lagged.py``).

    Both sides of the component boundary consume the SAME ``ex`` values
    (the soil top flux and the pond budget), so water closure
    ``d/dt[column + h_s] = P - evap - bottom outflow`` holds identically
    whether ``ex`` is re-evaluated per stage or frozen per step; ``C``
    only replaces the pointwise closure sweep inside the soil tendency
    (still exact flux form), so closure is untouched by lagging too."""
    soil = land.soil
    name = soil.name
    h_s = Y[land.surface.name]["h_s"]
    infiltration = ex["infiltration"]

    # soil sees the infiltration as a downward (negative) top flux plus
    # its bare-soil evaporation (upward positive); the rhs closure is
    # rebuilt per call with the coupled flux values — closure
    # construction is trace-time-only work
    bc = soil.boundary_conditions
    if ex["heat_flux"] is not None:
        energy_bc = VerticalFlux(ex["heat_flux"])
    else:
        energy_bc = getattr(bc.top, "energy", VerticalFlux(0.0))
    soil_t = dataclasses.replace(
        soil,
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(-infiltration + ex["evap_soil"]),
                energy=energy_bc,
            ),
            bottom=bc.bottom,
        ),
    )
    if C is not None:
        from landhydrology.models.soil.lagged import make_coefficient_fns

        _, rhs_c = make_coefficient_fns(soil_t, grid)
        dY_soil = rhs_c(C, {name: Y[name]}, Ya, t)
    else:
        dY_soil = make_soil_rhs(soil_t, grid)({name: Y[name]}, Ya, t)

    dh_s = ex["P"] - infiltration - ex["evap_pond"]
    if land.surface.runoff is not None:
        dh_s = dh_s + routing_tendency(land.surface.runoff, h_s)
    return {
        name: dY_soil[name],
        land.surface.name: {"h_s": dh_s},
    }


def make_rhs(land: LandModel, grid: Optional[ColumnGrid] = None):
    """Composed tendency function over the land state
    ``{"soil": {...}, "surface": {"h_s": ...}}``.

    Always evaluates the surface exchange at the rhs call's own ``(Y, t)``
    (stage-level semantics).  ``LandModel(surface_update="step")`` is
    realized one level up, by the step drivers wrapping the stepper in
    :class:`FrozenExchangeStepper`; the rhs itself stays exact so direct
    ``rhs(Y, Ya, t)`` consumers (diagnostics, adjoints, oracles) are
    unaffected."""
    soil = land.soil
    if grid is None:
        grid = make_function_space(soil.domain, soil.float_dtype)

    def rhs(Y: dict, Ya: dict, t: Array) -> dict:
        ex = _exchange_from_state(land, grid, Y, Ya, t)
        return _rhs_given_exchange(land, grid, Y, Ya, t, ex)

    return rhs


@dataclasses.dataclass(frozen=True)
class FrozenExchangeStepper:
    """Stepper decorator realizing the LandModel's step-level policies:

    - ``LandModel(surface_update="step")``: evaluate the surface exchange
      (the MOST multisection solve + potential infiltration) ONCE at the
      step's initial state ``(Y_n, t_n)`` and hold it fixed across the
      inner stepper's RK stages;
    - ``soil.coefficient_update="step"``: evaluate the soil's nonlinear
      coefficient sweep (K, kappa, rho_e_int_l K, rho_c_s) once per step
      the same way (see ``models/soil/lagged.py``).

    Either, or both, may be active; the step reads the land config.  Both
    are first-order splittings (local error O(dt^2), same class as the
    lateral Lie split in ``parallel/stepping.py``): the surface state and
    the coefficients move O(dt) per step while dt is pinned to the
    vertical diffusion CFL (seconds), so the deviation sits far below the
    discretization error (measured first order in
    ``tests/test_land_model.py::test_surface_update_step_first_order`` and
    ``tests/soil/test_lagged_coefficients.py``).  Mass/energy closure is
    untouched — both sides of the component boundary consume the same
    frozen rates, and the lagged soil tendency stays in exact flux form
    (see ``_rhs_given_exchange``).

    The wrapped ``step`` IGNORES the rhs argument it is handed and drives
    ``_rhs_given_exchange`` directly — by construction the frozen rhs and
    the passed rhs trace the same physics, and ignoring the argument is
    what guarantees no second exchange/coefficient evaluation sneaks in.
    """

    inner: Any
    land: Any
    grid: Any = None

    @property
    def stages(self) -> int:
        return getattr(self.inner, "stages", 1)

    def step(self, rhs, Y, Ya, t, dt):
        land = self.land
        grid = self.grid
        if grid is None:
            grid = make_function_space(
                land.soil.domain, land.float_dtype
            )
        ex = (
            _exchange_from_state(land, grid, Y, Ya, t)
            if land.surface_update == "step"
            else None
        )
        C = None
        if getattr(land.soil, "coefficient_update", "stage") == "step":
            from landhydrology.models.soil.lagged import (
                make_coefficient_fns,
            )

            compute_coeffs, _ = make_coefficient_fns(land.soil, grid)
            C = compute_coeffs({land.soil.name: Y[land.soil.name]}, Ya, t)

        def frozen_rhs(Y_, Ya_, t_):
            ex_ = (
                ex
                if ex is not None
                else _exchange_from_state(land, grid, Y_, Ya_, t_)
            )
            return _rhs_given_exchange(land, grid, Y_, Ya_, t_, ex_, C=C)

        return self.inner.step(frozen_rhs, Y, Ya, t, dt)


def wrap_stepper_for_land(stepper, land, grid=None):
    """Apply the land model's configured step-level policies (frozen
    surface exchange and/or lagged soil coefficients) to a stepper
    (idempotent; no-op when both are ``"stage"`` and for non-land
    models)."""
    wanted = (
        getattr(land, "surface_update", "stage") == "step"
        or getattr(getattr(land, "soil", None), "coefficient_update", "stage")
        == "step"
    )
    if wanted and not isinstance(stepper, FrozenExchangeStepper):
        return FrozenExchangeStepper(inner=stepper, land=land, grid=grid)
    return stepper


def initialize_states(land: LandModel, f_soil, t0, h_s0=0.0):
    """(Y, Ya) for the composed model: soil ICs from ``f_soil`` plus the
    initial pond height (scalar or per-column)."""
    from landhydrology.models.soil.initial_conditions import (
        initialize_states as soil_init,
    )

    Y, Ya = soil_init(land.soil, f_soil, t0)
    batch = land.soil.domain.batch_shape
    Y[land.surface.name] = {
        "h_s": jnp.broadcast_to(
            jnp.asarray(h_s0, dtype=land.float_dtype), batch
        )
    }
    return Y, Ya
