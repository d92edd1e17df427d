"""Soil component-model lattice and the top-level SoilModel.

Re-design of ``/root/reference/src/SoilModel/models.jl``: the
Julia type-dispatch lattice (2 energy x 2 hydrology variants) becomes a
config lattice of frozen dataclasses; ``make_rhs`` (rhs.py) selects pure
functions by ``isinstance`` at trace time, so jit specializes each combo with
zero runtime dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp

from landhydrology.constants import EarthParameterSet, default_earth_param_set
from landhydrology.domains import Column
from landhydrology.models.base import AbstractModel
from landhydrology.models.soil.params import SoilParams
from landhydrology.models.soil.water import (
    AbstractConductivityFactor,
    NoEffect,
    vanGenuchten,
)

Array = Any


class AbstractSoilComponentModel:
    """Supertype of the soil component models (cf. ``models.jl:7``)."""


@dataclasses.dataclass(frozen=True)
class SoilEnergyModel(AbstractSoilComponentModel):
    """Solve the soil heat PDE for rho_e_int (cf. ``models.jl:17``)."""


@dataclasses.dataclass(frozen=True)
class SoilHydrologyModel(AbstractSoilComponentModel):
    """Solve Richards equation for vartheta_l (cf. ``models.jl:28-33``)."""

    hydraulic_model: vanGenuchten = dataclasses.field(default_factory=vanGenuchten)
    viscosity_factor: AbstractConductivityFactor = dataclasses.field(
        default_factory=NoEffect
    )
    impedance_factor: AbstractConductivityFactor = dataclasses.field(
        default_factory=NoEffect
    )


def _default_T_profile(z, t):
    """288 K everywhere — the viscosity-effect reference temperature
    (cf. ``models.jl:53``)."""
    return jnp.full_like(z, 288.0)


def _default_zero_profile(z, t):
    return jnp.zeros_like(z)


@dataclasses.dataclass(frozen=True)
class PrescribedTemperatureModel(AbstractSoilComponentModel):
    """Prescribe T(z, t) instead of solving the heat PDE
    (cf. ``models.jl:51-54``)."""

    T_profile: Callable[[Array, Array], Array] = _default_T_profile


@dataclasses.dataclass(frozen=True)
class PrescribedHydrologyModel(AbstractSoilComponentModel):
    """Prescribe vartheta_l(z, t) and theta_i(z, t) instead of solving
    Richards equation (cf. ``models.jl:73-78``)."""

    vartheta_l_profile: Callable[[Array, Array], Array] = _default_zero_profile
    theta_i_profile: Callable[[Array, Array], Array] = _default_zero_profile


@dataclasses.dataclass(frozen=True)
class LateralSurfaceCoupling:
    """Lateral surface-water coupling between neighboring columns — a new
    Capability beyond the reference (SURVEY.md §2 row 14: the
    reference's columns are fully independent; the north star adds a
    lateral surface-coupling term, driver ``BASELINE.json`` config 5).

    Columns must be laid out on a 2-D ``(nx, ny)`` batch grid.  The top
    (surface) cell of each column exchanges water with its four lateral
    neighbors by linear diffusion of the surface hydraulic head:

        d vartheta_l[top] / dt  +=  (c / dz) * lap_xy(h[top])

    with ``lap_xy`` the 5-point Laplacian on the periodic column grid and
    ``c`` an effective surface conductance (m^2/s).  On a sharded mesh the
    neighbor access becomes halo exchange (``parallel/halo.py``) overlapped
    with the vertical sweeps.
    """

    conductance: Array = 1e-6  # m^2/s
    dx: Array = 1.0  # lateral grid spacing (m)


@dataclasses.dataclass(frozen=True)
class SoilModel(AbstractModel):
    """The soil column model aggregate (cf. ``models.jl:90-135``).

    A pure configuration object: ``make_rhs(model)`` compiles it into the
    tendency function; ``initialize_states(model, ic, t0)`` allocates state.
    ``dtype`` is an explicit config axis (the reference threads a Julia FT
    type parameter through everything; SURVEY.md §5).
    """

    domain: Column
    energy_model: AbstractSoilComponentModel = dataclasses.field(
        default_factory=SoilEnergyModel
    )
    hydrology_model: AbstractSoilComponentModel = dataclasses.field(
        default_factory=SoilHydrologyModel
    )
    boundary_conditions: Any = None  # SoilColumnBC; typed in boundary.py
    soil_param_set: SoilParams = dataclasses.field(default_factory=SoilParams)
    earth_param_set: EarthParameterSet = default_earth_param_set
    name: str = "soil"
    dtype: Any = None  # None -> canonical default float (f64 if x64 enabled)
    #: optional cross-column surface coupling (requires a 2-D column grid)
    lateral_coupling: Optional[LateralSurfaceCoupling] = None
    #: optional freeze-thaw phase change (coupled combo only; the reference
    #: carries theta_i prognostically but zeroes its tendency — see
    #: models/soil/freeze_thaw.py)
    freeze_thaw: Optional[Any] = None
    #: static promise that theta_i is identically zero (valid whenever the
    #: IC has no ice and freeze_thaw is None, since d theta_i/dt == 0).
    #: Lets the RHS drop the frozen branches of the thermal closures and the
    #: effective-porosity correction — an exact specialization worth ~15%
    #: on the compute-bound sweep.
    assume_no_ice: bool = False
    #: when to re-evaluate the nonlinear coefficient fields (K, kappa,
    #: rho_e_int_l, rho_c_s — ``right_hand_side.jl:291-312``):
    #: ``"stage"`` = inside every RK stage (the reference's semantics);
    #: ``"step"`` = once per time step, frozen across the stages — a
    #: first-order splitting (same class as ``LandModel.surface_update``)
    #: that removes most of the pointwise closure sweep from 2 of 3 SSPRK33
    #: stages.  Enforced by every engine via
    #: :class:`~landhydrology.models.soil.lagged.LaggedCoefficientStepper`
    #: (see ``models/soil/lagged.py`` for the accuracy model and the
    #: when-to-use rule).
    coefficient_update: str = "stage"

    def __post_init__(self):
        if self.assume_no_ice and self.freeze_thaw is not None:
            raise ValueError("assume_no_ice is incompatible with freeze_thaw")
        if self.coefficient_update not in ("stage", "step"):
            raise ValueError(
                "SoilModel.coefficient_update must be 'stage' or 'step'; "
                f"got {self.coefficient_update!r}"
            )
        if self.freeze_thaw is not None:
            # the phase-change machinery reads rho_e_int and the hydraulic
            # retention curve: a prescribed component would fail at the first
            # step with a raw KeyError/AttributeError deep in the projection
            # (the reference likewise restricts its coupled-only physics,
            # right_hand_side.jl:269-369) — validate at construction instead
            if not isinstance(self.energy_model, SoilEnergyModel):
                raise TypeError(
                    "freeze_thaw requires a dynamic SoilEnergyModel (phase "
                    "change is driven by the prognostic rho_e_int); got "
                    f"{type(self.energy_model).__name__}"
                )
            if not isinstance(self.hydrology_model, SoilHydrologyModel):
                raise TypeError(
                    "freeze_thaw requires a dynamic SoilHydrologyModel (the "
                    "equilibrium liquid fraction comes from its retention "
                    f"curve); got {type(self.hydrology_model).__name__}"
                )

    @property
    def float_dtype(self):
        if self.dtype is not None:
            return jnp.dtype(self.dtype)
        return jnp.result_type(jnp.zeros((), jnp.float64))

    def default_initial_conditions(self):
        """Default ICs: isothermal at T_0, no ice, vartheta_l = nu/2
        (cf. ``models.jl:147-166``).  Only defined for the fully dynamic
        (SoilEnergyModel, SoilHydrologyModel) combination."""
        from landhydrology.models.soil.initial_conditions import (
            default_initial_conditions,
        )

        return default_initial_conditions(self)

    def make_rhs(self, grid=None):
        """Tendency function for this model (the AbstractModel protocol the
        Simulation driver dispatches on)."""
        from landhydrology.models.soil.rhs import make_rhs

        return make_rhs(self, grid)
