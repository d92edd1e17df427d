"""The soil column model family.

Mirrors the module surface of the reference's ``SoilInterface``
(``/root/reference/src/SoilModel/SoilInterface.jl:1-21``): water/heat
parameterizations as nested submodules, parameters, model types, boundary
conditions, RHS assembly, and initial conditions.
"""

from landhydrology.models.soil import heat as SoilHeatParameterizations
from landhydrology.models.soil import water as SoilWaterParameterizations
from landhydrology.models.soil.boundary import (
    BatchedBC,
    BCKind,
    Dirichlet,
    FreeDrainage,
    NoBC,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
    boundary_fluxes,
)
from landhydrology.models.soil.initial_conditions import (
    default_initial_conditions,
    initialize_auxiliary,
    initialize_prognostic,
    initialize_states,
    prognostic_vars,
)
from landhydrology.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology.models.soil.params import SoilParams
from landhydrology.models.soil.rhs import make_rhs, make_update_aux
from landhydrology.models.soil.surface_fluxes import (
    compute_turbulent_surface_fluxes,
    surface_conditions,
)
from landhydrology.models.soil.water import (
    IceImpedance,
    NoEffect,
    TemperatureDependentViscosity,
    vanGenuchten,
)

__all__ = [
    "SoilWaterParameterizations",
    "SoilHeatParameterizations",
    "SoilParams",
    "SoilModel",
    "SoilEnergyModel",
    "SoilHydrologyModel",
    "PrescribedTemperatureModel",
    "PrescribedHydrologyModel",
    "vanGenuchten",
    "NoEffect",
    "TemperatureDependentViscosity",
    "IceImpedance",
    "NoBC",
    "BatchedBC",
    "BCKind",
    "VerticalFlux",
    "Dirichlet",
    "FreeDrainage",
    "SoilComponentBC",
    "SoilColumnBC",
    "PrescribedAtmosForcing",
    "boundary_fluxes",
    "compute_turbulent_surface_fluxes",
    "surface_conditions",
    "make_rhs",
    "make_update_aux",
    "initialize_states",
    "initialize_prognostic",
    "initialize_auxiliary",
    "default_initial_conditions",
    "prognostic_vars",
]
