"""landhydrology — a land-hydrology framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
CliMA/LandHydrology.jl (reference layout: ``src/LandHydrology.jl:1-8``):
a batched 1-D soil-column solver for coupled water (Richards equation)
and energy (heat equation) transport, built for accelerators:

- ClimaCore column Fields/Operators -> batched ``(nz, *batch)`` device
  arrays + vertical-sweep stencils that XLA fuses.
- OrdinaryDiffEq SSPRK33 stepping   -> jit-compiled ``lax.scan`` loops.
- Julia type-dispatch model lattice -> a config lattice selecting pure
  functions (energy x hydrology x BC kind).
- single serial column             -> columns sharded over a
  ``jax.sharding.Mesh`` with collective halo exchange for lateral
  surface coupling.

Public API mirrors the reference's module surface (see SURVEY.md §1-2).
"""

from landhydrology.constants import EarthParameterSet, default_earth_param_set
from landhydrology.domains import (
    Column,
    ColumnGrid,
    VariableDepthColumn,
    make_function_space,
)
from landhydrology.models.soil import (
    BatchedBC,
    BCKind,
    FreeDrainage,
    Dirichlet,
    NoBC,
    PrescribedAtmosForcing,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    boundary_fluxes,
    compute_turbulent_surface_fluxes,
    default_initial_conditions,
    initialize_auxiliary,
    initialize_prognostic,
    initialize_states,
    make_rhs,
    make_update_aux,
)
from landhydrology.simulations import Simulation, run, step

__version__ = "0.1.0"

__all__ = [
    "EarthParameterSet",
    "default_earth_param_set",
    "Column",
    "ColumnGrid",
    "VariableDepthColumn",
    "make_function_space",
    "SoilParams",
    "SoilModel",
    "SoilEnergyModel",
    "SoilHydrologyModel",
    "PrescribedTemperatureModel",
    "PrescribedHydrologyModel",
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
    "make_rhs",
    "make_update_aux",
    "initialize_states",
    "initialize_prognostic",
    "initialize_auxiliary",
    "default_initial_conditions",
    "Simulation",
    "run",
    "step",
]
