"""Randomized robustness sweep: random physical states, parameters, and BC
combinations through every model combo must produce finite tendencies —
the NaN-safety contract of the masked closures under adversarial inputs
(near-saturation, near-residual, frozen, supersaturated)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.domains import make_function_space
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.freeze_thaw import FreezeThaw
from landhydrology.models.soil.heat import (
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.models.soil.rhs import make_rhs

NZ, NCOL = 12, 16


def _random_bc(rng, component):
    choice = rng.integers(0, 3)
    if choice == 0:
        return VerticalFlux(float(rng.normal(0.0, 1e-6)))
    if choice == 1:
        if component == "hydrology":
            return Dirichlet(float(rng.uniform(0.05, 0.4)))
        return Dirichlet(float(rng.uniform(260.0, 310.0)))
    if component == "hydrology":
        return FreeDrainage()
    return VerticalFlux(0.0)


@pytest.mark.parametrize("seed", range(6))
def test_random_states_give_finite_tendencies(seed):
    rng = np.random.default_rng(seed)
    nu = float(rng.uniform(0.3, 0.55))
    hm = vanGenuchten(
        n=float(rng.uniform(1.2, 4.0)),
        alpha=float(rng.uniform(0.5, 7.0)),
        Ksat=float(10 ** rng.uniform(-8, -4)),
        theta_r=float(rng.uniform(0.0, 0.1)),
    )
    sp = SoilParams(nu=nu, S_s=1e-3, rho_c_ds=float(rng.uniform(5e5, 3e6)))
    combos = [
        (SoilEnergyModel(), SoilHydrologyModel(hydraulic_model=hm)),
        (PrescribedTemperatureModel(), SoilHydrologyModel(hydraulic_model=hm)),
        (SoilEnergyModel(), PrescribedHydrologyModel()),
    ]
    energy, hydrology = combos[seed % 3]

    bc = SoilColumnBC(
        top=SoilComponentBC(
            hydrology=(
                _random_bc(rng, "hydrology")
                if isinstance(hydrology, SoilHydrologyModel)
                else VerticalFlux(0.0)
            ),
            energy=(
                _random_bc(rng, "energy")
                if isinstance(energy, SoilEnergyModel)
                else VerticalFlux(0.0)
            ),
        ),
        bottom=SoilComponentBC(
            hydrology=(
                _random_bc(rng, "hydrology")
                if isinstance(hydrology, SoilHydrologyModel)
                else VerticalFlux(0.0)
            ),
            energy=(
                VerticalFlux(0.0)
                if not isinstance(energy, SoilEnergyModel)
                else VerticalFlux(float(rng.normal(0.0, 1.0)))
            ),
        ),
    )
    freeze = FreezeThaw(tau=600.0) if (
        seed % 2 and isinstance(energy, SoilEnergyModel)
        and isinstance(hydrology, SoilHydrologyModel)
    ) else None
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=energy,
        hydrology_model=hydrology,
        boundary_conditions=bc,
        soil_param_set=sp,
        freeze_thaw=freeze,
    )

    # adversarial states: residual-dry, saturated, supersaturated, frozen
    theta = jnp.asarray(
        rng.uniform(hm.theta_r * 0.5, nu * 1.05, (NZ, NCOL))
    )
    theta_i = jnp.asarray(
        np.where(rng.random((NZ, NCOL)) < 0.3, rng.uniform(0, 0.2, (NZ, NCOL)), 0.0)
    )
    T = jnp.asarray(rng.uniform(250.0, 320.0, (NZ, NCOL)))
    rcs = volumetric_heat_capacity(theta, theta_i, sp.rho_c_ds, ps)
    rho_e = volumetric_internal_energy(theta_i, rcs, T, ps)

    grid = make_function_space(model.domain, jnp.float64)
    Ya = {"zc": grid.zc, "soil": {}}
    Y = {"soil": {}}
    if isinstance(hydrology, SoilHydrologyModel):
        Y["soil"]["vartheta_l"] = theta
        Y["soil"]["theta_i"] = theta_i
    else:
        Ya["soil"]["vartheta_l"] = theta
        Ya["soil"]["theta_i"] = theta_i
    if isinstance(energy, SoilEnergyModel):
        Y["soil"]["rho_e_int"] = rho_e
    else:
        Ya["soil"]["T"] = T

    dY = make_rhs(model, grid)(Y, Ya, jnp.asarray(0.0))
    for k, v in dY["soil"].items():
        assert np.all(np.isfinite(np.asarray(v))), (seed, k)
