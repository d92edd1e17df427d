"""Spatial convergence study: the FV discretization is 2nd-order in dz on
the linear heat equation against the exact periodic-forcing solution — a
tier the reference does not have (its analytic tests run a single
resolution)."""

import numpy as np
import jax.numpy as jnp
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    PrescribedHydrologyModel,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil.heat import (
    temperature_from_rho_e_int,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.timestepping import SSPRK33

RHO_C_DS = 0.43314518988433487  # unit diffusivity config (heat test)
TAU, A = 1.0, 5.0
OMEGA = 2.0 * np.pi / TAU


def _error_at_resolution(n):
    msp = SoilParams(
        nu=0.495,
        nu_ss_gravel=0.1,
        nu_ss_om=0.1,
        nu_ss_quartz=0.1,
        rho_c_ds=RHO_C_DS,
        kappa_solid=8.0,
        kappa_sat_unfrozen=0.57,
        kappa_sat_frozen=2.29,
    )
    model = SoilModel(
        domain=Column(zlim=(0.0, 1.0), nelements=n),
        energy_model=SoilEnergyModel(),
        hydrology_model=PrescribedHydrologyModel(),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=Dirichlet(lambda t: jnp.zeros_like(t))),
            bottom=SoilComponentBC(
                energy=Dirichlet(lambda t: A * jnp.cos(OMEGA * t))
            ),
        ),
        soil_param_set=msp,
    )

    def ic(z, m):
        rho_c_s = volumetric_heat_capacity(0.0, 0.0, RHO_C_DS, ps)
        return {
            "rho_e_int": volumetric_internal_energy(
                jnp.zeros_like(z), rho_c_s, jnp.zeros_like(z), ps
            )
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    tf = 2.0
    # dt well below the CFL limit at the finest grid so spatial error dominates
    dt = 2e-5
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf))
    sim.run()

    z = np.asarray(Ya["zc"]).ravel()
    num = np.exp(np.sqrt(OMEGA / 2) * (1 + 1j) * (1 - z)) - np.exp(
        -np.sqrt(OMEGA / 2) * (1 + 1j) * (1 - z)
    )
    denom = np.exp(np.sqrt(OMEGA / 2) * (1 + 1j)) - np.exp(
        -np.sqrt(OMEGA / 2) * (1 + 1j)
    )
    analytic = np.real(num * A * np.exp(1j * OMEGA * tf) / denom)
    rho_c_s = volumetric_heat_capacity(0.0, 0.0, RHO_C_DS, ps)
    T = np.asarray(
        temperature_from_rho_e_int(
            np.asarray(sim.Y["soil"]["rho_e_int"]), 0.0, rho_c_s, ps
        )
    )
    return np.sqrt(np.mean((T - analytic) ** 2))


@pytest.mark.slow
def test_second_order_spatial_convergence():
    errs = [_error_at_resolution(n) for n in (15, 30, 60)]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    # 2nd-order interior + boundary treatment: observed order ~2
    assert all(o > 1.7 for o in orders), (errs, orders)
