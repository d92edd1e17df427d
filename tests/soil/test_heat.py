"""Heat-equation integration test, mirroring
``/root/reference/test/SoilModel/heat_test_interface.jl``: the periodically
forced heat equation with oscillating Dirichlet bottom T = A cos(w t) on dry
soil, compared to the complex-exponential analytic solution (MSE < 1e-6)."""

import jax.numpy as jnp
import numpy as np
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
from landhydrology.constants import default_earth_param_set as param_set
from landhydrology.models.soil.heat import (
    temperature_from_rho_e_int,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.timestepping import SSPRK33


@pytest.mark.slow
def test_heat_analytic_periodic_forcing():
    rho_c_ds = 0.43314518988433487
    msp = SoilParams(
        nu=0.495,
        nu_ss_gravel=0.1,
        nu_ss_om=0.1,
        nu_ss_quartz=0.1,
        rho_c_ds=rho_c_ds,
        kappa_solid=8.0,
        kappa_sat_unfrozen=0.57,
        kappa_sat_frozen=2.29,
    )
    tau = 1.0
    A = 5.0
    omega = 2.0 * np.pi / tau

    model = SoilModel(
        domain=Column(zlim=(0.0, 1.0), nelements=60),
        energy_model=SoilEnergyModel(),
        hydrology_model=PrescribedHydrologyModel(),  # dry soil
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=Dirichlet(lambda t: jnp.zeros_like(t))),
            bottom=SoilComponentBC(
                energy=Dirichlet(lambda t: A * jnp.cos(omega * t))
            ),
        ),
        soil_param_set=msp,
    )

    with pytest.raises(ValueError):
        model.default_initial_conditions()

    def ic(z, m):
        rho_c_s = volumetric_heat_capacity(0.0, 0.0, rho_c_ds, param_set)
        rho_e_int = volumetric_internal_energy(
            jnp.zeros_like(z), rho_c_s, jnp.zeros_like(z), param_set
        )
        return {"rho_e_int": rho_e_int}

    Y, Ya = initialize_states(model, ic, 0.0)
    tf, dt = 2.0, 1e-4
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf),
        saveat=60 * dt,
    )
    sim.step()
    sol = sim.run()

    z = np.asarray(Ya["zc"]).ravel()
    # analytic solution of the periodically forced heat equation
    # (heat_test_interface.jl:88-92); diffusivity = 1 for these parameters
    num = np.exp(np.sqrt(omega / 2) * (1 + 1j) * (1 - z)) - np.exp(
        -np.sqrt(omega / 2) * (1 + 1j) * (1 - z)
    )
    denom = np.exp(np.sqrt(omega / 2) * (1 + 1j)) - np.exp(
        -np.sqrt(omega / 2) * (1 + 1j)
    )
    analytic = np.real(num * A * np.exp(1j * omega * tf) / denom)

    rho_e_f = np.asarray(sol.state(-1)["soil"]["rho_e_int"])
    rho_c_s = volumetric_heat_capacity(0.0, 0.0, rho_c_ds, param_set)
    T_final = np.asarray(
        temperature_from_rho_e_int(rho_e_f, 0.0, rho_c_s, param_set)
    )
    mse = np.mean((analytic - T_final) ** 2)
    assert mse < 1e-6
