"""Coupled water+energy integration test, mirroring
``/root/reference/test/SoilModel/coupled.jl:1-120``: relaxation to
hydrostatic equilibrium with the water table at z = -0.3 AND a uniform
temperature of 284.0 K (energy mixes through conduction + advection)."""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    initialize_states,
)
from landhydrology.constants import default_earth_param_set as param_set
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.heat import (
    k_solid,
    ksat_frozen,
    ksat_unfrozen,
    temperature_from_rho_e_int,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.timestepping import SSPRK33


def _expected_theta(z, z_interface, nu=0.5, S_s=1e-3, alpha=2.6, n=2.0, m=0.5):
    z = np.asarray(z)
    unsat = nu * (1 + (alpha * (z - z_interface)) ** n) ** (-m)
    sat = -S_s * (z - z_interface) + nu
    return np.where(z < z_interface, sat, unsat)


@pytest.mark.slow
def test_coupled_equilibrium():
    nu = 0.5
    Ksat = 0.0443 / 3600 / 100
    kappa_solid = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    rho_c_ds = (1 - nu) * 1.926e6
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_gravel=0.0,
        nu_ss_om=0.0,
        nu_ss_quartz=0.92,
        rho_c_ds=rho_c_ds,
        kappa_solid=kappa_solid,
        kappa_sat_unfrozen=ksat_unfrozen(kappa_solid, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(kappa_solid, nu, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=20),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=Ksat, theta_r=0.0)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
    )

    def ic(z, m):
        T = 289.0 + 5.0 * z
        theta_i = jnp.zeros_like(z)
        theta_l = jnp.full_like(z, 0.495)
        rho_c_s = volumetric_heat_capacity(theta_l, theta_i, rho_c_ds, param_set)
        rho_e_int = volumetric_internal_energy(theta_i, rho_c_s, T, param_set)
        return {"vartheta_l": theta_l, "theta_i": theta_i, "rho_e_int": rho_e_int}

    Y, Ya = initialize_states(model, ic, 0.0)
    tf = 60.0 * 60.0 * 24.0 * 32.0
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=20.0, tspan=(0.0, tf),
        saveat=1200.0,
    )
    sol = sim.run()

    z = np.asarray(Ya["zc"]).ravel()
    vlf = np.asarray(sol.state(-1)["soil"]["vartheta_l"])
    rho_e = np.asarray(sol.state(-1)["soil"]["rho_e_int"])
    rho_c_s = volumetric_heat_capacity(vlf, 0.0, rho_c_ds, param_set)
    temp = np.asarray(temperature_from_rho_e_int(rho_e, 0.0, rho_c_s, param_set))

    # reference norms (coupled.jl:117-118)
    assert np.sqrt(np.mean(vlf - _expected_theta(z, -0.3)) ** 2) < 1e-3
    assert np.sqrt(np.mean(temp - 284.0) ** 2) < 1e-3
    # energy conservation: zero-flux BCs -> total rho_e_int exactly conserved
    e0 = float(np.sum(np.asarray(Y["soil"]["rho_e_int"])))
    ef = float(np.sum(rho_e))
    assert abs(ef - e0) / abs(e0) < 1e-10
