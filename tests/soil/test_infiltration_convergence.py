"""Sand-infiltration validation against a committed grid-converged
reference profile — the analogue of the reference's Bonan (2019) data test
(``richards_equation.jl:98-190``, l2 < 0.1 over the final profile).  The
reference fetches its comparison CSV from a remote artifact that is not
vendored; here the committed golden is a dz- and dt-refined (n=600,
dt=0.0125) f64 solution of the same configuration (regenerate with
tests/data/make_golden_infiltration.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedTemperatureModel,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33

GOLDEN = os.path.join(
    os.path.dirname(__file__), "..", "data", "golden_infiltration_fine.npz"
)


@pytest.mark.slow
def test_infiltration_profile_matches_converged_reference():
    data = np.load(GOLDEN)
    z_fine, v_fine = data["z"], data["vartheta_l"]

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=150),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=3.96, alpha=2.7, Ksat=34 / 3600 / 100, theta_r=0.075
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full_like(z, 0.1),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.25, tspan=(0.0, 0.8 * 3600)
    )
    sim.run()
    z = np.asarray(Ya["zc"]).ravel()
    v = np.asarray(sim.Y["soil"]["vartheta_l"])

    ref_on_coarse = np.interp(z, z_fine, v_fine)
    err = np.sqrt(np.sum((v - ref_on_coarse) ** 2))
    # the reference's criterion vs the Bonan profile at the same resolution
    assert err < 0.1, err
