"""Regenerate the grid-converged infiltration golden
(``golden_infiltration_fine.npz``): the sand-infiltration configuration of
``richards_equation.jl:98-190`` at 4x the reference resolution (n=600,
dt=0.0125, f64).  Convergence evidence at generation time: l2 of the n=300
solution vs this profile was 0.0038 and n=150 was 0.0099 (second-order-ish
toward the front-limited rate).

Usage: python tests/data/make_golden_infiltration.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

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


def main():
    n, dt, tf = 600, 0.0125, 0.8 * 3600
    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=n),
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
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf))
    sim.run()
    out = os.path.join(os.path.dirname(__file__), "golden_infiltration_fine.npz")
    np.savez(
        out,
        z=np.asarray(Ya["zc"]).ravel(),
        vartheta_l=np.asarray(sim.Y["soil"]["vartheta_l"]),
        meta_n=n,
        meta_dt=dt,
        meta_tf=tf,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
