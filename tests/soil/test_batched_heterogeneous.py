"""Heterogeneous-batch tests — the package's scale axis (SURVEY.md §2
row 13, north-star config 4): per-column van Genuchten parameters and
per-column mixed BC types must reproduce the equivalent homogeneous runs
column by column."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from landhydrology import (
    BatchedBC,
    BCKind,
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
    VerticalFlux,
    initialize_states,
)
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33

NZ = 30
IC = 0.12


def _single_model(bc_bottom, hm, nu):
    return SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.24)),
            bottom=SoilComponentBC(hydrology=bc_bottom),
        ),
        soil_param_set=SoilParams(nu=nu, S_s=1e-3),
    )


def _ic(z, m):
    return {"vartheta_l": jnp.full_like(z, IC), "theta_i": jnp.zeros_like(z)}


def _run(model, tf=30.0, dt=0.25):
    Y, Ya = initialize_states(model, _ic, 0.0)
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf))
    sim.run()
    return np.asarray(sim.Y["soil"]["vartheta_l"])


def test_mixed_bc_types_match_homogeneous_runs():
    """3 columns with bottom BCs [flux, dirichlet, free-drainage] in one
    batched run == 3 separate single-column runs."""
    hm = vanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5, theta_r=0.075)
    nu = 0.3

    singles = [
        _run(_single_model(VerticalFlux(-1e-7), hm, nu)),
        _run(_single_model(Dirichlet(lambda t: 0.15), hm, nu)),
        _run(_single_model(FreeDrainage(), hm, nu)),
    ]

    batched_bottom = BatchedBC(
        kind=jnp.array([BCKind.FLUX, BCKind.DIRICHLET, BCKind.FREE_DRAINAGE]),
        value=jnp.array([-1e-7, 0.15, 0.0]),
    )
    model_b = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(3,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.24)),
            bottom=SoilComponentBC(hydrology=batched_bottom),
        ),
        soil_param_set=SoilParams(nu=nu, S_s=1e-3),
    )
    batched = _run(model_b)
    assert batched.shape == (NZ, 3)
    for j in range(3):
        np.testing.assert_allclose(batched[:, j], singles[j], rtol=1e-12, atol=1e-15)


def test_heterogeneous_van_genuchten_params():
    """Per-column (n, alpha, Ksat) arrays == separate homogeneous runs."""
    ns = [2.5, 3.96]
    alphas = [2.0, 2.7]
    ksats = [5e-6, 34.0 / 3600.0 / 100.0]
    nu = 0.287

    singles = [
        _run(
            _single_model(
                FreeDrainage(),
                vanGenuchten(n=ns[j], alpha=alphas[j], Ksat=ksats[j], theta_r=0.075),
                nu,
            )
        )
        for j in range(2)
    ]

    hm_b = vanGenuchten(
        n=jnp.asarray(ns), alpha=jnp.asarray(alphas), Ksat=jnp.asarray(ksats),
        theta_r=0.075,
    )
    model_b = _single_model(FreeDrainage(), hm_b, nu)
    model_b = dataclasses.replace(
        model_b, domain=Column(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(2,))
    )
    batched = _run(model_b)
    for j in range(2):
        np.testing.assert_allclose(batched[:, j], singles[j], rtol=1e-12, atol=1e-15)


def test_large_batch_jits_once_and_scales():
    """A 1024-column heterogeneous batch steps in one jit call."""
    rng = np.random.default_rng(0)
    ncol = 1024
    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.3, 4.0, ncol)),
        alpha=jnp.asarray(rng.uniform(1.0, 6.0, ncol)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-4, ncol)),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.1, ncol)),
    )
    nu = jnp.asarray(rng.uniform(0.25, 0.5, ncol))
    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(ncol,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=nu, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.broadcast_to(0.5 * nu, (NZ, ncol)),
            "theta_i": jnp.zeros((NZ, ncol)),
        },
        0.0,
    )
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, 50.0))
    sim.run()
    out = np.asarray(sim.Y["soil"]["vartheta_l"])
    assert out.shape == (NZ, ncol)
    assert np.all(np.isfinite(out))
    assert np.all(out >= 0.0) and np.all(out <= 0.52)
