"""Variable-depth column batches (``VariableDepthColumn``) — heterogeneous
terrain where every column has its own depth.

Design under test: each column keeps ``nz`` cells while ``dz`` varies per
column, so fields stay dense ``(nz, *batch)`` arrays and every stencil/BC
formula (including the half-cell Dirichlet distance of the reference,
``boundary_conditions.jl:196-208``) broadcasts over the per-column spacing.
Columns are physically independent, so a mixed-depth batch must reproduce
the equivalent single-depth runs column by column — on the XLA path and
inside the segment runner.
"""

import dataclasses

import jax
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
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VariableDepthColumn,
    VerticalFlux,
    initialize_states,
    make_function_space,
)
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33

NZ = 24
DEPTHS = [0.8, 1.5, 3.0]


def _hm():
    return vanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5, theta_r=0.075)


def _richards_model(domain, bc_bottom=None):
    return SoilModel(
        domain=domain,
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=_hm()),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.24)),
            bottom=SoilComponentBC(hydrology=bc_bottom or FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
    )


def _ic(z, m):
    return {"vartheta_l": jnp.full_like(z, 0.12), "theta_i": jnp.zeros_like(z)}


def _run(model, tf=30.0, dt=0.25):
    Y, Ya = initialize_states(model, _ic, 0.0)
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf))
    sim.run()
    return np.asarray(sim.Y["soil"]["vartheta_l"])


def test_grid_construction():
    dom = VariableDepthColumn(
        z_bottom=jnp.asarray([-d for d in DEPTHS]), nelements=NZ, batch_shape=(3,)
    )
    grid = make_function_space(dom, jnp.float64)
    assert grid.zc.shape == (NZ, 3)
    assert grid.zf.shape == (NZ + 1, 3)
    assert grid.dz.shape == (3,)
    for j, d in enumerate(DEPTHS):
        dz = d / NZ
        np.testing.assert_allclose(grid.dz[j], dz, rtol=1e-14)
        np.testing.assert_allclose(grid.zf[0, j], -d, rtol=1e-14)
        np.testing.assert_allclose(grid.zf[NZ, j], 0.0, atol=1e-14)
        np.testing.assert_allclose(
            grid.zc[:, j], -d + dz * (np.arange(NZ) + 0.5), rtol=1e-13, atol=1e-15
        )


def test_rejects_inverted_columns():
    with pytest.raises(ValueError):
        VariableDepthColumn(
            z_bottom=jnp.asarray([-1.0, 0.5]), nelements=NZ, batch_shape=(2,)
        )


def test_equal_depths_match_uniform_column_exactly():
    """All-equal per-column depths must reproduce the scalar-dz Column path
    bitwise (same elementwise program, broadcast differently)."""
    uniform = _run(_richards_model(Column(zlim=(-1.5, 0.0), nelements=NZ)))
    vd = _run(
        _richards_model(
            VariableDepthColumn(
                z_bottom=jnp.full((4,), -1.5), nelements=NZ, batch_shape=(4,)
            )
        )
    )
    assert vd.shape == (NZ, 4)
    for j in range(4):
        np.testing.assert_array_equal(vd[:, j], uniform)


def test_mixed_depths_match_per_depth_single_runs():
    """A mixed-depth batch == each depth run separately (column
    independence), exercising Dirichlet (half-cell per-column dz) and
    free-drainage BCs."""
    singles = [
        _run(_richards_model(Column(zlim=(-d, 0.0), nelements=NZ))) for d in DEPTHS
    ]
    batched = _run(
        _richards_model(
            VariableDepthColumn(
                z_bottom=jnp.asarray([-d for d in DEPTHS]),
                nelements=NZ,
                batch_shape=(3,),
            )
        )
    )
    for j in range(3):
        np.testing.assert_allclose(
            batched[:, j], singles[j], rtol=1e-12, atol=1e-15
        )


def test_mass_conservation_per_column_depth():
    """Zero-flux BCs: per-column water content integral (with its own dz)
    is conserved even though dz differs across the batch."""
    dom = VariableDepthColumn(
        z_bottom=jnp.asarray([-d for d in DEPTHS]), nelements=NZ, batch_shape=(3,)
    )
    model = _richards_model(
        dom, bc_bottom=VerticalFlux(0.0)
    )
    model = dataclasses.replace(
        model,
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
    )
    grid = make_function_space(dom, jnp.float64)

    def ic(z, m):
        # nonuniform profile so there is internal redistribution to conserve
        return {
            "vartheta_l": 0.12 + 0.08 * jnp.exp(-((z + 0.3) ** 2) / 0.05),
            "theta_i": jnp.zeros_like(z),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    mass0 = np.asarray(jnp.sum(Y["soil"]["vartheta_l"], axis=0) * grid.dz)
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.5, tspan=(0.0, 120.0))
    sim.run()
    v = sim.Y["soil"]["vartheta_l"]
    mass1 = np.asarray(jnp.sum(v, axis=0) * grid.dz)
    np.testing.assert_allclose(mass1, mass0, rtol=1e-12)
    # and something actually moved
    assert np.max(np.abs(np.asarray(v) - np.asarray(Y["soil"]["vartheta_l"]))) > 1e-4


def test_coupled_energy_runs_on_variable_depth():
    """Fully coupled water+energy on a mixed-depth batch stays finite and
    matches per-depth single runs."""
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    def coupled(domain):
        return SoilModel(
            domain=domain,
            energy_model=SoilEnergyModel(),
            hydrology_model=SoilHydrologyModel(hydraulic_model=_hm()),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=Dirichlet(lambda t: 290.0)
                ),
                bottom=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
            ),
            soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
        )

    def ic(z, m):
        theta = jnp.full_like(z, 0.15)
        theta_i = jnp.zeros_like(z)
        T = jnp.full_like(z, 283.0)
        rho_c_s = volumetric_heat_capacity(
            theta, theta_i, m.soil_param_set.rho_c_ds, ps
        )
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
        }

    def run(model, tf=60.0, dt=0.5):
        Y, Ya = initialize_states(model, ic, 0.0)
        sim = Simulation(
            model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, tf)
        )
        sim.run()
        return sim.Y["soil"]

    singles = [run(coupled(Column(zlim=(-d, 0.0), nelements=NZ))) for d in DEPTHS]
    batched = run(
        coupled(
            VariableDepthColumn(
                z_bottom=jnp.asarray([-d for d in DEPTHS]),
                nelements=NZ,
                batch_shape=(3,),
            )
        )
    )
    for j in range(3):
        for k in ("vartheta_l", "rho_e_int"):
            np.testing.assert_allclose(
                np.asarray(batched[k])[:, j],
                np.asarray(singles[j][k]),
                rtol=1e-10,
                atol=1e-12,
            )


def test_segment_variable_dz_matches_xla():
    """The segment runner must match the step-by-step XLA path on a
    variable-depth batch."""
    from landhydrology.segment import make_segment_run

    ncol = 8
    rng = np.random.default_rng(1)
    depths = jnp.asarray(rng.uniform(0.8, 3.0, ncol))
    dom = VariableDepthColumn(z_bottom=-depths, nelements=NZ, batch_shape=(ncol,))
    model = _richards_model(dom)
    Y, Ya = initialize_states(model, _ic, 0.0)

    steps, dt = 6, 0.25
    segment = make_segment_run(
        model, SSPRK33(), dt=dt, steps_per_call=steps,
    )
    Y_segment = segment(Y, 0.0)

    from landhydrology.models.soil.rhs import make_rhs

    rhs = make_rhs(model)
    stepper = SSPRK33()
    Y_xla = Y
    t = jnp.asarray(0.0)
    for i in range(steps):
        Y_xla = stepper.step(rhs, Y_xla, Ya, t, jnp.asarray(dt))
        t = t + dt
    np.testing.assert_allclose(
        np.asarray(Y_segment["soil"]["vartheta_l"]),
        np.asarray(Y_xla["soil"]["vartheta_l"]),
        rtol=1e-12,
        atol=1e-15,
    )


def test_implicit_stepper_on_variable_depth():
    """BackwardEulerRichards (batched Thomas solve) handles per-column dz:
    a 60x-CFL dt run stays finite and matches the mixed-depth explicit
    solution to discretization accuracy."""
    from landhydrology.imex import BackwardEulerRichards

    dom = VariableDepthColumn(
        z_bottom=jnp.asarray([-d for d in DEPTHS]), nelements=NZ, batch_shape=(3,)
    )
    model = _richards_model(dom)
    grid = make_function_space(dom, jnp.float64)
    Y, Ya = initialize_states(model, _ic, 0.0)
    stepper = BackwardEulerRichards(model=model, grid=grid, iters=3)
    sim = Simulation(
        model, stepper, Y_init=Y, Ya_init=Ya, dt=15.0, tspan=(0.0, 600.0)
    )
    sim.run()
    implicit = np.asarray(sim.Y["soil"]["vartheta_l"])
    explicit = _run(model, tf=600.0, dt=0.25)
    assert np.all(np.isfinite(implicit))
    np.testing.assert_allclose(implicit, explicit, atol=5e-3)


def test_config_roundtrip_variable_depth():
    from landhydrology.config import from_config, to_config

    dom = VariableDepthColumn(
        z_bottom=jnp.asarray([-d for d in DEPTHS]), nelements=NZ, batch_shape=(3,)
    )
    # fully dynamic components + constant BC values (callables — prescribed
    # profiles, time-dependent BCs — are deliberately not serializable)
    model = SoilModel(
        domain=dom,
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=_hm()),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(0.24), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
    )
    cfg = to_config(model)
    model2 = from_config(cfg)
    g1 = make_function_space(model.domain, jnp.float64)
    g2 = make_function_space(model2.domain, jnp.float64)
    np.testing.assert_array_equal(np.asarray(g1.zc), np.asarray(g2.zc))
    np.testing.assert_array_equal(np.asarray(g1.dz), np.asarray(g2.dz))
