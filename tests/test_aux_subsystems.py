"""Checkpoint/resume and diagnostics tests (SURVEY.md §5 subsystems)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from landhydrology import (
    Column,
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
from landhydrology.checkpoint import CheckpointManager
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.diagnostics import energy_total, nan_guard, water_mass
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33


def _sim(Y=None, Ya=None, tf=100.0):
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=10),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(-1e-6)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    if Y is None:
        Y, Ya = initialize_states(
            model,
            lambda z, m: {
                "vartheta_l": jnp.full_like(z, 0.2),
                "theta_i": jnp.zeros_like(z),
            },
            0.0,
        )
    return model, Y, Ya, Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, tf)
    )


@pytest.mark.parametrize("use_orbax", [False, True])
def test_checkpoint_roundtrip_and_resume(tmp_path, use_orbax):
    """Run 100 steps straight == run 50, checkpoint, restore, run 50."""
    if use_orbax:
        pytest.importorskip("orbax.checkpoint")
    model, Y, Ya, sim_full = _sim(tf=100.0)
    sim_full.run()
    v_straight = np.asarray(sim_full.Y["soil"]["vartheta_l"])

    _, _, _, sim_a = _sim(Y, Ya, tf=50.0)
    sim_a.run()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), use_orbax=use_orbax)
    p = mgr.save(step=50, Y=sim_a.Y, t=sim_a.t)
    assert mgr.latest() == 50
    assert p.endswith(".orbax" if use_orbax else ".npz")

    Y_restored, t_restored, step = mgr.restore(Y)
    assert step == 50 and t_restored == 50.0
    _, _, _, sim_b = _sim(Y_restored, Ya, tf=100.0)
    sim_b.t = t_restored
    sim_b.run()
    np.testing.assert_allclose(
        np.asarray(sim_b.Y["soil"]["vartheta_l"]), v_straight, rtol=1e-15
    )


def test_checkpoint_default_is_npz(tmp_path):
    """Without use_orbax the manager writes the numpy format, which needs
    no package beyond numpy."""
    _, Y, _, _ = _sim()
    path = CheckpointManager(str(tmp_path / "ckpt")).save(step=1, Y=Y, t=1.0)
    assert path.endswith(".npz")


def test_water_mass_tracks_boundary_flux():
    """With a constant downward top influx, d(mass)/dt == -flux exactly."""
    model, Y, Ya, sim = _sim(tf=100.0)
    dz = 0.1
    m0 = float(water_mass(Y, dz, param_set=ps))
    sim.run()
    mf = float(water_mass(sim.Y, dz, param_set=ps))
    # flux = -1e-6 m/s at top for 100 s -> +1e-4 m of water gained
    np.testing.assert_allclose(mf - m0, 1e-4, rtol=1e-10)


def test_nan_guard_raises():
    Y_bad = {"soil": {"vartheta_l": jnp.asarray([0.1, jnp.nan])}}
    with pytest.raises(FloatingPointError):
        nan_guard(Y_bad)
        jax.effects_barrier()
    Y_ok = {"soil": {"vartheta_l": jnp.asarray([0.1, 0.2])}}
    nan_guard(Y_ok)
    jax.effects_barrier()


def test_simulation_removed_engine_and_sink(tmp_path):
    """The removed engine option raises, and run(sink=...) streams the
    trajectory to the native writer."""
    from landhydrology.runtime import TrajectorySink, read_trajectory
    from landhydrology import SoilEnergyModel
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    import dataclasses

    from landhydrology import SoilColumnBC as _BC

    model, Y0, Ya0, _ = _sim()
    model = dataclasses.replace(
        model,
        domain=dataclasses.replace(model.domain, batch_shape=(8,)),
        energy_model=SoilEnergyModel(),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(-1e-6), energy=VerticalFlux(0.0)
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
    )
    theta = jnp.broadcast_to(jnp.linspace(0.15, 0.25, 8)[None, :], (10, 8))
    ti = jnp.zeros((10, 8))
    rcs = volumetric_heat_capacity(theta, ti, 2700.0, ps)
    Y = {
        "soil": {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full((10, 8), 288.0), ps
            ),
        }
    }
    from landhydrology.domains import make_function_space

    Ya = {"zc": make_function_space(model.domain, jnp.float64).zc, "soil": {}}

    kw = dict(Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, 24.0), saveat=8.0)
    with pytest.raises(TypeError, match="removed"):
        Simulation(model, SSPRK33(), engine="pallas", tile_cols=8, **kw)
    sim = Simulation(model, SSPRK33(), **kw)
    sink = TrajectorySink(str(tmp_path / "traj.bin"))
    sol = sim.run(sink=sink)
    sink.close()

    assert np.all(np.isfinite(np.asarray(sim.Y["soil"]["vartheta_l"])))
    back = read_trajectory(str(tmp_path / "traj.bin"))
    assert len(back) == len(sol)
    np.testing.assert_allclose(
        back[-1][2]["soil/vartheta_l"],
        np.asarray(sol.state(-1)["soil"]["vartheta_l"]),
    )


def test_simulation_callbacks():
    """Host callbacks fire at save points (reference DiscreteCallback
    parity, simulation.jl:16-21): observers see every save, and a
    state-replacing callback (discrete precipitation pulse) takes effect."""
    model, Y, Ya, _ = _sim(tf=40.0)
    seen = []

    def observer(Yc, t):
        seen.append((t, float(jnp.sum(Yc["soil"]["vartheta_l"]))))

    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, 40.0),
        saveat=10.0, callbacks=[observer],
    )
    sol = sim.run()
    assert [t for t, _ in seen] == [10.0, 20.0, 30.0, 40.0]
    assert len(sol) == 5  # t0 + 4 saves

    # state-replacing callback: add surface water at t=20
    def pulse(Yc, t):
        if t == 20.0:
            top = Yc["soil"]["vartheta_l"].shape[0] - 1
            v = Yc["soil"]["vartheta_l"].at[top].add(0.05)
            return {"soil": dict(Yc["soil"], vartheta_l=v)}
        return None

    sim2 = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, 40.0),
        saveat=10.0, callbacks=[pulse],
    )
    sim2.run()
    m_no_pulse = float(jnp.sum(sim.Y["soil"]["vartheta_l"]))
    m_pulse = float(jnp.sum(sim2.Y["soil"]["vartheta_l"]))
    np.testing.assert_allclose(m_pulse - m_no_pulse, 0.05, rtol=1e-10)


def test_simulation_derives_ya_when_omitted():
    """Y_init without Ya_init: the auxiliary state is derived from the
    model instead of crashing mid-trace."""
    model, Y, _, _ = _sim()
    sim = Simulation(model, SSPRK33(), Y_init=Y, dt=1.0, tspan=(0.0, 5.0))
    sim.run()
    assert np.all(np.isfinite(np.asarray(sim.Y["soil"]["vartheta_l"])))


def test_explicit_dt_limit_flags_saturated_stiffness():
    """The CFL estimator must flag the saturated-compressibility regime
    (D = K/S_s) that silently destabilizes explicit runs."""
    from landhydrology.diagnostics import explicit_dt_limit
    from landhydrology.models.soil.water import hydrostatic_profile
    from landhydrology.models.soil import vanGenuchten as vG

    hm = vG(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=40),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.45, S_s=1e-3),
    )
    z = jnp.linspace(-1.975, -0.025, 40)
    # unsaturated state: permissive limit
    Y_unsat = {"soil": {"vartheta_l": jnp.full((40,), 0.2),
                        "theta_i": jnp.zeros((40,))}}
    dt_unsat = float(explicit_dt_limit(model, Y_unsat))
    # hydrostatic state with a saturated zone: ~1000x stiffer
    Y_sat = {"soil": {"vartheta_l": hydrostatic_profile(hm, z, -0.5, 0.45, 1e-3),
                      "theta_i": jnp.zeros((40,))}}
    dt_sat = float(explicit_dt_limit(model, Y_sat))
    assert dt_sat < dt_unsat / 20
    assert dt_sat < 2.0  # the regime where dt=2 blew up in verification


def test_checkpoint_corruption_surfaces_not_masked(tmp_path):
    """A restore failure that is NOT a dtype mismatch must raise (with the
    original error chained), never silently retry the host-replicated
    fallback (ADVICE r2)."""
    import os
    import shutil

    mgr = CheckpointManager(str(tmp_path / "ckpt"), use_orbax=True)
    Y = {"soil": {"vartheta_l": jnp.ones((4, 8))}}
    path = mgr.save(3, Y, 1.5)
    if not path.endswith(".orbax"):
        pytest.skip("orbax unavailable")
    # corrupt: remove the array data payload but keep the metadata
    removed = False
    for root, dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            if os.path.getsize(p) > 0 and "zarr" not in f and f != "_METADATA":
                os.remove(p)
                removed = True
    if not removed:
        shutil.rmtree(os.path.join(path, "Y"), ignore_errors=True)
    with pytest.raises(Exception) as ei:
        mgr.restore(Y, 3)
    # must not be a silent success; and the dtype-fallback path must not
    # have swallowed the real cause
    assert not isinstance(ei.value, KeyboardInterrupt)
