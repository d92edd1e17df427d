"""Multi-device tests on the virtual 8-CPU mesh: sharded steps must be
numerically identical to single-device execution, and the explicit
shard_map halo exchange must match the roll-based lateral coupling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    PrescribedTemperatureModel,
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
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.models.soil.model import LateralSurfaceCoupling
from landhydrology.parallel import (
    halo_exchanged_laplacian,
    make_column_mesh,
    make_sharded_step,
    shard_state,
)
from landhydrology.parallel.stepping import make_sharded_run
from landhydrology.timestepping import SSPRK33

pytestmark = pytest.mark.multihost

NZ, NX, NY = 12, 8, 8


def _model(lateral=None, batch=(NX, NY)):
    return SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=batch),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        lateral_coupling=lateral,
    )


def _ic(z, m):
    # laterally varying moisture bump + linear T profile
    nx = np.arange(NX)[None, :, None]
    ny = np.arange(NY)[None, None, :]
    bump = 0.05 * np.sin(2 * np.pi * nx / NX) * np.cos(2 * np.pi * ny / NY)
    theta = jnp.asarray(0.2 + bump + 0.0 * z)
    theta_i = jnp.zeros_like(theta)
    T = 288.0 + 5.0 * z + 0.0 * theta
    rho_c_s = volumetric_heat_capacity(theta, theta_i, 1.3e6, param_set)
    return {
        "vartheta_l": theta,
        "theta_i": theta_i,
        "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, param_set),
    }


def test_devices_available():
    assert len(jax.devices()) == 8


def test_halo_laplacian_matches_roll():
    mesh = make_column_mesh(shape=(4, 2))
    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.normal(size=(NX, NY)))
    lap_halo = halo_exchanged_laplacian(f, 0.5, mesh)
    lap_roll = (
        jnp.roll(f, 1, 0) + jnp.roll(f, -1, 0) + jnp.roll(f, 1, 1)
        + jnp.roll(f, -1, 1) - 4.0 * f
    ) / 0.25
    np.testing.assert_allclose(np.asarray(lap_halo), np.asarray(lap_roll), rtol=1e-13)


@pytest.mark.parametrize("mode", ["pjit", "shard_map"])
def test_sharded_step_matches_single_device(mode):
    lateral = LateralSurfaceCoupling(conductance=1e-4, dx=1.0)
    model = _model(lateral)
    Y, Ya = initialize_states(model, _ic, 0.0)

    # single-device run
    step1 = make_sharded_step(
        model, make_column_mesh(shape=(1, 1), devices=jax.devices()[:1]),
        SSPRK33(), dt=10.0, mode="pjit",
    )
    Y1, _ = step1(Y, Ya, jnp.asarray(0.0))

    # 8-device mesh
    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    stepN = make_sharded_step(model, mesh, SSPRK33(), dt=10.0, mode=mode)
    YN, _ = stepN(Ys, Yas, jnp.asarray(0.0))

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=f"{mode}:{k}",
        )


def test_lateral_coupling_conserves_and_spreads():
    """Periodic lateral diffusion conserves total water and flattens the
    lateral moisture bump."""
    lateral = LateralSurfaceCoupling(conductance=5e-4, dx=1.0)
    model = _model(lateral)
    Y, Ya = initialize_states(model, _ic, 0.0)
    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    run = make_sharded_run(model, mesh, SSPRK33(), dt=10.0, n_steps=200, mode="shard_map")
    Yf, _ = run(Ys, Yas, jnp.asarray(0.0))

    v0 = np.asarray(Y["soil"]["vartheta_l"])
    vf = np.asarray(Yf["soil"]["vartheta_l"])
    assert abs(vf.sum() - v0.sum()) / v0.sum() < 1e-12  # conservation
    # lateral variance of the surface layer decreases (diffusive smoothing)
    assert vf[-1].std() < v0[-1].std()
    assert np.all(np.isfinite(vf))


def test_weak_scaling_shapes():
    """The pjit path accepts a 1-D column mesh for pure data parallelism."""
    model = _model(None, batch=(64,))

    def ic(z, m):
        return {
            "vartheta_l": jnp.full((NZ, 64), 0.2),
            "theta_i": jnp.zeros((NZ, 64)),
            "rho_e_int": jnp.full((NZ, 64), -1e6),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    mesh = make_column_mesh(axis_names=("columns",))
    Ys = shard_state(Y, mesh)
    step = make_sharded_step(model, mesh, SSPRK33(), dt=1.0)
    Yf, _ = step(Ys, shard_state(Ya, mesh), jnp.asarray(0.0))
    assert Yf["soil"]["vartheta_l"].shape == (NZ, 64)
    assert len(Yf["soil"]["vartheta_l"].sharding.device_set) == 8


def test_simulation_with_sharded_state():
    """Simulation.run works transparently on mesh-sharded state (jit
    propagates shardings through the scan) and matches the unsharded run."""
    model = _model(None, batch=(64,))

    def ic(z, m):
        return {
            "vartheta_l": jnp.broadcast_to(
                jnp.linspace(0.15, 0.25, 64)[None, :], (NZ, 64)
            ),
            "theta_i": jnp.zeros((NZ, 64)),
            "rho_e_int": jnp.full((NZ, 64), -1e6),
        }

    from landhydrology import Simulation, initialize_states
    from landhydrology.timestepping import SSPRK33

    Y, Ya = initialize_states(model, ic, 0.0)
    sim_ref = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=5.0, tspan=(0.0, 100.0)
    )
    sim_ref.run()

    mesh = make_column_mesh(axis_names=("columns",))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    sim_sh = Simulation(
        model, SSPRK33(), Y_init=Ys, Ya_init=Yas, dt=5.0, tspan=(0.0, 100.0)
    )
    sim_sh.run()

    out = sim_sh.Y["soil"]["vartheta_l"]
    assert len(out.sharding.device_set) == 8  # stayed sharded through the scan
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(sim_ref.Y["soil"]["vartheta_l"]), rtol=1e-13
    )


def test_shard_map_streams_per_column_arrays():
    """Heterogeneous per-column parameters run through the shard_map path
    (streamed as sharded args) and match the general pjit path."""
    import dataclasses

    rng = np.random.default_rng(5)
    model = _model(LateralSurfaceCoupling(conductance=1e-4, dx=1.0))
    model = dataclasses.replace(
        model,
        hydrology_model=dataclasses.replace(
            model.hydrology_model,
            hydraulic_model=vanGenuchten(
                n=jnp.asarray(rng.uniform(1.5, 3.0, (NX, NY))),
                alpha=2.6,
                Ksat=jnp.asarray(rng.uniform(1e-6, 1e-5, (NX, NY))),
                theta_r=0.0,
            ),
        ),
        soil_param_set=dataclasses.replace(
            model.soil_param_set, nu=jnp.asarray(rng.uniform(0.35, 0.45, (NX, NY)))
        ),
    )
    Y, Ya = initialize_states(model, _ic, 0.0)
    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)

    step_p = make_sharded_step(model, mesh, SSPRK33(), dt=10.0, mode="pjit")
    step_s = make_sharded_step(model, mesh, SSPRK33(), dt=10.0, mode="shard_map")
    Yp, _ = step_p(Ys, Yas, jnp.asarray(0.0))
    Ysm, _ = step_s(Ys, Yas, jnp.asarray(0.0))
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Ysm["soil"][k]), np.asarray(Yp["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


def test_column_sharding_helper():
    """column_sharding builds the canonical (replicated-vertical, sharded-
    batch) NamedSharding used for explicit device_put placement."""
    from landhydrology.parallel import column_sharding

    mesh = make_column_mesh(shape=(4, 2))
    sh = column_sharding(mesh)
    x = jax.device_put(jnp.zeros((NZ, NX, NY)), sh)
    assert len(x.sharding.device_set) == 8
    # vertical axis replicated: each shard holds all nz levels
    shard_shape = x.sharding.shard_shape(x.shape)
    assert shard_shape == (NZ, NX // 4, NY // 2)


@pytest.mark.parametrize("mode", ["pjit", "shard_map"])
def test_variable_depth_sharded_matches_single_device(mode):
    """Variable-depth batches shard like any other heterogeneous data:
    per-column dz streams into the per-shard program (shard_map) or rides
    the closed-over constants (pjit); both match single-device exactly."""
    from landhydrology import VariableDepthColumn

    rng = np.random.default_rng(7)
    depths = rng.uniform(0.6, 2.5, (NX, NY))
    model = _model(None)
    model = dataclasses.replace(
        model,
        domain=VariableDepthColumn(
            z_bottom=jnp.asarray(-depths), nelements=NZ, batch_shape=(NX, NY)
        ),
    )
    Y, Ya = initialize_states(model, _ic, 0.0)

    step1 = make_sharded_step(
        model, make_column_mesh(shape=(1, 1), devices=jax.devices()[:1]),
        SSPRK33(), dt=5.0, mode="pjit",
    )
    Y1, _ = step1(Y, Ya, jnp.asarray(0.0))

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    stepN = make_sharded_step(model, mesh, SSPRK33(), dt=5.0, mode=mode)
    YN, _ = stepN(Ys, Yas, jnp.asarray(0.0))

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=f"{mode}:{k}",
        )


# ---- the segment runner inside shard_map ----


def _fused_plain_reference(model, Y, dt, steps_per_call, n_calls):
    """Single-device segment run on the flattened column batch — the
    numerics the sharded segment path must reproduce exactly."""
    from landhydrology.segment import make_segment_run

    batch = model.domain.batch_shape
    ncol = int(np.prod(batch))
    flat_model = dataclasses.replace(
        model,
        domain=dataclasses.replace(model.domain, batch_shape=(ncol,)),
        lateral_coupling=None,
    )
    run = make_segment_run(
        flat_model, SSPRK33(), dt=dt, steps_per_call=steps_per_call,
    )
    Yf = {"soil": {k: v.reshape(NZ, ncol) for k, v in Y["soil"].items()}}
    t = jnp.asarray(0.0, dtype=jnp.float64)
    for _ in range(n_calls):
        Yf = run(Yf, t)
        t = t + steps_per_call * dt
    return {"soil": {k: v.reshape(NZ, *batch) for k, v in Yf["soil"].items()}}


def test_fused_sharded_matches_plain_fused():
    """Lateral-free: the segment runner inside shard_map on 8 devices is
    numerically identical to the single-device segment on the flattened
    batch."""
    from landhydrology.parallel import make_fused_sharded_run

    model = _model(None)
    Y, Ya = initialize_states(model, _ic, 0.0)
    Yref = _fused_plain_reference(model, Y, dt=10.0, steps_per_call=4, n_calls=2)

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    run = make_fused_sharded_run(
        model, mesh, SSPRK33(), dt=10.0, steps_per_call=4, n_calls=2,
    )
    YN, tf = run(Ys, Yas, jnp.asarray(0.0))
    assert float(tf) == pytest.approx(80.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )


def test_fused_sharded_heterogeneous_params():
    """Per-column vanGenuchten/porosity arrays stream into the per-shard
    segment and match the single-device segment on flattened params."""
    from landhydrology.parallel import make_fused_sharded_run

    rng = np.random.default_rng(11)
    model = _model(None)
    model = dataclasses.replace(
        model,
        hydrology_model=dataclasses.replace(
            model.hydrology_model,
            hydraulic_model=vanGenuchten(
                n=jnp.asarray(rng.uniform(1.5, 3.0, (NX, NY))),
                alpha=2.6,
                Ksat=jnp.asarray(rng.uniform(1e-6, 1e-5, (NX, NY))),
                theta_r=0.0,
            ),
        ),
        soil_param_set=dataclasses.replace(
            model.soil_param_set, nu=jnp.asarray(rng.uniform(0.35, 0.45, (NX, NY)))
        ),
    )
    Y, Ya = initialize_states(model, _ic, 0.0)

    # flatten params for the plain single-device reference
    flat_hm = vanGenuchten(
        n=model.hydrology_model.hydraulic_model.n.reshape(-1),
        alpha=2.6,
        Ksat=model.hydrology_model.hydraulic_model.Ksat.reshape(-1),
        theta_r=0.0,
    )
    flat_model = dataclasses.replace(
        model,
        hydrology_model=dataclasses.replace(
            model.hydrology_model, hydraulic_model=flat_hm
        ),
        soil_param_set=dataclasses.replace(
            model.soil_param_set, nu=model.soil_param_set.nu.reshape(-1)
        ),
    )
    Yref = _fused_plain_reference(
        flat_model, Y, dt=10.0, steps_per_call=4, n_calls=2
    )

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    run = make_fused_sharded_run(
        model, mesh, SSPRK33(), dt=10.0, steps_per_call=4, n_calls=2,
    )
    YN, _ = run(Ys, Yas, jnp.asarray(0.0))
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )


def test_fused_sharded_lateral_split_device_invariant():
    """With lateral coupling the segment path runs a Lie split (vertical
    segment + halo-exchanged lateral update): 8-device result == 1-device
    result of the same scheme, water is conserved, and the lateral bump
    smooths."""
    from landhydrology.parallel import make_fused_sharded_run

    lateral = LateralSurfaceCoupling(conductance=1e-4, dx=1.0)
    model = _model(lateral)
    Y, Ya = initialize_states(model, _ic, 0.0)

    kw = dict(stepper=SSPRK33(), dt=10.0, steps_per_call=4, n_calls=5)
    run1 = make_fused_sharded_run(
        model, make_column_mesh(shape=(1, 1), devices=jax.devices()[:1]), **kw
    )
    Y1, _ = run1(Y, Ya, jnp.asarray(0.0))

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    runN = make_fused_sharded_run(model, mesh, **kw)
    YN, _ = runN(Ys, Yas, jnp.asarray(0.0))

    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    v0 = np.asarray(Y["soil"]["vartheta_l"])
    vf = np.asarray(YN["soil"]["vartheta_l"])
    assert abs(vf.sum() - v0.sum()) / v0.sum() < 1e-12
    assert vf[-1].std() < v0[-1].std()


def test_fused_sharded_lateral_cfl_guard():
    """Construction rejects a split window beyond the lateral CFL."""
    from landhydrology.parallel import make_fused_sharded_run

    lateral = LateralSurfaceCoupling(conductance=1.0, dx=0.1)
    model = _model(lateral)
    mesh = make_column_mesh(shape=(4, 2))
    with pytest.raises(ValueError, match="lateral"):
        make_fused_sharded_run(
            model, mesh, SSPRK33(), dt=10.0, steps_per_call=48,
        )


def test_sharded_freeze_thaw_projection_applies():
    """The sharded factories must apply the EquilibriumFreezeThaw
    projection (ADVICE r2 medium): an 8-device sharded step of a
    supercooled batch matches the explicitly wrapped single-device step and
    actually freezes ice (the unwrapped step would leave theta_i == 0)."""
    from landhydrology.models.soil.freeze_thaw import (
        EquilibriumFreezeThaw,
        wrap_stepper_with_projection,
    )

    model = dataclasses.replace(_model(None), freeze_thaw=EquilibriumFreezeThaw())

    def ic(z, m):
        shape = (NZ, NX, NY)
        theta = jnp.full(shape, 0.3)
        theta_i = jnp.zeros(shape)
        T = jnp.full(shape, 270.0)  # supercooled: projection must freeze
        rho_c_s = volumetric_heat_capacity(theta, theta_i, 1.3e6, param_set)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(
                theta_i, rho_c_s, T, param_set
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)

    # explicit single-device reference with the projection wrap
    from landhydrology.domains import make_function_space
    from landhydrology.models.soil.rhs import make_rhs

    grid = make_function_space(model.domain, model.float_dtype)
    rhs = make_rhs(model, grid)
    wrapped = wrap_stepper_with_projection(SSPRK33(), model)
    Yref = wrapped.step(rhs, Y, Ya, jnp.asarray(0.0), jnp.asarray(10.0))
    assert float(jnp.max(Yref["soil"]["theta_i"])) > 1e-4  # projection fires

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    for mode in ("pjit", "shard_map"):
        stepN = make_sharded_step(model, mesh, SSPRK33(), dt=10.0, mode=mode)
        YN, _ = stepN(Ys, Yas, jnp.asarray(0.0))
        for k in Y["soil"]:
            np.testing.assert_allclose(
                np.asarray(YN["soil"][k]), np.asarray(Yref["soil"][k]),
                rtol=1e-12, atol=1e-18, err_msg=f"{mode}:{k}",
            )


# ---------------------------------------------------------------------------
# LandModel through the sharded segment path
# ---------------------------------------------------------------------------


def _land_model(runoff=None):
    from landhydrology import PrescribedAtmosForcing
    from landhydrology.models.land import LandModel, SurfaceWaterModel

    soil = dataclasses.replace(
        _model(None),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
    )
    return LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=lambda t: jnp.where(t < 60.0, 6e-6, 0.0),
            tau_pond=120.0,
            h_evap_smoothing=1e-4,
            runoff=runoff,
        ),
    )


def _land_states(land, h_s0=0.0):
    from landhydrology.models.land import initialize_states as land_init

    return land_init(land, _ic, 0.0, h_s0=h_s0)


def test_fused_sharded_land_matches_plain_fused():
    """Rain + pond + MOST + coupled energy through the segment runner
    inside shard_map on 8 devices == the single-device segment."""
    from landhydrology.segment import make_segment_run
    from landhydrology.parallel import make_fused_sharded_run

    land = _land_model()
    Y, Ya = _land_states(land, h_s0=5e-4)  # standing pond: exchange active

    # single-device segment reference on the flattened batch
    ncol = NX * NY
    flat_land = dataclasses.replace(
        land,
        soil=dataclasses.replace(
            land.soil,
            domain=dataclasses.replace(land.soil.domain, batch_shape=(ncol,)),
        ),
    )
    run_p = make_segment_run(
        flat_land, SSPRK33(), dt=10.0, steps_per_call=4,
    )
    Yf = {
        "soil": {k: v.reshape(NZ, ncol) for k, v in Y["soil"].items()},
        "surface": {"h_s": Y["surface"]["h_s"].reshape(ncol)},
    }
    t = jnp.asarray(0.0, dtype=jnp.float64)
    for _ in range(2):
        Yf = run_p(Yf, t)
        t = t + 40.0
    Yref = {
        "soil": {k: v.reshape(NZ, NX, NY) for k, v in Yf["soil"].items()},
        "surface": {"h_s": Yf["surface"]["h_s"].reshape(NX, NY)},
    }

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    run = make_fused_sharded_run(
        land, mesh, SSPRK33(), dt=10.0, steps_per_call=4, n_calls=2,
    )
    YN, tf = run(Ys, Yas, jnp.asarray(0.0))
    assert float(tf) == pytest.approx(80.0)
    h = np.asarray(YN["surface"]["h_s"])
    assert np.all(h > 0) and np.all(h != 5e-4)  # pond drained/evaporated some
    np.testing.assert_allclose(
        np.asarray(YN["surface"]["h_s"]), np.asarray(Yref["surface"]["h_s"]),
        rtol=1e-13, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )


def test_fused_sharded_land_routing_device_invariant():
    """Diffusive pond routing joins the Lie split: 8-device == 1-device of
    the same scheme, and the pond bump spreads."""
    from landhydrology.models.land import RunoffRouting
    from landhydrology.parallel import make_fused_sharded_run

    land = _land_model(runoff=RunoffRouting(conductance=5e-3, dx=1.0))
    # laterally varying initial pond so routing has something to move
    bump = 1e-3 * (1.0 + np.sin(2 * np.pi * np.arange(NX) / NX))[:, None]
    h_s0 = jnp.asarray(np.broadcast_to(bump, (NX, NY)))
    Y, Ya = _land_states(land, h_s0=h_s0)

    kw = dict(stepper=SSPRK33(), dt=10.0, steps_per_call=4, n_calls=5)
    run1 = make_fused_sharded_run(
        land, make_column_mesh(shape=(1, 1), devices=jax.devices()[:1]), **kw
    )
    Y1, _ = run1(Y, Ya, jnp.asarray(0.0))

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    runN = make_fused_sharded_run(land, mesh, **kw)
    YN, _ = runN(Ys, Yas, jnp.asarray(0.0))

    np.testing.assert_allclose(
        np.asarray(YN["surface"]["h_s"]), np.asarray(Y1["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    h0 = np.asarray(h_s0)
    hf = np.asarray(YN["surface"]["h_s"])
    assert hf.std() < h0.std()  # routing spread the bump


def test_fused_sharded_land_kinematic_device_invariant_and_conserves():
    """Manning kinematic-wave routing joins the sharded segment Lie split
    (upwinded face fluxes with one-cell halo exchange, elevation streamed
    as a sharded argument): 8-device == 1-device of the same scheme, face
    fluxes telescope so pond + soil water closes exactly, and water flows
    off the terrain hill."""
    from landhydrology.models.land import KinematicWaveRouting
    from landhydrology.parallel import make_fused_sharded_run

    x = np.arange(NX)[:, None] - (NX - 1) / 2.0
    y = np.arange(NY)[None, :] - (NY - 1) / 2.0
    z_terrain = 0.3 * np.exp(-(x**2 + y**2) / 6.0)
    land = _land_model(
        runoff=KinematicWaveRouting(
            elevation=jnp.asarray(z_terrain), manning_n=0.05, dx=1.0
        )
    )
    # MOST-free top face: the budget below closes against rain alone
    land = dataclasses.replace(
        land,
        soil=dataclasses.replace(
            land.soil,
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
                bottom=land.soil.boundary_conditions.bottom,
            ),
        ),
    )
    h_s0 = jnp.full((NX, NY), 5e-3)
    Y, Ya = _land_states(land, h_s0=h_s0)

    # kinematic CFL at h~5e-3, |s|~0.1: c ~ (5/3) h^(2/3) sqrt(s)/n ~ 0.3
    # m/s -> window steps_per_call*dt = 2 s stays well under dx/c ~ 3 s
    kw = dict(stepper=SSPRK33(), dt=0.5, steps_per_call=4, n_calls=5)
    run1 = make_fused_sharded_run(
        land, make_column_mesh(shape=(1, 1), devices=jax.devices()[:1]), **kw
    )
    Y1, _ = run1(Y, Ya, jnp.asarray(0.0))

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    runN = make_fused_sharded_run(land, mesh, **kw)
    YN, _ = runN(Ys, Yas, jnp.asarray(0.0))

    np.testing.assert_allclose(
        np.asarray(YN["surface"]["h_s"]), np.asarray(Y1["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    hf = np.asarray(YN["surface"]["h_s"])
    assert np.all(np.isfinite(hf)) and np.all(hf >= -1e-15)
    # water left the hilltop for the periodic far field
    assert hf[NX // 2, NY // 2] < 5e-3
    assert hf[0, 0] > 5e-3
    # conservation across routing + infiltration + rain: total water change
    # equals integrated rain minus nothing else (zero-flux bottom, no MOST)
    from landhydrology.domains import make_function_space

    grid = make_function_space(land.soil.domain, land.float_dtype)
    dz = float(grid.dz)
    tot0 = float(jnp.sum(Y["soil"]["vartheta_l"]) * dz + jnp.sum(h_s0))
    totf = float(
        jnp.sum(YN["soil"]["vartheta_l"]) * dz
        + jnp.sum(YN["surface"]["h_s"])
    )
    t_end = 0.5 * 4 * 5
    rain_in = float(land.surface.precipitation(0.0)) * NX * NY * t_end
    np.testing.assert_allclose(totf - tot0, rain_in, rtol=1e-8, atol=1e-12)


def test_fused_sharded_variable_depth_matches_plain_fused():
    """VariableDepthColumn through the sharded segment path: per-column dz
    streams as sharded data into the per-shard segments; 8-device result ==
    the single-device segment on the flattened variable-depth batch."""
    from landhydrology import VariableDepthColumn
    from landhydrology.segment import make_segment_run
    from landhydrology.parallel import make_fused_sharded_run

    rng = np.random.default_rng(7)
    depths = rng.uniform(0.6, 2.5, (NX, NY))
    model = dataclasses.replace(
        _model(None),
        domain=VariableDepthColumn(
            z_bottom=jnp.asarray(-depths), nelements=NZ, batch_shape=(NX, NY)
        ),
    )
    Y, Ya = initialize_states(model, _ic, 0.0)

    # single-device segment reference on the flattened variable-depth batch
    ncol = NX * NY
    flat_model = dataclasses.replace(
        model,
        domain=VariableDepthColumn(
            z_bottom=jnp.asarray(-depths.reshape(-1)),
            nelements=NZ,
            batch_shape=(ncol,),
        ),
    )
    run_p = make_segment_run(
        flat_model, SSPRK33(), dt=5.0, steps_per_call=4,
    )
    Yf = {"soil": {k: v.reshape(NZ, ncol) for k, v in Y["soil"].items()}}
    t = jnp.asarray(0.0, dtype=jnp.float64)
    for _ in range(2):
        Yf = run_p(Yf, t)
        t = t + 20.0
    Yref = {"soil": {k: v.reshape(NZ, NX, NY) for k, v in Yf["soil"].items()}}

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    run = make_fused_sharded_run(
        model, mesh, SSPRK33(), dt=5.0, steps_per_call=4, n_calls=2,
    )
    YN, tf = run(Ys, Yas, jnp.asarray(0.0))
    assert float(tf) == pytest.approx(40.0)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Yref["soil"][k]),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )


def test_fused_sharded_lateral_split_first_order_in_window():
    """Quantified accuracy model for the lateral Lie split (VERDICT r2
    item 5): the sharded segment path freezes the lateral term for a segment
    window ``w = steps_per_call * dt``; its error against the *unsplit* XLA
    trajectory (lateral term in every RK stage) must shrink ~linearly as the
    window shrinks — measured first order, not assumed.  The documented rule
    (stepping.py / docs/performance.md): splitting error ~ O(w), so pick
    ``w`` a factor F below the lateral stability limit ``dx^2 dz / (4c)``
    to get an O(1/F) relative-error reduction."""
    from landhydrology.parallel import make_fused_sharded_run

    # windows well inside the lateral stability limit dx^2 dz /(4c) ~ 417 s
    # (near the limit the split error grows superlinearly; the first-order
    # regime is the operating regime the CFL guard enforces with margin)
    lateral = LateralSurfaceCoupling(conductance=5e-5, dx=1.0)
    model = _model(lateral)
    Y, Ya = initialize_states(model, _ic, 0.0)
    dt = 10.0
    total_steps = 16
    mesh = make_column_mesh(shape=(1, 1), devices=jax.devices()[:1])

    # unsplit reference: lateral coupling evaluated inside every RK stage
    step = make_sharded_step(model, mesh, SSPRK33(), dt=dt, mode="pjit")
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(total_steps):
        Yr, t = step(Yr, Ya, t)
    ref_top = np.asarray(Yr["soil"]["vartheta_l"][-1])

    errs = {}
    for spc in (2, 4, 8):
        run = make_fused_sharded_run(
            model, mesh, SSPRK33(), dt=dt, steps_per_call=spc,
            n_calls=total_steps // spc,
        )
        Yf, _ = run(Y, Ya, jnp.asarray(0.0))
        errs[spc] = float(
            np.max(np.abs(np.asarray(Yf["soil"]["vartheta_l"][-1]) - ref_top))
        )

    # halving the window must roughly halve the error (first order in w);
    # allow [1.5, 2.7] for the nonlinearity of the vertical physics
    r84 = errs[8] / errs[4]
    r42 = errs[4] / errs[2]
    assert 1.5 < r84 < 2.7, (errs, r84)
    assert 1.5 < r42 < 2.7, (errs, r42)
    # absolute scale: at w == 80 s (spc=8, ~1/5 of the stability limit) the
    # error stays below ~10% of the lateral bump amplitude (0.05)
    assert errs[8] < 5e-3, errs


def test_adaptive_trbdf2_sharded_matches_single_device():
    """Adaptive (step-doubling, PI-controlled) integration with the TR-BDF2
    implicit stepper under pjit sharding (VERDICT r2 item 8): the on-device
    while_loop, the tridiagonal Newton solves, and the global error norm
    (an all-reduce under GSPMD) must give the single-device trajectory and
    the same accept/reject history on 8 devices."""
    from landhydrology.adaptive import AdaptiveConfig, run_adaptive
    from landhydrology.domains import make_function_space
    from landhydrology.imex import TRBDF2Soil
    from landhydrology.models.soil.rhs import make_rhs

    model = _model(None)
    Y, Ya = initialize_states(model, _ic, 0.0)
    grid = make_function_space(model.domain, model.float_dtype)
    stepper = TRBDF2Soil(model=model, grid=grid, iters=2)
    rhs = make_rhs(model, grid)
    cfg = AdaptiveConfig(rtol=1e-5, atol=1e-10)

    Y1, s1 = run_adaptive(rhs, Y, Ya, 0.0, 600.0, 60.0, stepper=stepper,
                          config=cfg)
    assert bool(s1["converged"])
    assert int(s1["n_accepted"]) >= 2

    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    YN, sN = run_adaptive(rhs, Ys, Yas, 0.0, 600.0, 60.0, stepper=stepper,
                          config=cfg)
    assert bool(sN["converged"])
    assert int(sN["n_accepted"]) == int(s1["n_accepted"])
    assert int(sN["n_rejected"]) == int(s1["n_rejected"])
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]), np.asarray(Y1["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )


def test_land_surface_update_step_device_invariant():
    """LandModel(surface_update='step') across the parallel engines: the
    pjit-sharded step (8 devices) matches the single-device frozen-exchange
    loop, and the sharded segment (which re-wraps the freeze with the
    shard-local model) matches the single-device segment — the frozen
    surface exchange must not depend on device count."""
    from landhydrology.domains import make_function_space
    from landhydrology.models.land import (
        make_rhs as make_land_rhs,
        wrap_stepper_for_land,
    )
    from landhydrology.segment import make_segment_run
    from landhydrology.parallel import make_fused_sharded_run

    land = dataclasses.replace(_land_model(), surface_update="step")
    Y, Ya = _land_states(land, h_s0=5e-4)
    dt, n = 10.0, 8

    # single-device frozen-exchange reference
    grid = make_function_space(land.soil.domain, land.float_dtype)
    stepper = wrap_stepper_for_land(SSPRK33(), land, grid)
    rhs = make_land_rhs(land, grid)
    Yr, t = Y, jnp.asarray(0.0)
    for _ in range(n):
        Yr = stepper.step(rhs, Yr, Ya, t, jnp.asarray(dt))
        t = t + dt

    # pjit-sharded step on 8 devices
    mesh = make_column_mesh(shape=(4, 2))
    step = make_sharded_step(land, mesh, SSPRK33(), dt=dt, mode="pjit")
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    Yp, tp = Ys, jnp.asarray(0.0)
    for _ in range(n):
        Yp, tp = step(Yp, Yas, tp)
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(Yp["soil"][k]), np.asarray(Yr["soil"][k]),
            rtol=1e-12, atol=1e-18, err_msg=k,
        )
    np.testing.assert_allclose(
        np.asarray(Yp["surface"]["h_s"]), np.asarray(Yr["surface"]["h_s"]),
        rtol=1e-12, atol=1e-18,
    )

    # sharded segment (8 devices) == single-device segment, both step-mode
    ncol = NX * NY
    flat_land = dataclasses.replace(
        land,
        soil=dataclasses.replace(
            land.soil,
            domain=dataclasses.replace(land.soil.domain, batch_shape=(ncol,)),
        ),
    )
    run_p = make_segment_run(
        flat_land, SSPRK33(), dt=dt, steps_per_call=4,
    )
    Yf = {
        "soil": {k: v.reshape(NZ, ncol) for k, v in Y["soil"].items()},
        "surface": {"h_s": Y["surface"]["h_s"].reshape(ncol)},
    }
    tf = jnp.asarray(0.0, dtype=jnp.float64)
    for _ in range(n // 4):
        Yf = run_p(Yf, tf)
        tf = tf + 4 * dt
    runN = make_fused_sharded_run(
        land, mesh, SSPRK33(), dt=dt, steps_per_call=4, n_calls=n // 4,
    )
    YN, _ = runN(Ys, Yas, jnp.asarray(0.0))
    for k in Y["soil"]:
        np.testing.assert_allclose(
            np.asarray(YN["soil"][k]),
            np.asarray(Yf["soil"][k]).reshape(NZ, NX, NY),
            rtol=1e-13, atol=1e-18, err_msg=k,
        )

    # and the frozen path genuinely differs from stage-level semantics
    land_stage = dataclasses.replace(land, surface_update="stage")
    step_s = make_sharded_step(land_stage, mesh, SSPRK33(), dt=dt, mode="pjit")
    Yq, tq = Ys, jnp.asarray(0.0)
    for _ in range(n):
        Yq, tq = step_s(Yq, Yas, tq)
    dev = float(jnp.max(jnp.abs(Yq["soil"]["vartheta_l"]
                                - Yp["soil"]["vartheta_l"])))
    assert dev > 0.0, "surface_update flag silently ignored on pjit path"
