"""Sharded checkpoint/restore on the 8-virtual-device mesh (VERDICT r1
item 9): orbax writes each device's shards directly (no gather-to-host)
and restore places leaves straight onto the template's mesh shardings —
values AND shardings round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology.checkpoint import CheckpointManager
from landhydrology.parallel import make_column_mesh, shard_state

pytestmark = pytest.mark.multihost

NZ, NX, NY = 6, 8, 8


def _state(dtype=jnp.float64):
    rng = np.random.default_rng(17)
    return {
        "soil": {
            "vartheta_l": jnp.asarray(
                rng.uniform(0.1, 0.3, (NZ, NX, NY)), dtype=dtype
            ),
            "theta_i": jnp.zeros((NZ, NX, NY), dtype=dtype),
            "rho_e_int": jnp.asarray(
                rng.normal(-1e7, 1e6, (NZ, NX, NY)), dtype=dtype
            ),
        }
    }


def test_sharded_save_restore_preserves_values_and_shardings(tmp_path):
    mesh = make_column_mesh(shape=(4, 2))
    Y = shard_state(_state(), mesh)
    mgr = CheckpointManager(str(tmp_path), use_orbax=True)
    mgr.save(7, Y, t=123.5)

    # restore into a freshly sharded zero template of the same structure
    template = shard_state(
        jax.tree_util.tree_map(jnp.zeros_like, _state()), mesh
    )
    Y2, t, step = mgr.restore(template)
    assert step == 7 and t == 123.5
    for k in Y["soil"]:
        a, b = Y["soil"][k], Y2["soil"][k]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # sharding preserved: distributed across all 8 devices with the
        # same shard shape as the original (not fully replicated)
        assert b.sharding.device_set == a.sharding.device_set, k
        assert len(b.sharding.device_set) == 8, k
        assert b.sharding.shard_shape(b.shape) == a.sharding.shard_shape(
            a.shape
        ), k
        assert b.sharding.shard_shape(b.shape) == (NZ, NX // 4, NY // 2), k


def test_sharded_restore_casts_dtype(tmp_path):
    """An f64-written sharded checkpoint restores into an f32 sharded
    template (cast + re-placement fallback path)."""
    mesh = make_column_mesh(shape=(4, 2))
    Y64 = shard_state(_state(jnp.float64), mesh)
    mgr = CheckpointManager(str(tmp_path), use_orbax=True)
    mgr.save(1, Y64, t=9.0)

    template32 = shard_state(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros_like(x, dtype=jnp.float32), _state()
        ),
        mesh,
    )
    Y32, t, _ = mgr.restore(template32)
    assert t == 9.0
    for k in Y64["soil"]:
        got = Y32["soil"][k]
        assert got.dtype == jnp.float32, k
        assert len(got.sharding.device_set) == 8, k
        np.testing.assert_allclose(
            np.asarray(got),
            np.asarray(Y64["soil"][k]).astype(np.float32),
            rtol=1e-7,
        )


def test_sharded_roundtrip_through_stepping(tmp_path):
    """Save mid-run on the mesh, restore, continue: identical to an
    uninterrupted sharded run (bitwise resume on a mesh)."""
    from landhydrology import (
        Column,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.parallel import make_sharded_step
    from landhydrology.timestepping import SSPRK33

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NX, NY)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.0)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
    )

    def ic(z, m):
        th = 0.2 + 0.05 * jnp.sin(3.0 * z)
        ti = jnp.zeros_like(th)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th + 0 * z,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.full_like(th, 288.0), ps
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    mesh = make_column_mesh(shape=(4, 2))
    Ys, Yas = shard_state(Y, mesh), shard_state(Ya, mesh)
    step = make_sharded_step(model, mesh, SSPRK33(), dt=20.0)

    t = jnp.asarray(0.0)
    for _ in range(3):
        Ys, t = step(Ys, Yas, t)
    mgr = CheckpointManager(str(tmp_path), use_orbax=True)
    mgr.save(3, Ys, t=float(t))
    # continue uninterrupted
    Yu, tu = Ys, t
    for _ in range(2):
        Yu, tu = step(Yu, Yas, tu)

    # restore and continue
    template = jax.tree_util.tree_map(jnp.zeros_like, Ys)
    Yr, tr, _ = mgr.restore(template)
    tr = jnp.asarray(tr)
    for _ in range(2):
        Yr, tr = step(Yr, Yas, tr)

    for k in Y["soil"]:
        np.testing.assert_array_equal(
            np.asarray(Yr["soil"][k]), np.asarray(Yu["soil"][k]), err_msg=k
        )
    assert len(Yr["soil"]["vartheta_l"].sharding.device_set) == 8
