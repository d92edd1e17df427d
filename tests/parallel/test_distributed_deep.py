"""Deep multi-process coverage (VERDICT r4 item 5): the paths that matter
run across REAL OS-process boundaries, not just the pjit-soil step —

1. ``make_fused_sharded_run`` (the multi-device segment loop) on a
   2-process cluster == the
   single-process trajectory;
2. a LandModel + kinematic-wave routing config (multi-component state,
   cross-shard halo exchange of the pond) across the process boundary;
3. a sharded checkpoint written by one 2-process cluster, restored by a
   SECOND, fresh 2-process cluster (true restart), bitwise equal and able
   to continue stepping.

Worker results are allgathered and dumped by process 0; the parent
process computes single-process references and compares.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.multihost

_COMMON = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.environ["LH_REPO"])

from landhydrology.parallel import distributed

distributed.initialize(
    coordinator_address=os.environ["LH_COORD"],
    num_processes=int(os.environ["LH_NPROC"]),
    process_id=int(os.environ["LH_PID"]),
)
assert jax.process_count() == int(os.environ["LH_NPROC"])

import dataclasses
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils

from landhydrology import (
    Column, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC,
    SoilEnergyModel, SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.heat import (
    volumetric_heat_capacity, volumetric_internal_energy)
from landhydrology.models.land import (
    KinematicWaveRouting, LandModel, SurfaceWaterModel,
    initialize_states as land_init,
)
from landhydrology.parallel import make_column_mesh
from landhydrology.parallel.stepping import make_fused_sharded_run
from landhydrology.timestepping import SSPRK33

NZ, NX, NY = 6, 8, 2
NCOL = NX * NY


def soil_model(batch_shape):
    return SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=batch_shape),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-6,
                                         theta_r=0.0)),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
                rho_a_sfc=1.2, q_atm=0.005),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))),
        soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
    )


def land_model():
    zx = np.arange(NX)[:, None] - (NX - 1) / 2.0
    zy = np.arange(NY)[None, :] - (NY - 1) / 2.0
    terrain = 0.2 * np.exp(-(zx**2 + zy**2) / 6.0)
    return LandModel(
        soil=soil_model((NX, NY)),
        surface=SurfaceWaterModel(
            precipitation=lambda t: 6e-6,
            tau_pond=120.0,
            runoff=KinematicWaveRouting(
                elevation=jnp.asarray(terrain), manning_n=0.05, dx=1.0),
        ),
    )


def land_ic(z, m):
    shape = (NZ, NX, NY)
    th = jnp.full(shape, 0.2) + 0.02 * jnp.arange(NX)[None, :, None] / NX
    ti = jnp.zeros(shape)
    rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
    return {
        "vartheta_l": th,
        "theta_i": ti,
        "rho_e_int": volumetric_internal_energy(
            ti, rcs, jnp.full(shape, 290.0), ps),
    }


mesh2 = make_column_mesh(shape=(2, 1), axis_names=("x", "y"))
land = land_model()
Yl_global, Yal_global = land_init(land, land_ic, 0.0, h_s0=2e-3)

# build globally-sharded state from process-local shards (x-axis split)
npr = jax.process_count()
pid = jax.process_index()


def put(x, spec):
    sh = NamedSharding(mesh2, spec)
    x = np.asarray(x)
    ax = spec.index("x") if "x" in spec else None
    if ax is None:
        return jax.device_put(x, sh)
    lo = pid * x.shape[ax] // npr
    hi = (pid + 1) * x.shape[ax] // npr
    local = np.take(x, np.arange(lo, hi), axis=ax)
    return jax.make_array_from_process_local_data(sh, local, x.shape)


Yl = {
    "soil": {k: put(v, P(None, "x", "y")) for k, v in Yl_global["soil"].items()},
    "surface": {"h_s": put(Yl_global["surface"]["h_s"], P("x", "y"))},
}
Yal = {
    "zc": jax.device_put(Yal_global["zc"], NamedSharding(mesh2, P())),
    "soil": {},
}

run_land = make_fused_sharded_run(
    land, mesh2, SSPRK33(), dt=0.5, steps_per_call=2, n_calls=2,
)
"""

_WORKER_RUN = _COMMON + r"""
# --- phase A: fused-sharded soil (1-D mesh) across the process boundary ---
mesh1 = make_column_mesh(axis_names=("columns",))
model = soil_model((NCOL,))
cols = np.arange(NCOL)[None, :]
theta = jnp.asarray(0.15 + 0.1 * (cols % 7) / 7 + np.zeros((NZ, 1)))
ti = jnp.zeros((NZ, NCOL))
rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
Y_global = {"soil": {
    "vartheta_l": theta, "theta_i": ti,
    "rho_e_int": volumetric_internal_energy(
        ti, rcs, jnp.asarray(285.0 + (cols % 5) + np.zeros((NZ, 1))), ps)}}
sh1 = NamedSharding(mesh1, P(None, "columns"))
my = slice(pid * NCOL // npr, (pid + 1) * NCOL // npr)
Ys = jax.tree_util.tree_map(
    lambda x: jax.make_array_from_process_local_data(
        sh1, np.asarray(x)[:, my], (NZ, NCOL)), Y_global)
from landhydrology.domains import make_function_space
grid = make_function_space(model.domain, jnp.float64)
Yas = {"zc": jax.device_put(grid.zc, NamedSharding(mesh1, P())), "soil": {}}
run_f = make_fused_sharded_run(
    model, mesh1, SSPRK33(), dt=5.0, steps_per_call=2, n_calls=2,
)
Yf, _ = run_f(Ys, Yas, jnp.asarray(0.0))
v_full = multihost_utils.process_allgather(
    Yf["soil"]["vartheta_l"], tiled=True)
if pid == 0:
    np.save(os.environ["LH_OUT_A"], np.asarray(v_full))

# --- phase B: LandModel + kinematic routing, fused-sharded, 2-D mesh ---
Ylf, _ = run_land(Yl, Yal, jnp.asarray(0.0))
h_full = multihost_utils.process_allgather(Ylf["surface"]["h_s"], tiled=True)
v_land = multihost_utils.process_allgather(
    Ylf["soil"]["vartheta_l"], tiled=True)
if pid == 0:
    np.save(os.environ["LH_OUT_B_H"], np.asarray(h_full))
    np.save(os.environ["LH_OUT_B_V"], np.asarray(v_land))

# --- phase C: sharded checkpoint written by this cluster ---
from landhydrology.checkpoint import CheckpointManager

mgr = CheckpointManager(os.environ["LH_CKPT"], use_orbax=True)
mgr.save(4, Ylf, 2.0)
multihost_utils.sync_global_devices("ckpt-written")
print(f"proc {pid} run done", flush=True)
"""

_WORKER_RESTORE = _COMMON + r"""
# --- restart: a FRESH cluster restores the sharded checkpoint and
# continues stepping ---
from landhydrology.checkpoint import CheckpointManager

mgr = CheckpointManager(os.environ["LH_CKPT"], use_orbax=True)
Yr, t_r, _step = mgr.restore(Yl, step=4)
assert float(t_r) == 2.0
h_full = multihost_utils.process_allgather(Yr["surface"]["h_s"], tiled=True)
v_full = multihost_utils.process_allgather(
    Yr["soil"]["vartheta_l"], tiled=True)
if pid == 0:
    np.save(os.environ["LH_OUT_R_H"], np.asarray(h_full))
    np.save(os.environ["LH_OUT_R_V"], np.asarray(v_full))

# restored state must be usable: continue the fused-sharded run
Yc, _ = run_land(Yr, Yal, jnp.asarray(t_r))
vc = np.asarray(multihost_utils.process_allgather(
    Yc["soil"]["vartheta_l"], tiled=True))
assert np.isfinite(vc).all()
hc = multihost_utils.process_allgather(Yc["surface"]["h_s"], tiled=True)
if pid == 0:
    np.save(os.environ["LH_OUT_C_H"], np.asarray(hc))
print(f"proc {pid} restore done", flush=True)
"""


def _launch(script, tmp_path, tag, extra_env):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    worker = tmp_path / f"worker_{tag}.py"
    worker.write_text(script)
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            LH_REPO=os.path.abspath(
                os.path.join(os.path.dirname(__file__), "..", "..")
            ),
            LH_COORD=coord,
            LH_NPROC="2",
            LH_PID=str(pid),
            JAX_PLATFORMS="cpu",
            **extra_env,
        )
        env.pop("XLA_FLAGS", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    outs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker {tag} failed:\n{out}"


def test_two_process_fused_land_and_checkpoint_restart(tmp_path):
    files = {
        "LH_OUT_A": str(tmp_path / "a_soil.npy"),
        "LH_OUT_B_H": str(tmp_path / "b_hs.npy"),
        "LH_OUT_B_V": str(tmp_path / "b_v.npy"),
        "LH_OUT_R_H": str(tmp_path / "r_hs.npy"),
        "LH_OUT_R_V": str(tmp_path / "r_v.npy"),
        "LH_OUT_C_H": str(tmp_path / "c_hs.npy"),
        "LH_CKPT": str(tmp_path / "ckpt"),
    }
    _launch(_WORKER_RUN, tmp_path, "run", files)
    _launch(_WORKER_RESTORE, tmp_path, "restore", files)

    # ---- single-process references (same configs, 1-device mesh) ----
    import jax

    if jax.default_backend() != "cpu":  # conftest pins cpu; just in case
        pytest.skip("needs the CPU backend")
    import dataclasses

    import jax.numpy as jnp

    from landhydrology import (
        Column,
        PrescribedAtmosForcing,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.domains import make_function_space
    from landhydrology.models.land import (
        KinematicWaveRouting,
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
    )
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.parallel import make_column_mesh
    from landhydrology.parallel.stepping import make_fused_sharded_run
    from landhydrology.timestepping import SSPRK33

    NZ, NX, NY = 6, 8, 2
    NCOL = NX * NY

    def soil_model(batch_shape):
        return SoilModel(
            domain=Column(
                zlim=(-1.0, 0.0), nelements=NZ, batch_shape=batch_shape
            ),
            energy_model=SoilEnergyModel(),
            hydrology_model=SoilHydrologyModel(
                hydraulic_model=vanGenuchten(
                    n=2.0, alpha=2.6, Ksat=2e-6, theta_r=0.0
                )
            ),
            boundary_conditions=SoilColumnBC(
                top=PrescribedAtmosForcing(
                    u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
                    rho_a_sfc=1.2, q_atm=0.005,
                ),
                bottom=SoilComponentBC(
                    hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
                ),
            ),
            soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
        )

    mesh1 = make_column_mesh(shape=(1,), axis_names=("columns",),
                             devices=jax.devices()[:1])
    model = soil_model((NCOL,))
    cols = np.arange(NCOL)[None, :]
    theta = jnp.asarray(0.15 + 0.1 * (cols % 7) / 7 + np.zeros((NZ, 1)))
    ti = jnp.zeros((NZ, NCOL))
    rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
    Y = {
        "soil": {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, jnp.asarray(285.0 + (cols % 5) + np.zeros((NZ, 1))),
                ps,
            ),
        }
    }
    grid = make_function_space(model.domain, jnp.float64)
    Ya = {"zc": grid.zc, "soil": {}}
    run_f = make_fused_sharded_run(
        model, mesh1, SSPRK33(), dt=5.0, steps_per_call=2, n_calls=2,
    )
    Yref, _ = run_f(Y, Ya, jnp.asarray(0.0))
    got_a = np.load(files["LH_OUT_A"])
    np.testing.assert_allclose(
        got_a, np.asarray(Yref["soil"]["vartheta_l"]), rtol=1e-12, atol=1e-15
    )

    # land reference
    zx = np.arange(NX)[:, None] - (NX - 1) / 2.0
    zy = np.arange(NY)[None, :] - (NY - 1) / 2.0
    terrain = 0.2 * np.exp(-(zx**2 + zy**2) / 6.0)
    land = LandModel(
        soil=soil_model((NX, NY)),
        surface=SurfaceWaterModel(
            precipitation=lambda t: 6e-6,
            tau_pond=120.0,
            runoff=KinematicWaveRouting(
                elevation=jnp.asarray(terrain), manning_n=0.05, dx=1.0
            ),
        ),
    )

    def land_ic(z, m):
        shape = (NZ, NX, NY)
        th = (
            jnp.full(shape, 0.2)
            + 0.02 * jnp.arange(NX)[None, :, None] / NX
        )
        ti_ = jnp.zeros(shape)
        rcs_ = volumetric_heat_capacity(th, ti_, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti_,
            "rho_e_int": volumetric_internal_energy(
                ti_, rcs_, jnp.full(shape, 290.0), ps
            ),
        }

    Yl, Yal = land_init(land, land_ic, 0.0, h_s0=2e-3)
    mesh11 = make_column_mesh(shape=(1, 1), axis_names=("x", "y"),
                              devices=jax.devices()[:1])
    run_l = make_fused_sharded_run(
        land, mesh11, SSPRK33(), dt=0.5, steps_per_call=2, n_calls=2,
    )
    Ylref, _ = run_l(Yl, Yal, jnp.asarray(0.0))
    got_h = np.load(files["LH_OUT_B_H"])
    got_v = np.load(files["LH_OUT_B_V"])
    assert float(np.max(got_h)) > 0.0
    np.testing.assert_allclose(
        got_h, np.asarray(Ylref["surface"]["h_s"]), rtol=1e-12, atol=1e-15
    )
    np.testing.assert_allclose(
        got_v, np.asarray(Ylref["soil"]["vartheta_l"]), rtol=1e-12, atol=1e-15
    )

    # checkpoint restart: the fresh cluster restored exactly the state the
    # first cluster saved ...
    np.testing.assert_array_equal(np.load(files["LH_OUT_R_H"]), got_h)
    np.testing.assert_array_equal(np.load(files["LH_OUT_R_V"]), got_v)
    # ... and continued the run: one more fused-sharded window from the
    # restored state equals the single-process continuation
    Ycont, _ = run_l(Ylref, Yal, jnp.asarray(2.0))
    np.testing.assert_allclose(
        np.load(files["LH_OUT_C_H"]),
        np.asarray(Ycont["surface"]["h_s"]),
        rtol=1e-12,
        atol=1e-15,
    )
