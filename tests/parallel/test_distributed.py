"""True multi-process (simulated multi-host) test — SURVEY.md §4(f):
two OS processes form a jax.distributed cluster on CPU, shard a column
batch across hosts, take one coupled SSPRK33 step each on their local
shard, and verify the global result matches a single-process run."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.multihost

_WORKER = r"""
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

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from landhydrology import (
    Column, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
    SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.heat import (
    volumetric_heat_capacity, volumetric_internal_energy)
from landhydrology.parallel import make_column_mesh
from landhydrology.parallel.stepping import make_sharded_step
from landhydrology.timestepping import SSPRK33

NZ, NCOL = 8, 16
model = SoilModel(
    domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
    energy_model=SoilEnergyModel(),
    hydrology_model=SoilHydrologyModel(
        hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)),
    boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))),
    soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
)

# deterministic global state, built identically on every process
cols = np.arange(NCOL)[None, :]
theta_np = 0.15 + 0.1 * (cols % 7) / 7 + np.zeros((NZ, 1))
T_np = 285.0 + (cols % 5) + np.zeros((NZ, 1))
theta = jnp.asarray(theta_np); ti = jnp.zeros((NZ, NCOL))
rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
Y_global = {"soil": {
    "vartheta_l": theta, "theta_i": ti,
    "rho_e_int": volumetric_internal_energy(ti, rcs, jnp.asarray(T_np), ps)}}

mesh = make_column_mesh(axis_names=("columns",))
sharding = NamedSharding(mesh, P(None, "columns"))

n_proc = jax.process_count()
my_cols = slice(jax.process_index() * NCOL // n_proc,
                (jax.process_index() + 1) * NCOL // n_proc)

def put(x):
    # build the global array from this process's local shard of columns
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(x)[:, my_cols], global_shape=(NZ, NCOL))

Y = jax.tree_util.tree_map(put, Y_global)
from landhydrology.domains import make_function_space
grid = make_function_space(model.domain, jnp.float64)
Ya = {"zc": jax.device_put(grid.zc, NamedSharding(mesh, P())), "soil": {}}

step = make_sharded_step(model, mesh, SSPRK33(), dt=10.0, mode="pjit")
Yf, tf = step(Y, Ya, jnp.asarray(0.0))

# gather the full result on every process and dump from process 0
from jax.experimental import multihost_utils
v_local = Yf["soil"]["vartheta_l"]
v_full = multihost_utils.process_allgather(v_local, tiled=True)
if jax.process_index() == 0:
    np.save(os.environ["LH_OUT"], np.asarray(v_full))
print(f"proc {jax.process_index()} done", flush=True)
"""


def test_two_process_cluster(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out_file = str(tmp_path / "result.npy")

    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            LH_REPO=os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")),
            LH_COORD=coord,
            LH_NPROC="2",
            LH_PID=str(pid),
            LH_OUT=out_file,
            JAX_PLATFORMS="cpu",
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
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out.decode())
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    # single-process reference
    import jax
    import jax.numpy as jnp

    from landhydrology import (
        Column,
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
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.models.soil.rhs import make_rhs
    from landhydrology.timestepping import SSPRK33

    NZ, NCOL = 8, 16
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
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
        soil_param_set=SoilParams(nu=0.4, rho_c_ds=1.3e6),
    )
    cols = np.arange(NCOL)[None, :]
    theta = jnp.asarray(0.15 + 0.1 * (cols % 7) / 7 + np.zeros((NZ, 1)))
    T = jnp.asarray(285.0 + (cols % 5) + np.zeros((NZ, 1)))
    ti = jnp.zeros((NZ, NCOL))
    rcs = volumetric_heat_capacity(theta, ti, 1.3e6, ps)
    Y = {
        "soil": {
            "vartheta_l": theta,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }
    }
    grid = make_function_space(model.domain, jnp.float64)
    Ya = {"zc": grid.zc, "soil": {}}
    rhs = make_rhs(model, grid)
    Yref = SSPRK33().step(rhs, Y, Ya, jnp.asarray(0.0), jnp.asarray(10.0))

    got = np.load(out_file)
    np.testing.assert_allclose(
        got, np.asarray(Yref["soil"]["vartheta_l"]), rtol=1e-12, atol=1e-16
    )
