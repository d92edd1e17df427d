"""End-to-end tests of the config-file CLI driver (``landhydrology.cli``).

The reference's user entry is scripts only (SURVEY.md §1 row 8); the CLI is
an addition beyond the reference, so the oracle here is the library API itself: a run
driven through ``cli.cmd_run`` must reproduce the same trajectory as the
equivalent hand-composed ``Simulation``.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from landhydrology import cli


@pytest.fixture()
def example_cfg(tmp_path):
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.cmd_example()
    cfg = json.loads(buf.getvalue())
    return cfg, tmp_path


def test_example_config_runs_and_matches_library(example_cfg):
    cfg, tmp = example_cfg
    cfg["simulation"] = {
        "dt": 50.0,
        "t_final": 5000.0,
        "saveat": 2500.0,
        "stepper": "SSPRK33",
    }
    out = tmp / "traj.npz"
    cfg["output"] = {"path": str(out)}
    cfg_path = tmp / "run.json"
    cfg_path.write_text(json.dumps(cfg))

    assert cli.cmd_run(str(cfg_path)) == 0
    data = np.load(out)
    assert set(data.files) >= {"t", "vartheta_l", "theta_i", "rho_e_int"}
    assert data["vartheta_l"].shape[0] == len(data["t"])

    # oracle: the same run composed by hand through the library API
    from landhydrology.simulations import Simulation

    model, stepper, Y, Ya, sim_kwargs, _ = cli.load_run(str(cfg_path))
    sol = Simulation(model, stepper, Y_init=Y, Ya_init=Ya, **sim_kwargs).run()
    np.testing.assert_array_equal(
        data["vartheta_l"][-1], np.asarray(sol.state(-1)["soil"]["vartheta_l"])
    )


def test_describe_and_steppers(example_cfg, capsys):
    cfg, tmp = example_cfg
    cfg_path = tmp / "run.json"
    cfg["simulation"]["stepper"] = "SSPRK104"
    cfg_path.write_text(json.dumps(cfg))
    assert cli.cmd_describe(str(cfg_path)) == 0
    captured = capsys.readouterr().out
    assert "SSPRK104" in captured and "SoilModel" in captured

    with pytest.raises(KeyError):
        cli._build_stepper("NoSuchStepper")


def test_hydrostatic_ic_and_checkpoint_resume(example_cfg):
    cfg, tmp = example_cfg
    cfg["initial_conditions"] = {"kind": "hydrostatic", "z_table": -1.0, "T": 290.0}
    cfg["simulation"] = {"dt": 50.0, "t_final": 2000.0, "saveat": 1000.0,
                        "stepper": "SSPRK33"}
    out = tmp / "traj.npz"
    cfg["output"] = {"path": str(out)}
    cfg["checkpoint"] = {"directory": str(tmp / "ckpts")}
    cfg_path = tmp / "run.json"
    cfg_path.write_text(json.dumps(cfg))

    assert cli.cmd_run(str(cfg_path)) == 0
    first = np.load(out)["vartheta_l"][-1]

    # hydrostatic IC: moisture decreases toward the surface above the table
    prof0 = np.load(out)["vartheta_l"][0]
    assert prof0[-1] < prof0[0]

    # re-running resumes from the saved checkpoint (restarts at t_final with
    # an empty remaining span is degenerate, so extend the horizon)
    cfg["simulation"]["t_final"] = 4000.0
    cfg_path.write_text(json.dumps(cfg))
    assert cli.cmd_run(str(cfg_path)) == 0
    resumed = np.load(out)["vartheta_l"][-1]
    assert resumed.shape == first.shape


def test_main_module_entrypoint(tmp_path):
    """`python -m landhydrology example` works as a subprocess."""
    proc = subprocess.run(
        [sys.executable, "-m", "landhydrology", "example"],
        capture_output=True,
        text=True,
        timeout=240,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    cfg = json.loads(proc.stdout)
    assert cfg["model"]["__type__"] == "SoilModel"


@pytest.fixture()
def flagship_cfg(tmp_path):
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.cmd_example(flagship=True)
    cfg = json.loads(buf.getvalue())
    return cfg, tmp_path


def test_flagship_config_round_trips_and_runs(flagship_cfg):
    """The full LandModel catchment (rain pulse + pond + MOST + energy +
    runoff routing) round-trips through config.py and runs via the CLI
    (VERDICT r2 item 7), matching the hand-composed Simulation."""
    import jax.numpy as jnp

    from landhydrology.config import from_config, to_config
    from landhydrology.models.land import (
        LandModel,
        PulsePrecipitation,
        RunoffRouting,
    )
    from landhydrology.simulations import Simulation

    cfg, tmp_path = flagship_cfg
    land = from_config(cfg["model"])
    assert isinstance(land, LandModel)
    assert isinstance(land.surface.precipitation, PulsePrecipitation)
    assert isinstance(land.surface.runoff, RunoffRouting)
    assert to_config(land) == cfg["model"]

    cfg["simulation"]["t_final"] = 30.0
    cfg["simulation"]["saveat"] = 15.0
    out = tmp_path / "flag.npz"
    cfg["output"] = {"path": str(out)}
    cfg_path = tmp_path / "flagship.json"
    cfg_path.write_text(json.dumps(cfg))
    assert cli.cmd_run(str(cfg_path)) == 0

    d = np.load(out)
    assert "surface/h_s" in d.files
    assert d["surface/h_s"].shape[0] == 3  # t0 + 2 saves
    # library-API oracle
    model, stepper, Y, Ya, sim_kwargs, _ = cli.load_run(str(cfg_path))
    sim = Simulation(model, stepper, Y_init=Y, Ya_init=Ya, **sim_kwargs)
    sim.run()
    np.testing.assert_allclose(
        d["surface/h_s"][-1], np.asarray(sim.Y["surface"]["h_s"]), rtol=1e-12
    )
    np.testing.assert_allclose(
        d["vartheta_l"][-1], np.asarray(sim.Y["soil"]["vartheta_l"]),
        rtol=1e-12,
    )
    assert float(d["surface/h_s"][-1].mean()) > 1e-6  # the pulse ponded


def test_cli_trbdf2_and_adaptive(example_cfg):
    """TR-BDF2 and adaptive error control are reachable from config files."""
    cfg, tmp_path = example_cfg
    cfg["simulation"].update(
        {"stepper": "TRBDF2Soil", "iters": 2, "dt": 500.0,
         "t_final": 2000.0, "saveat": 1000.0}
    )
    out = tmp_path / "trbdf2.npz"
    cfg["output"] = {"path": str(out)}
    p = tmp_path / "run_trbdf2.json"
    p.write_text(json.dumps(cfg))
    assert cli.cmd_run(str(p)) == 0
    d = np.load(out)
    assert np.all(np.isfinite(d["vartheta_l"]))

    cfg["simulation"]["adaptive"] = {"rtol": 1e-4, "atol": 1e-8}
    cfg["simulation"]["stepper"] = "SSPRK33"
    cfg["simulation"]["dt"] = 50.0
    out2 = tmp_path / "adaptive.npz"
    cfg["output"] = {"path": str(out2)}
    p2 = tmp_path / "run_adaptive.json"
    p2.write_text(json.dumps(cfg))
    assert cli.cmd_run(str(p2)) == 0
    d2 = np.load(out2)
    assert d2["vartheta_l"].shape[0] == 2  # initial + final
    assert np.all(np.isfinite(d2["vartheta_l"]))


def test_cli_implicit_stepper_with_tridiag_backend(example_cfg):
    """The simulation config's 'tridiag' key selects the tridiagonal
    backend of the implicit steppers (thomas | pcr)."""
    cfg, tmp = example_cfg
    cfg["simulation"] = {
        "dt": 100.0,
        "t_final": 300.0,
        "stepper": "TRBDF2Soil",
        "iters": 2,
        "tridiag": "pcr",
    }
    cfg["output"] = {"path": str(tmp / "traj_implicit.npz")}
    cfg_path = tmp / "run_implicit.json"
    cfg_path.write_text(json.dumps(cfg))
    model, stepper, Y, Ya, sim_kwargs, _ = cli.load_run(str(cfg_path))
    assert type(stepper).__name__ == "TRBDF2Soil"
    assert stepper.tridiag == "pcr"
    assert stepper.iters == 2
    assert cli.cmd_run(str(cfg_path)) == 0


@pytest.mark.parametrize("key", ["engine", "steps_per_call", "tile_cols"])
def test_removed_engine_keys_fail_loudly(example_cfg, key):
    """A config that still names an option of the removed Pallas engine is
    refused with a message saying so; it is not silently run on XLA."""
    cfg, tmp = example_cfg
    cfg["simulation"][key] = {"engine": "pallas"}.get(key, 48)
    path = tmp / "run_removed.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(TypeError, match="removed"):
        cli.load_run(str(path))
