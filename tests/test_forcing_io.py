"""Forcing-data pipeline tests: native reader round-trip, prefetch
staging, numpy-fallback equivalence, and an end-to-end forced simulation
driven through windowed streaming."""

import numpy as np
import pytest

from landhydrology.runtime import forcing as rf
from landhydrology.runtime import ForcingReader, stream_windows, write_forcing


def _make_file(path, n_times=48, n_cols=6, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    times = np.arange(n_times, dtype=np.float64) * 60.0
    fields = {
        "u_atm": rng.random((n_times, n_cols)).astype(dtype),
        "theta_atm": (280 + 10 * rng.random((n_times, n_cols))).astype(dtype),
        "rain": rng.random((n_times, n_cols)).astype(dtype) * 1e-6,
    }
    write_forcing(str(path), times, fields)
    return times, fields


def test_native_library_builds():
    assert rf.native_available(), "C++ forcingreader failed to build/load"


def test_roundtrip_native(tmp_path):
    path = tmp_path / "forcing.bin"
    times, fields = _make_file(path)
    with ForcingReader(str(path)) as r:
        assert r.is_native
        assert r.n_times == 48 and r.n_cols == 6
        assert r.field_names == sorted(fields)
        np.testing.assert_array_equal(r.times, times)
        w = r.window(10, 8)
        for k in fields:
            np.testing.assert_array_equal(w[k], fields[k][10:18])
        # full-range window
        w = r.window(0, 48)
        for k in fields:
            np.testing.assert_array_equal(w[k], fields[k])
        with pytest.raises(IndexError):
            r.window(44, 8)


def test_prefetch_serves_staged_window(tmp_path):
    path = tmp_path / "forcing.bin"
    _, fields = _make_file(path, seed=3)
    with ForcingReader(str(path)) as r:
        assert r.prefetch_hits == 0
        r.prefetch(4, 8)
        w = r.window(4, 8)  # must wait for staging, then serve from it
        assert r.prefetch_hits == 1
        for k in fields:
            np.testing.assert_array_equal(w[k], fields[k][4:12])
        # a non-matching window bypasses the stage without error
        w2 = r.window(0, 4)
        assert r.prefetch_hits == 1
        np.testing.assert_array_equal(w2["rain"], fields["rain"][:4])


def test_fallback_matches_native(tmp_path, monkeypatch):
    path = tmp_path / "forcing.bin"
    _, fields = _make_file(path, dtype=np.float64, seed=7)
    with ForcingReader(str(path)) as r_nat:
        w_nat = r_nat.window(3, 5)
    monkeypatch.setattr(rf, "_lib", None)
    monkeypatch.setattr(rf, "_lib_tried", True)
    r_py = ForcingReader(str(path))
    assert not r_py.is_native
    w_py = r_py.window(3, 5)
    for k in fields:
        np.testing.assert_array_equal(w_nat[k], w_py[k])


def test_stream_windows_order_and_overlap(tmp_path):
    path = tmp_path / "forcing.bin"
    _, fields = _make_file(path, n_times=40, seed=1)
    with ForcingReader(str(path)) as r:
        seen = []
        for i0, w in stream_windows(r, window=16):
            seen.append((i0, w["u_atm"].shape[0]))
            np.testing.assert_array_equal(
                w["u_atm"], fields["u_atm"][i0:i0 + w["u_atm"].shape[0]]
            )
        assert seen == [(0, 16), (16, 16), (32, 8)]
        # every full window after the first was served from the stage
        assert r.prefetch_hits >= 2


def test_forced_simulation_stream(tmp_path):
    """End-to-end: a Richards column whose top flux is read from a forcing
    file in windows must reproduce the same trajectory as an in-memory run
    with the identical flux series (library-API oracle)."""
    import jax.numpy as jnp

    from landhydrology import (
        Column,
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

    n_seg, seg_len, dt = 6, 4, 50.0
    times = np.arange(n_seg, dtype=np.float64) * seg_len * dt
    rng = np.random.default_rng(5)
    infl = -1e-7 * (1 + rng.random((n_seg, 1)))  # per-segment top influx
    path = tmp_path / "flux.bin"
    write_forcing(str(path), times, {"top_flux": infl.astype(np.float64)})

    def run_segment(Y, t0, flux):
        model = SoilModel(
            domain=Column(zlim=(-1.0, 0.0), nelements=20),
            energy_model=PrescribedTemperatureModel(),
            hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten()),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(hydrology=VerticalFlux(float(flux))),
                bottom=SoilComponentBC(hydrology=FreeDrainage()),
            ),
            soil_param_set=SoilParams(nu=0.43, S_s=1e-3),
        )
        if Y is None:
            Y, Ya = initialize_states(
                model,
                lambda z, m: {
                    "vartheta_l": jnp.full_like(z, 0.2),
                    "theta_i": jnp.zeros_like(z),
                },
                t0,
            )
        else:
            _, Ya = initialize_states(
                model,
                lambda z, m: {
                    "vartheta_l": jnp.full_like(z, 0.2),
                    "theta_i": jnp.zeros_like(z),
                },
                t0,
            )
        sim = Simulation(
            model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt,
            tspan=(t0, t0 + seg_len * dt),
        )
        sol = sim.run()
        return sol.state(-1)

    # streamed from the forcing file
    Y = None
    with ForcingReader(str(path)) as r:
        for i0, w in stream_windows(r, window=1):
            Y = run_segment(Y, float(times[i0]), w["top_flux"][0, 0])
    streamed = np.asarray(Y["soil"]["vartheta_l"])

    # oracle: identical fluxes straight from memory
    Y = None
    for k in range(n_seg):
        Y = run_segment(Y, float(times[k]), infl[k, 0])
    np.testing.assert_array_equal(streamed, np.asarray(Y["soil"]["vartheta_l"]))
    assert streamed[-1] > 0.2  # influx wet the top cell
