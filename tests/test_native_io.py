"""Native async trajectory-sink tests: C++ writer round-trip, Python
fallback writer compatibility, and producer/consumer integrity under many
records."""

import numpy as np
import pytest

from landhydrology.runtime import io as rio
from landhydrology.runtime import TrajectorySink, native_available, read_trajectory


def _records(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        out.append(
            (
                k,
                k * 0.5,
                {
                    "vartheta_l": rng.random((8, 16)).astype(np.float32),
                    "rho_e_int": rng.random((8, 16)).astype(np.float64),
                    "step_idx": np.asarray([k], dtype=np.int64),
                },
            )
        )
    return out


def test_native_library_builds():
    assert native_available(), "C++ trajsink failed to build/load"


def test_roundtrip_native(tmp_path):
    path = str(tmp_path / "traj.bin")
    recs = _records(12)
    with TrajectorySink(path, max_pending=4) as sink:
        assert sink.is_native
        for step, t, arrays in recs:
            sink.append(step, t, arrays)
        sink.flush()
        assert sink.records_written() == 12
    back = read_trajectory(path)
    assert len(back) == 12
    for (s0, t0, a0), (s1, t1, a1) in zip(recs, back):
        assert s0 == s1 and t0 == t1
        for k in a0:
            assert a0[k].dtype == a1[k].dtype
            np.testing.assert_array_equal(a0[k], a1[k])


def test_python_fallback_same_format(tmp_path, monkeypatch):
    """The fallback writer must produce byte-compatible files."""
    path = str(tmp_path / "traj_py.bin")
    monkeypatch.setattr(rio, "_lib", None)
    monkeypatch.setattr(rio, "_lib_tried", True)  # block native load
    sink = rio.TrajectorySink(path)
    assert not sink.is_native
    recs = _records(3, seed=1)
    for step, t, arrays in recs:
        sink.append(step, t, arrays)
    sink.close()
    back = read_trajectory(path)
    assert len(back) == 3
    for (s0, t0, a0), (s1, t1, a1) in zip(recs, back):
        for k in a0:
            np.testing.assert_array_equal(a0[k], a1[k])


def test_many_small_records_async(tmp_path):
    """Backpressure path: more records than the queue depth."""
    path = str(tmp_path / "traj_many.bin")
    with TrajectorySink(path, max_pending=2) as sink:
        for k in range(200):
            sink.append(k, float(k), {"x": np.full((4,), k, dtype=np.float32)})
    back = read_trajectory(path)
    assert len(back) == 200
    assert all(back[k][0] == k for k in range(200))
    np.testing.assert_array_equal(back[137][2]["x"], np.full((4,), 137, np.float32))


def test_append_mode_preserves_previous_records(tmp_path):
    """Resume workflows: append=True keeps earlier records (both writers)."""
    path = str(tmp_path / "traj_app.bin")
    with TrajectorySink(path) as sink:
        sink.append(0, 0.0, {"x": np.ones(3, np.float32)})
    with TrajectorySink(path, append=True) as sink:
        sink.append(1, 1.0, {"x": 2 * np.ones(3, np.float32)})
    back = read_trajectory(path)
    assert [r[0] for r in back] == [0, 1]
    np.testing.assert_array_equal(back[1][2]["x"], 2 * np.ones(3, np.float32))

    # fallback writer compatibility
    import pytest as _pytest

    path2 = str(tmp_path / "traj_app_py.bin")
    import landhydrology.runtime.io as rio2

    orig = (rio2._lib, rio2._lib_tried)
    try:
        rio2._lib, rio2._lib_tried = None, True
        with rio2.TrajectorySink(path2) as sink:
            sink.append(0, 0.0, {"x": np.ones(2, np.float64)})
        with rio2.TrajectorySink(path2, append=True) as sink:
            sink.append(1, 1.0, {"x": np.zeros(2, np.float64)})
    finally:
        rio2._lib, rio2._lib_tried = orig
    back2 = read_trajectory(path2)
    assert len(back2) == 2
