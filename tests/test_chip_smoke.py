"""``chip_smoke.py``'s phases at small sizes on the CPU, and its refusal to
run without a GPU.  On the card the same phases run at full size
(``python chip_smoke.py``)."""

import contextlib
import io

import pytest

import chip_smoke


def test_device_check_refuses_a_cpu_only_run():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_prints_no_result_without_a_gpu(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(RuntimeError):
        chip_smoke.main(argv)
    assert out.getvalue() == ""


@pytest.mark.parametrize(
    "phase, kwargs",
    [
        (chip_smoke.phase_simulation, dict(nz=8, ncol=64, steps=30, sample=16)),
        (chip_smoke.phase_cli, dict(side=4)),
        (chip_smoke.phase_goldens, dict(names=["coupled", "forced"])),
        (chip_smoke.phase_forced, dict(nz=8, ncol=32, window=8, windows=2)),
        (chip_smoke.phase_segments, dict(nz=8, nx=8, ny=8)),
        (chip_smoke.phase_four_cards, dict(nz=8, nx=8, ny=8)),
    ],
    ids=lambda p: getattr(p, "__name__", ""),
)
def test_phase_passes_at_small_size(phase, kwargs):
    r = phase(**kwargs)
    assert r["deviation"] <= r["tolerance"], r
    assert r["wall_s"] > 0.0
