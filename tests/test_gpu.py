"""Checks that only mean something on a GPU: the card's f32 path against
an f64 CPU run of the same columns, and an f64 golden reproduced on the
card.  They skip on a host without a GPU (the ``gpu`` fixture)."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_card_f32_simulation_matches_cpu_f64(gpu):
    r = chip_smoke.phase_simulation(nz=32, ncol=4096, steps=100, sample=64)
    assert r["deviation"] <= r["tolerance"], r


def test_card_reproduces_f64_goldens(gpu):
    r = chip_smoke.phase_goldens(infiltration=False)
    assert r["deviation"] <= r["tolerance"], r
