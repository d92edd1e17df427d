"""Thermal closure tests, mirroring
``/root/reference/test/SoilModel/test_heat_parameterizations.jl`` — every
closure against hand-computed expressions including the Kersten branch at
theta_i vs eps."""

import jax.numpy as jnp
import numpy as np

from landhydrology.models.soil.heat import (
    k_dry,
    k_solid,
    kersten_number,
    ksat_frozen,
    ksat_unfrozen,
    relative_saturation,
    saturated_thermal_conductivity,
    temperature_from_rho_e_int,
    thermal_conductivity,
    volumetric_heat_capacity,
    volumetric_internal_energy,
    volumetric_internal_energy_liq,
)
from landhydrology.models.soil.params import SoilParams


def test_temperature_from_rho_e_int(param_set):
    rho_i, T_ref, LH_f0 = (
        param_set.rho_cloud_ice,
        param_set.T_0,
        param_set.LH_f0,
    )
    got = temperature_from_rho_e_int(5.4e7, 0.05, 2.1415e6, param_set)
    np.testing.assert_allclose(
        got, T_ref + (5.4e7 + 0.05 * rho_i * LH_f0) / 2.1415e6, rtol=1e-14
    )


def test_volumetric_heat_capacity(param_set):
    got = volumetric_heat_capacity(0.25, 0.05, 1e6, param_set)
    np.testing.assert_allclose(
        got, 1e6 + 0.25 * param_set.rho_cp_l + 0.05 * param_set.rho_cp_i, rtol=1e-14
    )


def test_volumetric_internal_energy(param_set):
    got = volumetric_internal_energy(0.05, 2.1415e6, 300.0, param_set)
    expected = 2.1415e6 * (300.0 - param_set.T_0) - 0.05 * (
        param_set.rho_cloud_ice * param_set.LH_f0
    )
    np.testing.assert_allclose(got, expected, rtol=1e-14)


def test_saturated_thermal_conductivity(param_set):
    got = saturated_thermal_conductivity(0.25, 0.05, 0.57, 2.29)
    np.testing.assert_allclose(
        got, 0.57 ** (0.25 / 0.3) * 2.29 ** (0.05 / 0.3), rtol=1e-14
    )
    # dry branch exact zero
    assert float(saturated_thermal_conductivity(0.0, 0.0, 0.57, 2.29)) == 0.0


def test_relative_saturation():
    np.testing.assert_allclose(relative_saturation(0.25, 0.05, 0.4), 0.3 / 0.4)


def _branch_params():
    return SoilParams(
        nu=0.2,
        S_s=1e-3,
        nu_ss_om=0.1,
        nu_ss_gravel=0.1,
        nu_ss_quartz=0.1,
        rho_c_ds=0.0,
        kappa_solid=0.1,
        rho_p=1.0,
        kappa_sat_unfrozen=0.0,
        kappa_sat_frozen=0.0,
    )


def test_kersten_number_branches():
    sp = _branch_params()
    # ice fraction = 0: unfrozen Balland-Arp expression
    expected_unfrozen = 0.75 ** ((1.0 + 0.1 - 0.24 * 0.1 - 0.1) / 2.0) * (
        (1.0 + np.exp(-18.1 * 0.75)) ** (-3.0) - ((1.0 - 0.75) / 2.0) ** 3.0
    ) ** (1.0 - 0.1)
    np.testing.assert_allclose(
        kersten_number(0.0, 0.75, sp), expected_unfrozen, rtol=1e-14
    )
    # ice fraction > eps: frozen expression
    np.testing.assert_allclose(
        kersten_number(0.05, 0.75, sp), 0.75 ** (1.0 + 0.1), rtol=1e-14
    )


def test_thermal_conductivity():
    np.testing.assert_allclose(
        thermal_conductivity(1.5, 0.7287, 0.7187),
        0.7287 * 0.7187 + (1.0 - 0.7287) * 1.5,
        rtol=1e-14,
    )


def test_volumetric_internal_energy_liq(param_set):
    np.testing.assert_allclose(
        volumetric_internal_energy_liq(300.0, param_set),
        param_set.rho_cp_l * (300.0 - param_set.T_0),
        rtol=1e-14,
    )


def test_conductivity_composites():
    np.testing.assert_allclose(
        k_solid(0.5, 0.25, 2.0, 3.0, 2.0),
        2.0**0.5 * 2.0**0.25 * 3.0**0.25,
        rtol=1e-14,
    )
    np.testing.assert_allclose(
        ksat_frozen(0.5, 0.1, 0.4), 0.5**0.9 * 0.4**0.1, rtol=1e-14
    )
    np.testing.assert_allclose(
        ksat_unfrozen(0.5, 0.1, 0.4), 0.5**0.9 * 0.4**0.1, rtol=1e-14
    )


def test_k_dry(param_set):
    sp = _branch_params()
    kappa_air = param_set.K_therm
    expected = ((0.053 * 0.1 - kappa_air) * 0.8 + kappa_air * 1.0) / (
        1.0 - (1.0 - 0.053) * 0.8
    )
    np.testing.assert_allclose(k_dry(param_set, sp), expected, rtol=1e-14)


def test_kersten_vectorizes_over_batch():
    sp = _branch_params()
    theta_i = jnp.array([0.0, 0.05])
    S_r = jnp.array([0.75, 0.75])
    out = kersten_number(theta_i, S_r, sp)
    assert out.shape == (2,)
    assert not jnp.any(jnp.isnan(out))
