"""Hydraulics closure tests, mirroring
``/root/reference/test/SoilModel/test_water_parameterizations.jl`` — every
closure against closed-form values, Float32 type stability, the
matric-potential round trip, and the constant-head hydrostatic profile."""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology.models.soil.water import (
    IceImpedance,
    NoEffect,
    TemperatureDependentViscosity,
    effective_saturation,
    hydraulic_conductivity,
    hydrostatic_profile,
    impedance_factor,
    inverse_matric_potential,
    matric_potential,
    pressure_head,
    vanGenuchten,
    viscosity_factor,
    volumetric_liquid_fraction,
)

FT = jnp.float32


@pytest.fixture
def hm():
    return vanGenuchten(
        n=FT(1.56), alpha=FT(3.6), Ksat=FT(2.9e-7), theta_r=FT(0.2)
    )


def test_effective_saturation(hm):
    nu = FT(0.4)
    theta = jnp.array([0.3, 0.4, 0.5], dtype=FT)
    S = effective_saturation(nu, theta, hm.theta_r)
    np.testing.assert_allclose(S, [0.5, 1.0, 1.5], rtol=1e-6)
    assert S.dtype == FT


def test_matric_potential_and_inverse(hm):
    n, alpha, m = hm.n, hm.alpha, hm.m
    S = jnp.array([0.5, 1.0], dtype=FT)
    va = -((S[0] ** (-1.0 / m) - 1.0) * alpha ** (-n)) ** (1.0 / n)
    psi = matric_potential(hm, S)
    np.testing.assert_allclose(psi, [va, 0.0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(inverse_matric_potential(hm, psi), S, rtol=1e-6)
    assert psi.dtype == FT


def test_pressure_head(hm):
    nu, S_s = FT(0.4), FT(1e-2)
    theta = jnp.array([0.3, 0.4, 0.5], dtype=FT)
    p = pressure_head(hm, theta, nu, S_s)
    psi_unsat = matric_potential(hm, effective_saturation(nu, theta[:2], hm.theta_r))
    expected = jnp.concatenate([psi_unsat, jnp.array([10.0], dtype=FT)])
    np.testing.assert_allclose(p, expected, rtol=2e-6)
    assert p.dtype == FT
    assert not jnp.any(jnp.isnan(p))  # supersaturated branch must be NaN-free


def test_hydraulic_conductivity(hm):
    nu = FT(0.4)
    m, Ksat = hm.m, hm.Ksat
    S = effective_saturation(nu, jnp.array([0.3, 0.4, 0.5], dtype=FT), hm.theta_r)
    cf = NoEffect()
    k = hydraulic_conductivity(hm, S, viscosity_factor(cf, S), impedance_factor(cf, S))
    va = (jnp.sqrt(S[0]) * (1.0 - (1.0 - S[0] ** (1.0 / m)) ** m) ** 2) * Ksat
    np.testing.assert_allclose(k, [va, Ksat, Ksat], rtol=1e-6)
    assert k.dtype == FT
    assert not jnp.any(jnp.isnan(k))  # S > 1 branch must be NaN-free


def test_impedance_factor():
    f = impedance_factor(IceImpedance(omega=FT(7.0)), jnp.array(1.0, dtype=FT))
    np.testing.assert_allclose(f, 1e-7, rtol=1e-5)
    f1 = impedance_factor(NoEffect(), jnp.array(0.3, dtype=FT))
    np.testing.assert_allclose(f1, 1.0)


def test_viscosity_factor():
    vf = TemperatureDependentViscosity(gamma=FT(2.64e-2), T_ref=FT(288.0))
    T = jnp.array([278.0, 288.0, 298.0], dtype=FT)
    np.testing.assert_allclose(
        viscosity_factor(vf, T), np.exp(2.64e-2 * (np.asarray(T) - 288.0)), rtol=1e-6
    )
    np.testing.assert_allclose(viscosity_factor(NoEffect(), T), np.ones(3))


def test_hydrostatic_profile_constant_head(hm):
    """h = psi + z is constant for the hydrostatic profile
    (``test_water_parameterizations.jl:49-54``)."""
    nu, S_s = FT(0.4), FT(1e-2)
    z = jnp.arange(-1.0, 0.01, 0.1, dtype=FT)
    theta = hydrostatic_profile(hm, z, FT(-0.5), nu, S_s)
    psi = pressure_head(hm, theta, nu, S_s)
    h = psi + z
    assert h.dtype == FT
    assert float(jnp.std(h)) < 1e-6


def test_volumetric_liquid_fraction():
    vlf = volumetric_liquid_fraction(
        jnp.array([0.25, 0.5, 0.75], dtype=FT), FT(0.5)
    )
    np.testing.assert_allclose(vlf, [0.25, 0.5, 0.5])


def test_closures_are_gradient_safe():
    """The masked branches must not leak NaN through AD (SURVEY.md §7 hard
    part 2) — grads at/beyond saturation stay finite."""
    import jax

    hm64 = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.0)
    nu, S_s = 0.495, 1e-3

    g1 = jax.grad(lambda v: pressure_head(hm64, v, nu, S_s))(0.6)  # supersat
    g2 = jax.grad(
        lambda v: hydraulic_conductivity(
            hm64, effective_saturation(nu, v, 0.0), 1.0, 1.0
        )
    )(0.6)
    g3 = jax.grad(lambda v: pressure_head(hm64, v, nu, S_s))(0.3)  # unsat
    assert np.isfinite(g1) and np.isfinite(g2) and np.isfinite(g3)


def test_inverse_matric_potential_rejects_positive_psi():
    """Reference parity: positive matric potential is a domain error
    (``test_water_parameterizations.jl:19``)."""
    hm64 = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.0)
    with pytest.raises(ValueError, match="positive"):
        inverse_matric_potential(hm64, 1.0)
