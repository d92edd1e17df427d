"""RHS mechanism tests, mirroring
``/root/reference/test/SoilModel/test_rhs.jl`` (fully prescribed model is a
no-op; update_aux writes the prescribed profiles) and the "test default ic"
block of ``test/SoilModel/coupled.jl:123-235`` (default state values, zero
tendencies at equilibrium, and the hand-rolled Richards divergence oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np

from landhydrology.constants import default_earth_param_set as param_set
from landhydrology.domains import Column, make_function_space
from landhydrology.models.soil import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    default_initial_conditions,
    initialize_auxiliary,
    make_rhs,
    make_update_aux,
    vanGenuchten,
)
from landhydrology.models.soil.heat import (
    k_solid,
    ksat_frozen,
    ksat_unfrozen,
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.models.soil.water import (
    effective_saturation,
    hydraulic_conductivity,
)


def test_empty_rhs_and_update_aux():
    """Fully prescribed model: rhs is a no-op and update_aux evaluates the
    profiles (cf. ``test_rhs.jl:1-43``)."""
    domain = Column(zlim=(-2.0, 0.0), nelements=20)

    def Tp(z, t):
        return 10.0 * z + t

    def vartheta_lp(z, t):
        return 10.0 * z * t

    def theta_ip(z, t):
        return jnp.zeros_like(z)

    model = SoilModel(
        domain=domain,
        energy_model=PrescribedTemperatureModel(T_profile=Tp),
        hydrology_model=PrescribedHydrologyModel(
            vartheta_l_profile=vartheta_lp, theta_i_profile=theta_ip
        ),
        boundary_conditions=None,
    )
    grid = make_function_space(domain, jnp.float64)
    Ya = initialize_auxiliary(model, jnp.asarray(0.0), grid.zc)

    rhs = make_rhs(model)
    dY = rhs({model.name: {}}, Ya, jnp.asarray(0.0))
    assert dY == {model.name: {}}

    t = jnp.asarray(10.0)
    Ya = make_update_aux(model.energy_model)(Ya, t, model.name)
    Ya = make_update_aux(model.hydrology_model)(Ya, t, model.name)
    z = np.asarray(grid.zc)
    np.testing.assert_allclose(Ya["soil"]["T"], 10.0 * z + 10.0)
    np.testing.assert_allclose(Ya["soil"]["vartheta_l"], 10.0 * z * 10.0)
    np.testing.assert_allclose(Ya["soil"]["theta_i"], np.zeros_like(z))


def _coupled_model():
    """The sand-textured coupled model of ``coupled.jl:123-196``."""
    nu = 0.5
    Ksat = 0.0443 / 3600 / 100
    kappa_solid = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_gravel=0.0,
        nu_ss_om=0.0,
        nu_ss_quartz=0.92,
        rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=kappa_solid,
        kappa_sat_unfrozen=ksat_unfrozen(kappa_solid, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(kappa_solid, nu, 2.29),
    )
    bc = SoilColumnBC(
        top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
    )
    return SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=20),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=Ksat, theta_r=0.0)
        ),
        boundary_conditions=bc,
        soil_param_set=msp,
    )


def test_default_ic_and_divergence_oracle():
    """cf. ``coupled.jl:197-235``."""
    model = _coupled_model()
    Y, Ya = default_initial_conditions(model)

    z = np.asarray(Ya["zc"]).ravel()
    np.testing.assert_allclose(z, np.arange(-1.95, 0.0, 0.1), atol=1e-12)
    np.testing.assert_allclose(Y["soil"]["vartheta_l"], np.full(20, 0.25))
    np.testing.assert_allclose(Y["soil"]["theta_i"], np.zeros(20))

    T0 = param_set.T_0
    rho_c_s = volumetric_heat_capacity(
        Y["soil"]["vartheta_l"], Y["soil"]["theta_i"], model.soil_param_set.rho_c_ds,
        param_set,
    )
    rho_e_int = volumetric_internal_energy(
        Y["soil"]["theta_i"], rho_c_s, T0, param_set
    )
    np.testing.assert_allclose(Y["soil"]["rho_e_int"], rho_e_int)

    rhs = make_rhs(model)
    dY = rhs(Y, Ya, jnp.asarray(0.0))
    np.testing.assert_allclose(dY["soil"]["theta_i"], np.zeros(20))
    np.testing.assert_allclose(dY["soil"]["rho_e_int"], np.zeros(20), atol=1e-25)

    # hand-rolled Richards divergence (coupled.jl:223-234): uniform state ->
    # -K∇h = -K on interior faces, 0 at SetValue boundaries
    S = effective_saturation(0.5, 0.25, 0.0)
    K = hydraulic_conductivity(
        model.hydrology_model.hydraulic_model, S, 1.0, 1.0
    )
    expected_flux = np.zeros(21) - float(K)
    expected_flux[0] = 0.0
    expected_flux[-1] = 0.0
    minus_div = -(expected_flux[1:] - expected_flux[:-1]) / 0.1
    assert float(np.sum(np.asarray(dY["soil"]["vartheta_l"]) - minus_div)) < np.finfo(
        np.float64
    ).eps


def test_rhs_jits_and_batches():
    """The rhs must jit cleanly and broadcast over batched columns."""
    model = _coupled_model()
    Y, Ya = default_initial_conditions(model)
    rhs = jax.jit(make_rhs(model))
    dY = rhs(Y, Ya, jnp.asarray(0.0))
    assert dY["soil"]["vartheta_l"].shape == (20,)

    # batched: same column replicated -> identical tendencies per column
    ncol = 6
    Yb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[:, None], (x.shape[0], ncol)), Y
    )
    domain_b = Column(zlim=(-2.0, 0.0), nelements=20, batch_shape=(ncol,))
    import dataclasses

    model_b = dataclasses.replace(model, domain=domain_b)
    grid_b = make_function_space(domain_b, jnp.float64)
    Yab = {"zc": grid_b.zc, "soil": {}}
    dYb = jax.jit(make_rhs(model_b))(Yb, Yab, jnp.asarray(0.0))
    assert dYb["soil"]["vartheta_l"].shape == (20, ncol)
    np.testing.assert_allclose(
        dYb["soil"]["vartheta_l"],
        np.broadcast_to(np.asarray(dY["soil"]["vartheta_l"])[:, None], (20, ncol)),
        rtol=1e-14,
        atol=1e-20,
    )


def test_assume_no_ice_specialization_exact():
    """assume_no_ice is an exact specialization when theta_i == 0."""
    import dataclasses

    model = _coupled_model()
    model_fast = dataclasses.replace(model, assume_no_ice=True)
    Y, Ya = default_initial_conditions(model)
    dY = make_rhs(model)(Y, Ya, jnp.asarray(0.0))
    dY_fast = make_rhs(model_fast)(Y, Ya, jnp.asarray(0.0))
    for k in dY["soil"]:
        np.testing.assert_allclose(
            np.asarray(dY_fast["soil"][k]), np.asarray(dY["soil"][k]),
            rtol=1e-14, atol=1e-20, err_msg=k,
        )
    # invalid combination rejected
    from landhydrology.models.soil.freeze_thaw import FreezeThaw

    import pytest as _pytest

    with _pytest.raises(ValueError):
        dataclasses.replace(model, assume_no_ice=True, freeze_thaw=FreezeThaw())
