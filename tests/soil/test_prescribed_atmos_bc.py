"""Turbulent surface-flux tests, mirroring
``/root/reference/test/SoilModel/test_prescribed_atmos_bc.jl``:

- zero total tendency when soil surface is in equilibrium with the
  atmosphere (saturated surface, equal T and q);
- exact equality between ``compute_turbulent_surface_fluxes`` and an inline
  reimplementation of the flux pipeline (the reference's equality oracle);
- oversaturated surface gives the same result as exactly saturated;
- t_star == 0 when the temperatures match;
- type errors for prescribed components and bottom-face atmos forcing.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    PrescribedAtmosForcing,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    initialize_states,
)
from landhydrology.constants import default_earth_param_set as param_set
from landhydrology.domains import make_function_space
from landhydrology.models.soil import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    boundary_fluxes,
    vanGenuchten,
)
from landhydrology.models.soil.heat import (
    volumetric_heat_capacity,
    volumetric_internal_energy,
)
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.models.soil.surface_fluxes import (
    compute_turbulent_surface_fluxes,
    cp_m,
    q_vap_saturation_liquid,
    surface_conditions,
)
from landhydrology.models.soil.water import (
    effective_saturation,
    matric_potential,
    volumetric_liquid_fraction,
)

T_SURF = 299.0
RHO_A = 1.17
Z_IN = 0.05
U_ATM = 0.34
NU = 0.55


@pytest.fixture
def model():
    hm = vanGenuchten(n=1.68, alpha=5.0, Ksat=0.0, theta_r=0.084)
    q_atm = q_vap_saturation_liquid(param_set, T_SURF, RHO_A)
    surface_bc = PrescribedAtmosForcing(
        u_atm=U_ATM,
        theta_atm=T_SURF,
        z_atm=Z_IN,
        theta_scale=T_SURF,
        rho_a_sfc=RHO_A,
        q_atm=q_atm,
    )
    bc = SoilColumnBC(
        top=surface_bc,
        bottom=SoilComponentBC(
            energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)
        ),
    )
    return SoilModel(
        domain=Column(zlim=(-0.55, 0.0), nelements=10),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=bc,
        soil_param_set=SoilParams(nu=NU, rho_c_ds=1.0),
    )


def test_equilibrium_gives_zero_rhs(model):
    """Saturated surface at the atmospheric temperature and humidity:
    the full rhs must vanish (test_prescribed_atmos_bc.jl:58-79)."""

    def ic(z, m):
        rho_c_s = volumetric_heat_capacity(NU, 0.0, m.soil_param_set.rho_c_ds, param_set)
        rho_e_int = volumetric_internal_energy(0.0, rho_c_s, T_SURF, param_set)
        return {
            "vartheta_l": jnp.full_like(z, NU),
            "theta_i": jnp.zeros_like(z),
            "rho_e_int": jnp.full_like(z, rho_e_int),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    dY = make_rhs(model)(Y, Ya, jnp.asarray(0.0))
    total = sum(float(jnp.sum(jnp.abs(v))) for v in dY["soil"].values())
    assert total == 0.0


def _inline_fluxes(model, vartheta_l, theta_i, T):
    """Inline reimplementation of the flux pipeline
    (test_prescribed_atmos_bc.jl:93-146)."""
    hm = model.hydrology_model.hydraulic_model
    sp = model.soil_param_set
    q_sat = q_vap_saturation_liquid(param_set, T, RHO_A)
    nu_eff = sp.nu - theta_i
    theta_l = volumetric_liquid_fraction(vartheta_l, nu_eff)
    S_l_eff = jnp.minimum(effective_saturation(nu_eff, theta_l, hm.theta_r), 1.0)
    psi = matric_potential(hm, S_l_eff)
    correction = jnp.exp(param_set.grav * psi / param_set.R_v / T)
    q_surf = q_sat * correction

    cond = surface_conditions(
        param_set,
        u_atm=model.boundary_conditions.top.u_atm,
        theta_atm=model.boundary_conditions.top.theta_atm,
        q_atm=model.boundary_conditions.top.q_atm,
        u_sfc=jnp.zeros_like(T),
        theta_sfc=T,
        q_sfc=q_surf,
        z_atm=model.boundary_conditions.top.z_atm,
        z_0m=sp.z_0m,
        z_0s=sp.z_0s,
        theta_scale=model.boundary_conditions.top.theta_scale,
    )
    u_star, t_star, q_star = cond["x_star"]
    cpm = cp_m(param_set, q_surf)
    h_d = param_set.cp_d * (T - param_set.T_0) + param_set.R_d * param_set.T_0
    lh = param_set.cp_v * (T - param_set.T_0) + param_set.LH_v0
    E = -RHO_A * u_star * q_star
    shf = -cpm * RHO_A * u_star * t_star - h_d * E
    lhf = lh * E
    return shf + lhf, E / param_set.rho_cloud_liq, t_star


def test_fluxes_match_inline_reimplementation(model):
    vartheta_l = jnp.array([NU, NU + 1e-3, NU - 1e-3, NU])
    theta_i = jnp.array([0.0, 0.0, 0.0, 0.1])
    T = jnp.array([T_SURF, T_SURF, 289.5, 289.5])

    heat_flux, E_vol = compute_turbulent_surface_fluxes(
        model.energy_model, model.hydrology_model, model, vartheta_l, theta_i, T
    )
    heat_inline, E_inline, t_star = _inline_fluxes(model, vartheta_l, theta_i, T)
    # reference asserts exact equality of the two paths (same code path here,
    # but guards against drift between the BC layer and the public function)
    np.testing.assert_array_equal(np.asarray(heat_flux), np.asarray(heat_inline))
    np.testing.assert_array_equal(np.asarray(E_vol), np.asarray(E_inline))

    # oversaturated == exactly saturated (test_prescribed_atmos_bc.jl:155)
    np.testing.assert_array_equal(heat_flux[0], heat_flux[1])
    np.testing.assert_array_equal(E_vol[0], E_vol[1])

    # t_star == 0 when temperatures match (":149")
    assert float(t_star[1]) == 0.0

    # fluxes are finite and the cold-surface cases produce condensation or
    # evaporation with the right sign: q_surf < q_atm -> E < 0 (downward)
    assert np.all(np.isfinite(np.asarray(heat_flux)))
    assert float(E_vol[2]) < 0.0


def test_type_errors(model):
    with pytest.raises(TypeError):
        compute_turbulent_surface_fluxes(
            PrescribedTemperatureModel(), PrescribedHydrologyModel(), model,
            0.5, 0.0, 300.0,
        )
    with pytest.raises(TypeError):
        compute_turbulent_surface_fluxes(
            SoilEnergyModel(), PrescribedHydrologyModel(), model, 0.5, 0.0, 300.0
        )
    with pytest.raises(TypeError):
        compute_turbulent_surface_fluxes(
            PrescribedTemperatureModel(), SoilHydrologyModel(), model,
            0.5, 0.0, 300.0,
        )


def test_atmos_bc_top_only(model):
    grid = make_function_space(model.domain, jnp.float64)
    X = {
        "vartheta_l": jnp.full((10,), NU),
        "theta_i": jnp.zeros((10,)),
        "T": jnp.full((10,), T_SURF),
    }
    with pytest.raises(ValueError):
        boundary_fluxes(
            X, model.boundary_conditions.top, "bottom", model, grid,
            jnp.asarray(0.0),
        )


def test_most_batched_and_jittable(model):
    """The MOST solve must jit and vectorize over columns."""
    import jax

    vartheta_l = jnp.full((128,), NU - 1e-2)
    theta_i = jnp.zeros((128,))
    T = jnp.full((128,), 295.0)
    f = jax.jit(
        lambda v, ti, T: compute_turbulent_surface_fluxes(
            model.energy_model, model.hydrology_model, model, v, ti, T
        )
    )
    hf, ev = f(vartheta_l, theta_i, T)
    assert hf.shape == (128,)
    assert np.all(np.isfinite(np.asarray(hf)))
    assert np.ptp(np.asarray(hf)) == 0.0  # identical columns -> identical flux


def test_time_varying_atmos_forcing(model):
    """Atmos fields may be callables of time (diurnal cycle): at matching
    instants the fluxes equal the constant-forcing result, and the flux
    actually varies over the cycle."""
    import dataclasses

    atmos0 = model.boundary_conditions.top
    diurnal = dataclasses.replace(
        atmos0,
        theta_atm=lambda t: T_SURF + 5.0 * jnp.sin(2 * jnp.pi * t / 86400.0),
        u_atm=lambda t: U_ATM + 0.1 * jnp.sin(2 * jnp.pi * t / 86400.0),
    )
    model_t = dataclasses.replace(
        model,
        boundary_conditions=dataclasses.replace(
            model.boundary_conditions, top=diurnal
        ),
    )

    args = (model_t.energy_model, model_t.hydrology_model)
    state = (jnp.asarray(NU - 1e-2), jnp.asarray(0.0), jnp.asarray(295.0))

    hf0, ev0 = compute_turbulent_surface_fluxes(*args, model_t, *state, t=0.0)
    hf_ref, ev_ref = compute_turbulent_surface_fluxes(*args, model, *state)
    np.testing.assert_array_equal(np.asarray(hf0), np.asarray(hf_ref))
    np.testing.assert_array_equal(np.asarray(ev0), np.asarray(ev_ref))

    hf6, _ = compute_turbulent_surface_fluxes(*args, model_t, *state, t=21600.0)
    assert float(jnp.abs(hf6 - hf0)) > 1.0  # warmer air at +6h changes flux
