"""Independent oracle for the Monin-Obukhov surface-flux solver.

The reference outsources MOST to an externally validated package
(SurfaceFluxes.jl `surface_conditions` with `DGScheme`,
``/root/reference/src/SoilModel/boundary_conditions.jl:595-604``).  This
module provides the equivalent independent anchoring for the repo's
from-scratch solver (VERDICT r1 item 2):

- textbook Businger (1971) stability functions re-derived here in plain
  numpy (``np.arctan``/``np.log``, scalar branches — none of the library's
  masked/polynomial machinery), checked against hand-computed literals;
- a scipy ``brentq`` root solve of the Obukhov-length consistency equation
  per atmospheric state — a completely different solution method from the
  library's damped fixed point;
- agreement asserted over a grid of stable / unstable / neutral states,
  plus convergence of the solver's returned ``residual`` (< 1e-10) across
  that grid;
- the full flux pipeline (saturation humidity, soil-moisture correction,
  sensible+latent static-energy fluxes) re-derived inline from the oracle
  scales and compared to ``compute_turbulent_surface_fluxes`` — the role of
  the reference's inline re-derivation test
  (``test/SoilModel/test_prescribed_atmos_bc.jl:93-146``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import brentq

from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil import surface_fluxes as sf

KAPPA = ps.von_karman_const
G = ps.grav
A_BUSINGER = 4.7
PR0 = 0.74
EPS_VI = ps.molmass_ratio - 1.0


# ---------------------------------------------------------------------------
# Independent textbook implementation (scalar numpy, explicit branches)
# ---------------------------------------------------------------------------


def psi_m_ref(zeta: float) -> float:
    """Businger-Dyer integrated momentum stability function."""
    if zeta < 0.0:
        x = (1.0 - 15.0 * zeta) ** 0.25
        return float(
            np.log((1.0 + x) ** 2 * (1.0 + x * x) / 8.0)
            - 2.0 * np.arctan(x)
            + np.pi / 2.0
        )
    return -A_BUSINGER * zeta


def psi_h_ref(zeta: float) -> float:
    """Businger-Dyer integrated scalar stability function (Pr-stripped)."""
    if zeta < 0.0:
        y = np.sqrt(1.0 - 9.0 * zeta)
        return float(2.0 * np.log((1.0 + y) / 2.0))
    return -A_BUSINGER / PR0 * zeta


def stars_ref(Linv, du, dth, dq, z_atm, z0m, z0s):
    dm = np.log(z_atm / z0m) - psi_m_ref(z_atm * Linv) + psi_m_ref(z0m * Linv)
    ds = PR0 * (
        np.log(z_atm / z0s) - psi_h_ref(z_atm * Linv) + psi_h_ref(z0s * Linv)
    )
    return KAPPA * du / dm, KAPPA * dth / ds, KAPPA * dq / ds


def solve_most_ref(du, dth, dq, z_atm, z0m, z0s, theta_scale, q_atm):
    """Brent root solve of the Obukhov consistency equation
    ``Linv = kappa g theta_v_star / (u_star^2 theta_scale)``.

    Returns ``None`` when no root exists with |zeta| < 50 (the
    critical-stability decoupling regime — excluded from the comparison,
    as the library's clamped answer is a regularization there, not MOST).
    """

    def f(Linv):
        us, ts, qs = stars_ref(Linv, du, dth, dq, z_atm, z0m, z0s)
        tvs = ts * (1.0 + EPS_VI * q_atm) + EPS_VI * theta_scale * qs
        return Linv - KAPPA * G * tvs / (max(us, 1e-12) ** 2 * theta_scale)

    lo, hi = -50.0 / z_atm, 50.0 / z_atm
    if f(lo) * f(hi) > 0.0:
        return None
    return brentq(f, lo, hi, xtol=1e-15, rtol=8.9e-16)


# ---------------------------------------------------------------------------
# Tier 1: stability functions vs hand-computed published-form values
# ---------------------------------------------------------------------------


def test_psi_functions_match_hand_computed_values():
    """Library psi_m/psi_h (masked, polynomial-atan) against decimal
    literals evaluated by hand from the published Businger-Dyer forms."""
    cases_m = {
        -2.0: 1.4572913693307044,
        -1.0: 1.0837198392971996,
        -0.1: 0.2701510354575756,
        0.5: -2.35,
        1.0: -4.7,
        0.0: 0.0,
    }
    cases_h = {
        -2.0: 1.9712227048795363,
        -1.0: 1.4658305166908459,
        -0.1: 0.34656572384972767,
        0.5: -3.175675675675676,
        1.0: -6.351351351351352,
        0.0: 0.0,
    }
    for zeta, want in cases_m.items():
        got = float(sf.psi_m(jnp.float64(zeta)))
        assert got == pytest.approx(want, rel=1e-9), f"psi_m({zeta})"
    for zeta, want in cases_h.items():
        got = float(sf.psi_h(jnp.float64(zeta)))
        assert got == pytest.approx(want, rel=1e-9), f"psi_h({zeta})"


def test_arctan_kernel_matches_numpy():
    x = np.linspace(-8.0, 8.0, 1001)
    got = np.asarray(sf.arctan_kernel_safe(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.arctan(x), atol=2e-11)


# ---------------------------------------------------------------------------
# Tier 2: the fixed-point solver vs the Brent root solve over a state grid
# ---------------------------------------------------------------------------


def _state_grid():
    grid = []
    for u in [0.5, 2.0, 5.0, 10.0]:
        for dth in [-10.0, -2.0, -0.5, 0.0, 0.5, 2.0, 10.0]:
            for dq in [-0.005, 0.0, 0.003]:
                for z_atm in [2.0, 10.0]:
                    for z0 in [0.001, 0.01]:
                        grid.append((u, dth, dq, z_atm, z0))
    return grid


def test_most_solver_matches_independent_brent_solve():
    theta_scale, q_atm = 290.0, 0.01
    grid = _state_grid()
    arr = np.asarray(grid, dtype=np.float64)  # (N, 5): u, dth, dq, z_atm, z0
    import jax

    # one vectorized solver call over the whole state grid (the solver is
    # elementwise over columns — this is also how it runs in production)
    cond = jax.jit(sf.surface_conditions, static_argnums=0)(
        ps,
        u_atm=jnp.asarray(arr[:, 0]),
        theta_atm=jnp.asarray(290.0 + arr[:, 1]),
        q_atm=jnp.full(len(grid), q_atm),
        u_sfc=jnp.zeros(len(grid)),
        theta_sfc=jnp.full(len(grid), 290.0),
        q_sfc=jnp.asarray(q_atm - arr[:, 2]),
        z_atm=jnp.asarray(arr[:, 3]),
        z_0m=jnp.asarray(arr[:, 4]),
        z_0s=jnp.asarray(arr[:, 4]),
        theta_scale=jnp.full(len(grid), theta_scale),
    )
    us_all, ts_all, qs_all = (np.asarray(x) for x in cond["x_star"])
    res_all = np.asarray(cond["residual"])

    n_unstable = n_stable = n_neutral = 0
    for k, (u, dth, dq, z_atm, z0) in enumerate(grid):
        Linv_ref = solve_most_ref(u, dth, dq, z_atm, z0, z0, theta_scale, q_atm)
        if Linv_ref is None:
            continue  # critical-stability decoupling: MOST has no solution
        us_r, ts_r, qs_r = stars_ref(Linv_ref, u, dth, dq, z_atm, z0, z0)
        zeta = z_atm * Linv_ref
        tag = f"u={u} dth={dth} dq={dq} z={z_atm} z0={z0} zeta={zeta:.2f}"

        # solver convergence: bracket width + consistency defect
        assert res_all[k] < 1e-10, f"{tag}: residual={res_all[k]:.2e}"
        # agreement with the independent root solve
        assert us_all[k] == pytest.approx(us_r, rel=1e-8, abs=1e-12), f"{tag}: u*"
        assert ts_all[k] == pytest.approx(ts_r, rel=1e-8, abs=1e-12), f"{tag}: t*"
        assert qs_all[k] == pytest.approx(qs_r, rel=1e-8, abs=1e-14), f"{tag}: q*"
        if zeta < -1e-6:
            n_unstable += 1
        elif zeta > 1e-6:
            n_stable += 1
        else:
            n_neutral += 1
    # the comparison must actually cover all three regimes
    assert n_unstable >= 50, n_unstable
    assert n_stable >= 20, n_stable
    assert n_neutral >= 4, n_neutral


def test_most_solver_f32_rounds_reach_flux_precision():
    """The f32 solve (6 multisection rounds of 9x shrink on the
    sign-restricted |zeta| <= 50 bracket + one regula-falsi polish whose
    error is quadratic in the final 9.4e-5 width) must land every
    star/flux at the f32 machine level — verify the f32 solve agrees with
    the f64 Brent oracle to ~f32 representation accuracy over the full
    regime grid."""
    theta_scale, q_atm = 290.0, 0.01
    grid = _state_grid()
    arr = np.asarray(grid, dtype=np.float64)
    f32 = jnp.float32
    cond = sf.surface_conditions(
        ps,
        u_atm=jnp.asarray(arr[:, 0], f32),
        theta_atm=jnp.asarray(290.0 + arr[:, 1], f32),
        q_atm=jnp.full(len(grid), q_atm, f32),
        u_sfc=jnp.zeros(len(grid), f32),
        theta_sfc=jnp.full(len(grid), 290.0, f32),
        q_sfc=jnp.asarray(q_atm - arr[:, 2], f32),
        z_atm=jnp.asarray(arr[:, 3], f32),
        z_0m=jnp.asarray(arr[:, 4], f32),
        z_0s=jnp.asarray(arr[:, 4], f32),
        theta_scale=jnp.full(len(grid), theta_scale, f32),
    )
    us_all, ts_all, qs_all = (np.asarray(x) for x in cond["x_star"])
    assert us_all.dtype == np.float32
    n_checked = 0
    for k, (u, dth, dq, z_atm, z0) in enumerate(grid):
        Linv_ref = solve_most_ref(u, dth, dq, z_atm, z0, z0, theta_scale, q_atm)
        if Linv_ref is None:
            continue
        us_r, ts_r, qs_r = stars_ref(Linv_ref, u, dth, dq, z_atm, z0, z0)
        tag = f"u={u} dth={dth} dq={dq} z={z_atm} z0={z0}"
        assert us_all[k] == pytest.approx(us_r, rel=2e-5, abs=1e-7), f"{tag}: u*"
        assert ts_all[k] == pytest.approx(ts_r, rel=2e-5, abs=1e-6), f"{tag}: t*"
        assert qs_all[k] == pytest.approx(qs_r, rel=2e-5, abs=1e-9), f"{tag}: q*"
        n_checked += 1
    assert n_checked > 100


def test_neutral_limit_is_log_law():
    """At dtheta=dq=0 the solution is the neutral log law
    u* = kappa u / ln(z/z0) exactly."""
    u, z_atm, z0 = 5.0, 10.0, 0.01
    cond = sf.surface_conditions(
        ps,
        u_atm=jnp.float64(u),
        theta_atm=jnp.float64(290.0),
        q_atm=jnp.float64(0.01),
        u_sfc=jnp.float64(0.0),
        theta_sfc=jnp.float64(290.0),
        q_sfc=jnp.float64(0.01),
        z_atm=jnp.float64(z_atm),
        z_0m=jnp.float64(z0),
        z_0s=jnp.float64(z0),
        theta_scale=jnp.float64(290.0),
    )
    us = float(cond["x_star"][0])
    assert us == pytest.approx(KAPPA * u / np.log(z_atm / z0), rel=1e-12)
    assert float(cond["x_star"][1]) == pytest.approx(0.0, abs=1e-14)
    assert abs(float(cond["L_mo"])) > 1e10  # neutral: |L| -> inf


def test_decoupling_regime_flags_large_residual_with_finite_stars():
    """Critical-stability decoupling (very low wind under strong surface
    cooling): the consistency equation has no root with |zeta| <= 50, the
    independent Brent solve confirms it, and the solver must (a) return
    finite, clamped scales rather than NaN/inf, (b) flag the state through
    a LARGE residual (the regula-falsi polish is skipped when the final
    bracket holds no sign change — this exercises that fallback branch),
    while ordinary states on the same batch keep machine-level residuals."""
    # state 1: decoupling (u=0.05 m/s, dtheta=+15 K); state 2: ordinary
    u = jnp.asarray([0.05, 5.0], dtype=jnp.float64)
    dth = jnp.asarray([15.0, 2.0], dtype=jnp.float64)
    assert (
        solve_most_ref(0.05, 15.0, 0.0, 2.0, 0.01, 0.01, 290.0, 0.01)
        is None
    ), "oracle: the first state must actually be in the decoupling regime"
    cond = sf.surface_conditions(
        ps,
        u_atm=u,
        theta_atm=290.0 + dth,
        q_atm=jnp.full(2, 0.01, jnp.float64),
        u_sfc=jnp.zeros(2, jnp.float64),
        theta_sfc=jnp.full(2, 290.0, jnp.float64),
        q_sfc=jnp.full(2, 0.01, jnp.float64),
        z_atm=jnp.full(2, 2.0, jnp.float64),
        z_0m=jnp.full(2, 0.01, jnp.float64),
        z_0s=jnp.full(2, 0.01, jnp.float64),
        theta_scale=jnp.full(2, 290.0, jnp.float64),
    )
    us, ts, qs = (np.asarray(x) for x in cond["x_star"])
    res = np.asarray(cond["residual"])
    L = np.asarray(cond["L_mo"])
    assert np.all(np.isfinite(us)) and np.all(np.isfinite(ts))
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(L))
    # decoupled column: flagged; the regularized answer sits at the
    # stable bracket edge (zeta = z_atm/L = +50)
    assert res[0] > 1e-3, f"decoupling not flagged: residual={res[0]:.2e}"
    assert 2.0 * np.abs(1.0 / L[0]) == pytest.approx(50.0, rel=0.05)
    # ordinary column on the SAME batched solve: converged as usual
    assert res[1] < 1e-10, f"ordinary state degraded: residual={res[1]:.2e}"


# ---------------------------------------------------------------------------
# Tier 3: the full flux pipeline re-derived inline from the oracle scales
# ---------------------------------------------------------------------------


def _flux_model(top):
    from landhydrology import (
        Column,
        FreeDrainage,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology.models.soil import vanGenuchten

    return SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=10),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=1.56, alpha=3.6, Ksat=2.9e-7, theta_r=0.067
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=top,
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.43, S_s=1e-3),
    )


def test_flux_pipeline_against_independent_solver():
    """compute_turbulent_surface_fluxes vs the whole pipeline re-derived
    inline: saturation humidity from Clausius-Clapeyron, the matric-potential
    humidity correction, Brent-solved MOST scales, and the static-energy
    flux assembly (cf. boundary_conditions.jl:555-620)."""
    from landhydrology import PrescribedAtmosForcing

    u_atm, theta_atm, z_atm = 2.0, 298.0, 2.0
    rho_a, q_atm, theta_scale = 1.2, 0.008, 298.0
    top = PrescribedAtmosForcing(
        u_atm=u_atm,
        theta_atm=theta_atm,
        z_atm=z_atm,
        theta_scale=theta_scale,
        rho_a_sfc=rho_a,
        q_atm=q_atm,
    )
    model = _flux_model(top)
    sp = model.soil_param_set
    hm = model.hydrology_model.hydraulic_model

    for vartheta_l, T_sfc in [(0.30, 290.0), (0.12, 300.0), (0.43, 295.0)]:
        got_heat, got_evol = sf.compute_turbulent_surface_fluxes(
            model.energy_model,
            model.hydrology_model,
            model,
            jnp.float64(vartheta_l),
            jnp.float64(0.0),
            jnp.float64(T_sfc),
        )

        # --- independent re-derivation (plain numpy / scipy) ---
        # saturation humidity: Clausius-Clapeyron with constant heat caps
        dcp = ps.cp_v - ps.cp_l
        p_sat = (
            ps.press_triple
            * (T_sfc / ps.T_triple) ** (dcp / ps.R_v)
            * np.exp(
                (ps.LH_v0 - dcp * ps.T_0)
                / ps.R_v
                * (1.0 / ps.T_triple - 1.0 / T_sfc)
            )
        )
        q_sat = p_sat / (rho_a * ps.R_v * T_sfc)
        # soil-moisture correction exp(g psi / (R_v T))
        theta_l = min(vartheta_l, sp.nu)
        S_eff = min((theta_l - hm.theta_r) / (sp.nu - hm.theta_r), 1.0)
        m = 1.0 - 1.0 / hm.n
        if S_eff < 1.0:
            psi = -((S_eff ** (-1.0 / m) - 1.0) ** (1.0 / hm.n)) / hm.alpha
        else:
            psi = 0.0
        q_surf = q_sat * np.exp(G * psi / ps.R_v / T_sfc)

        Linv = solve_most_ref(
            u_atm,
            theta_atm - T_sfc,
            q_atm - q_surf,
            z_atm,
            sp.z_0m,
            sp.z_0s,
            theta_scale,
            q_atm,
        )
        assert Linv is not None
        us, ts, qs = stars_ref(
            Linv, u_atm, theta_atm - T_sfc, q_atm - q_surf,
            z_atm, sp.z_0m, sp.z_0s,
        )
        E = -rho_a * us * qs
        cpm = ps.cp_d + (ps.cp_v - ps.cp_d) * q_surf
        h_d = ps.cp_d * (T_sfc - ps.T_0) + ps.R_d * ps.T_0
        heat = (
            -cpm * rho_a * us * ts
            - h_d * E
            + (ps.cp_v * (T_sfc - ps.T_0) + ps.LH_v0) * E
        )
        e_vol = E / ps.rho_cloud_liq

        assert float(got_heat) == pytest.approx(heat, rel=1e-7), (
            f"heat flux at vartheta_l={vartheta_l}, T={T_sfc}"
        )
        assert float(got_evol) == pytest.approx(e_vol, rel=1e-7), (
            f"E at vartheta_l={vartheta_l}, T={T_sfc}"
        )


def test_illinois_method_matches_multisection_on_converged_columns():
    """The alternative f32 Illinois solver (fewer, thinner evaluations in
    a longer dependent chain; which of the two is faster on the device is
    open, ROADMAP Speed item 4) must agree with the multisection solve wherever both converge, and
    flag the same decoupling columns via the residual."""
    import landhydrology.models.soil.surface_fluxes as sf
    from landhydrology.constants import default_earth_param_set as ps

    rng = np.random.default_rng(0)
    n = 2048
    f32 = jnp.float32
    args = (
        jnp.asarray(rng.uniform(0.2, 8.0, n), dtype=f32),     # u_atm
        jnp.asarray(rng.uniform(280.0, 310.0, n), dtype=f32),  # theta_atm
        jnp.asarray(rng.uniform(0.001, 0.02, n), dtype=f32),   # q_atm
        jnp.zeros((n,), dtype=f32),                            # u_sfc
        jnp.asarray(rng.uniform(275.0, 315.0, n), dtype=f32),  # theta_sfc
        jnp.asarray(rng.uniform(0.001, 0.02, n), dtype=f32),   # q_sfc
        jnp.full((n,), 2.0, dtype=f32),                        # z_atm
        jnp.full((n,), 0.001, dtype=f32),                      # z_0m
        jnp.full((n,), 0.001, dtype=f32),                      # z_0s
        jnp.asarray(rng.uniform(280.0, 310.0, n), dtype=f32),  # theta_scale
    )
    assert sf._F32_METHOD == "multisection"  # the production default
    r_m = sf.surface_conditions(ps, *args)
    try:
        sf._F32_METHOD = "illinois"
        r_i = sf.surface_conditions(ps, *args)
    finally:
        sf._F32_METHOD = "multisection"

    rm = np.asarray(r_m["residual"])
    ri = np.asarray(r_i["residual"])
    ok = (rm < 1e-2) & (ri < 1e-2)
    assert ok.sum() > 0.7 * n  # most of the random grid converges
    for i in range(3):
        a = np.asarray(r_m["x_star"][i])[ok]
        b = np.asarray(r_i["x_star"][i])[ok]
        rel = np.abs(a - b) / (np.abs(a) + 1e-8)
        assert rel.max() < 1e-4, i
    # no convergence regression: wherever multisection converged,
    # Illinois (at its default iteration count) converged too
    assert not ((rm < 1e-2) & (ri >= 1e-2)).any()
