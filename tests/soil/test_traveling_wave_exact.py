"""Exact continuum-solution anchor: the gravity-driven traveling wave.

The reference anchors infiltration against an external dataset (Bonan 2019
CSV, unreachable here).  This module anchors the same sand-infiltration
physics against something stronger than digitized figure points: the
**exact traveling-wave solution of the continuum Richards equation**
(Philip 1957; standard in the infiltration literature).  For a wetting
wave connecting moisture ``th0`` (ahead) to ``th1`` (behind), substituting
``theta(z, t) = Theta(z + c t)`` into Richards' equation and integrating
once gives the closed-form implicit profile

    xi(theta) = integral  D(u) / [c (u - th0) - (K(u) - K(th0))]  du,
    c = (K(th1) - K(th0)) / (th1 - th0)            (Rankine-Hugoniot),

with ``D = K dpsi/dtheta`` the moisture diffusivity.  The quadrature is
evaluated here with scipy on the closed-form van Genuchten/Mualem
functions — no framework code, no spatial or temporal discretization, so
the comparison cannot share discretization errors with the solver.  The
test initializes the column ON the exact wave and checks the solver
propagates it at exactly speed c with an unchanged shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import cumulative_trapezoid, quad

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedTemperatureModel,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33

# Haverkamp et al. (1977) sand in van Genuchten form, as in the reference's
# infiltration test (richards_equation.jl:100-112)
NU, THETA_R = 0.287, 0.075
VG_N, VG_ALPHA = 3.96, 2.7
VG_M = 1.0 - 1.0 / VG_N
KSAT = 34.0 / 3600.0 / 100.0
TH0, TH1 = 0.10, 0.26  # wave states: dry ahead, wet behind

NZ, ZMIN = 300, -2.0
DZ = -ZMIN / NZ
Z_FRONT0 = -0.5  # initial wave center
T_RUN = 1800.0


def _K(th):
    se = np.clip((th - THETA_R) / (NU - THETA_R), 1e-12, 1.0)
    return KSAT * np.sqrt(se) * (1.0 - (1.0 - se ** (1.0 / VG_M)) ** VG_M) ** 2


def _psi(th):
    se = np.clip((th - THETA_R) / (NU - THETA_R), 1e-12, 1.0 - 1e-15)
    return -((se ** (-1.0 / VG_M) - 1.0) ** (1.0 / VG_N)) / VG_ALPHA


def _D(th):
    dth = 1e-7
    return _K(th) * (_psi(th + dth) - _psi(th - dth)) / (2.0 * dth)


def _exact_wave():
    """(theta grid, xi(theta), wave speed c) from the closed-form integral."""
    K0, K1 = _K(TH0), _K(TH1)
    c = (K1 - K0) / (TH1 - TH0)

    def integrand(th):
        return _D(th) / (c * (th - TH0) - (_K(th) - K0))

    eps = 1e-5
    th = np.linspace(TH0 + eps, TH1 - eps, 40001)
    xi = cumulative_trapezoid(integrand(th), th, initial=0.0)
    # anchor xi = 0 at the mid-moisture point
    th_mid = 0.5 * (TH0 + TH1)
    xi = xi - np.interp(th_mid, th, xi)

    # self-validate the trapezoid quadrature against adaptive scipy quad
    for th_probe in (0.13, 0.18, 0.22, 0.25):
        ref, _ = quad(integrand, th_mid, th_probe, limit=200)
        got = float(np.interp(th_probe, th, xi))
        assert abs(got - ref) < 1e-8, (th_probe, got, ref)
    return th, xi, c


@pytest.mark.slow
def test_framework_propagates_exact_traveling_wave():
    th_grid, xi, c = _exact_wave()

    def theta_of_xi(x):
        return np.interp(x, xi, th_grid, left=TH0, right=TH1)

    model = SoilModel(
        domain=Column(zlim=(ZMIN, 0.0), nelements=NZ),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=VG_N, alpha=VG_ALPHA, Ksat=KSAT, theta_r=THETA_R
            )
        ),
        boundary_conditions=SoilColumnBC(
            # behind the wave the state is th1 (top Dirichlet); ahead of it
            # free drainage carries exactly the wave's flux -K(th0)
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: TH1)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=NU, S_s=1e-3),
    )

    def ic(z, m):
        th = jnp.asarray(
            theta_of_xi(np.asarray(z).ravel() - Z_FRONT0)
        ).reshape(z.shape)
        return {"vartheta_l": th, "theta_i": jnp.zeros_like(z)}

    Y, Ya = initialize_states(model, ic, 0.0)
    sim = Simulation(
        model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=0.2, tspan=(0.0, T_RUN)
    )
    sim.run()

    z = np.asarray(Ya["zc"]).ravel()
    got = np.asarray(sim.Y["soil"]["vartheta_l"])
    want = theta_of_xi(z - (Z_FRONT0 - c * T_RUN))

    # the wave moved ~0.54 m (~80 cells); shape and position must hold
    assert c * T_RUN > 0.5
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 2.5e-3, rmse
    assert float(np.abs(got - want).max()) < 2e-2  # sharp-front cell
    # interior (away from the top Dirichlet's asymptotic-tail mismatch)
    mask = z < -0.3
    assert float(np.sqrt(np.mean((got[mask] - want[mask]) ** 2))) < 2e-3

    # front position (mid-moisture crossing) to within one cell
    th_mid = 0.5 * (TH0 + TH1)
    z_sim = float(np.interp(th_mid, got, z))  # got is monotone in z
    z_exact = Z_FRONT0 - c * T_RUN
    assert abs(z_sim - z_exact) < DZ, (z_sim, z_exact)

    # Rankine-Hugoniot flux check: behind/ahead fluxes match the wave
    assert got[-1] == pytest.approx(TH1, abs=2e-3)
    assert got[0] == pytest.approx(TH0, abs=1e-6)
