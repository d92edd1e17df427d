"""Differentiable-simulation tests: gradients flow through whole
integration loops (parameter calibration / adjoint sensitivity — the
payoff of the NaN-safe masked closures, SURVEY.md §7 hard part 2)."""

import jax
import jax.numpy as jnp
import numpy as np

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology.domains import make_function_space
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.rhs import make_rhs
from landhydrology.timestepping import SSPRK33

NZ, NSTEP, DT = 40, 200, 0.5


def _final_moisture(ksat):
    hm = vanGenuchten(n=3.0, alpha=2.7, Ksat=ksat, theta_r=0.05)
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.25)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": jnp.full_like(z, 0.1),
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    stepper = SSPRK33()

    def body(carry, _):
        Y, t = carry
        return (stepper.step(rhs, Y, Ya, t, jnp.asarray(DT)), t + DT), None

    (Yf, _), _ = jax.lax.scan(body, (Y, jnp.asarray(0.0)), None, length=NSTEP)
    # depth-integrated moisture: sensitive to how fast the front moves
    return jnp.sum(Yf["soil"]["vartheta_l"]) / NZ


def test_grad_through_simulation_matches_finite_difference():
    ksat0 = 1e-5
    f = jax.jit(_final_moisture)
    g = jax.jit(jax.grad(_final_moisture))

    grad_ad = float(g(ksat0))
    assert np.isfinite(grad_ad)
    assert grad_ad > 0  # more conductive soil wets faster

    eps = 1e-8
    fd = (float(f(ksat0 + eps)) - float(f(ksat0 - eps))) / (2 * eps)
    np.testing.assert_allclose(grad_ad, fd, rtol=2e-4)


def test_grad_wrt_initial_state():
    """Adjoint wrt the full initial state (data assimilation shape)."""

    def loss(theta0_scalar):
        hm = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
        model = SoilModel(
            domain=Column(zlim=(-1.0, 0.0), nelements=NZ),
            energy_model=PrescribedTemperatureModel(),
            hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.25)),
                bottom=SoilComponentBC(hydrology=FreeDrainage()),
            ),
            soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
        )
        Y, Ya = initialize_states(
            model,
            lambda z, m: {
                "vartheta_l": jnp.full_like(z, theta0_scalar),
                "theta_i": jnp.zeros_like(z),
            },
            0.0,
        )
        grid = make_function_space(model.domain, jnp.float64)
        rhs = make_rhs(model, grid)
        stepper = SSPRK33()

        def body(carry, _):
            Y, t = carry
            return (stepper.step(rhs, Y, Ya, t, jnp.asarray(DT)), t + DT), None

        (Yf, _), _ = jax.lax.scan(body, (Y, jnp.asarray(0.0)), None, length=50)
        return jnp.mean((Yf["soil"]["vartheta_l"] - 0.2) ** 2)

    g = float(jax.grad(loss)(0.12))
    assert np.isfinite(g)
    assert g < 0  # wetter IC moves the profile toward the 0.2 target


def test_gradient_through_segment_matches_xla_and_fd():
    """jax.grad differentiates make_segment_run's fori_loop natively and
    matches BOTH the step-by-step gradient and central finite
    differences."""
    from landhydrology import (
        Column,
        FreeDrainage,
        PrescribedTemperatureModel,
        SoilColumnBC,
        SoilComponentBC,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology.domains import make_function_space
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.rhs import make_rhs
    from landhydrology.segment import make_segment_run
    from landhydrology.timestepping import SSPRK33

    NZ, NCOL, DT, N = 8, 16, 20.0, 6
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(-1e-7)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    Y0, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": 0.2 + 0.03 * jnp.sin(3.0 * z) + 0 * z,
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    run = make_segment_run(model, SSPRK33(), dt=DT, steps_per_call=N)

    def loss_segment(v0):
        Y = {"soil": dict(Y0["soil"], vartheta_l=v0)}
        Yf = run(Y, 0.0)
        return jnp.mean((Yf["soil"]["vartheta_l"] - 0.25) ** 2)

    grid = make_function_space(model.domain, jnp.float64)
    rhs = make_rhs(model, grid)
    stepper = SSPRK33()

    def loss_xla(v0):
        Y = {"soil": dict(Y0["soil"], vartheta_l=v0)}
        t = jnp.asarray(0.0)
        for _ in range(N):
            Y = stepper.step(rhs, Y, Ya, t, jnp.asarray(DT))
            t = t + DT
        return jnp.mean((Y["soil"]["vartheta_l"] - 0.25) ** 2)

    v0 = Y0["soil"]["vartheta_l"]
    # primals agree
    np.testing.assert_allclose(
        float(loss_segment(v0)), float(loss_xla(v0)), rtol=1e-12
    )
    g_segment = jax.grad(loss_segment)(v0)
    g_xla = jax.grad(loss_xla)(v0)
    np.testing.assert_allclose(
        np.asarray(g_segment), np.asarray(g_xla), rtol=1e-10, atol=1e-16
    )
    # central finite differences on a few random directions
    rng = np.random.default_rng(0)
    for _ in range(3):
        d = jnp.asarray(rng.standard_normal(v0.shape))
        d = d / jnp.linalg.norm(d)
        eps = 1e-6
        fd = (loss_segment(v0 + eps * d) - loss_segment(v0 - eps * d)) / (2 * eps)
        ad = jnp.vdot(g_segment, d)
        np.testing.assert_allclose(float(ad), float(fd), rtol=5e-5, atol=1e-12)


def test_land_segment_gradient_matches_xla_scan():
    """The LandModel segment (rain + pond + MOST + coupled energy) is
    differentiable: d loss / d (initial pond, initial moisture) through
    make_segment_run equals the gradient through the XLA scan."""
    import dataclasses

    from landhydrology import (
        Column,
        PrescribedAtmosForcing,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology.constants import default_earth_param_set as ps
    from landhydrology.models.land import (
        LandModel,
        SurfaceWaterModel,
        initialize_states as land_init,
    )
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology.segment import make_segment_run
    from landhydrology.timestepping import SSPRK33

    NZ, NCOL, DT, N = 8, 16, 2.0, 6
    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7,
                                         theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(
                hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=lambda t: 6e-6 + 0.0 * t, tau_pond=120.0,
        h_evap_smoothing=1e-4))

    def ic(z, m):
        th = 0.2 + 0.02 * jnp.sin(3.0 * z) + jnp.zeros((NZ, NCOL))
        ti = jnp.zeros_like(th)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, 290.0 + 0 * th, ps),
        }

    Y0, Ya = land_init(land, ic, 0.0, h_s0=1e-4)
    run = make_segment_run(land, SSPRK33(), dt=DT, steps_per_call=N)
    rhs = land.make_rhs()
    stepper = SSPRK33()

    def _with(p):
        h_s, v = p
        return {
            "soil": dict(Y0["soil"], vartheta_l=v),
            "surface": {"h_s": h_s},
        }

    def loss_of(Yf):
        return jnp.mean(Yf["surface"]["h_s"] ** 2) + jnp.mean(
            (Yf["soil"]["vartheta_l"] - 0.25) ** 2
        )

    def loss_segment(p):
        return loss_of(run(_with(p), 0.0))

    def loss_scan(p):
        def body(carry, _):
            Yc, t = carry
            return (stepper.step(rhs, Yc, Ya, t, jnp.asarray(DT)), t + DT), None

        (Yf, _), _ = jax.lax.scan(
            body, (_with(p), jnp.asarray(0.0)), None, length=N
        )
        return loss_of(Yf)

    p0 = (Y0["surface"]["h_s"], Y0["soil"]["vartheta_l"])
    np.testing.assert_allclose(
        float(loss_segment(p0)), float(loss_scan(p0)), rtol=1e-12
    )
    g_seg = jax.grad(loss_segment)(p0)
    g_scan = jax.grad(loss_scan)(p0)
    assert float(jnp.max(jnp.abs(g_seg[0]))) > 0.0
    for a, b in zip(g_seg, g_scan):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-16
        )


def test_segment_dt_gradient_not_silently_zero():
    """The segment run propagates real cotangents for the traced
    ``dt_run``: d loss / d dt matches finite differences."""
    from landhydrology import (
        Column,
        FreeDrainage,
        PrescribedTemperatureModel,
        SoilColumnBC,
        SoilComponentBC,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology.models.soil import vanGenuchten
    from landhydrology.segment import make_segment_run
    from landhydrology.timestepping import SSPRK33

    NZ, NCOL = 8, 16
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(-1e-7)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    Y, Ya = initialize_states(
        model,
        lambda z, m: {
            "vartheta_l": 0.2 + 0.03 * jnp.sin(3.0 * z) + 0 * z,
            "theta_i": jnp.zeros_like(z),
        },
        0.0,
    )
    run = make_segment_run(model, SSPRK33(), dt=20.0, steps_per_call=4)

    def loss(dt):
        return jnp.mean(run(Y, 0.0, dt_run=dt)["soil"]["vartheta_l"] ** 2)

    g = float(jax.grad(loss)(jnp.float64(20.0)))
    eps = 1e-3
    fd = (float(loss(jnp.float64(20.0 + eps)))
          - float(loss(jnp.float64(20.0 - eps)))) / (2 * eps)
    assert g != 0.0
    np.testing.assert_allclose(g, fd, rtol=1e-5)
