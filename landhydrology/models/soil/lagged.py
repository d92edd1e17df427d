"""Lagged-coefficient stepping: ``SoilModel(coefficient_update="step")``.

The coupled sweep's arithmetic is dominated by its pointwise closures,
and the largest op-count lever is that every nonlinear coefficient — hydraulic conductivity K, thermal conductivity kappa, the
advected liquid internal energy rho_e_int_l, the volumetric heat capacity
rho_c_s (the reference recomputes the same set inside every ``rhs!``,
``/root/reference/src/SoilModel/right_hand_side.jl:291-312``) — is
re-evaluated in all 3 SSPRK33 stages.  This module evaluates them ONCE per
time step, at the step's initial state, and holds them fixed across the
stages; the per-stage work shrinks to the state-gradient drivers (the
pressure head psi via the retention curve, the temperature diagnosis
through the *frozen* heat capacity), the stencil sweeps, and the boundary
fluxes.

Accuracy class: identical to the other step-level splittings in this
repo (``LandModel(surface_update="step")``, the lateral Lie split) — the
coefficients move O(dt) per step, so freezing them perturbs the tendency
by O(dt) and the trajectory deviation from stage-level semantics is first
order in dt (measured in
``tests/soil/test_lagged_coefficients.py::test_lagged_first_order``),
sitting far below the discretization error at diffusion-CFL-limited dt.
Conservation is untouched: the lagged rhs is still in exact flux
(divergence) form, so mass/energy totals close identically.

When to use: production sweeps where throughput matters and dt is pinned
by the diffusion CFL (the coefficients then move slowly relative to dt);
keep the default ``"stage"`` for convergence studies at large dt or when
matching the reference's stage-level semantics bit-for-bit.

Enforced by every driver (XLA scan, segment runner, pjit, shard_map,
segment-sharded, forced driver, adaptive) via
:class:`LaggedCoefficientStepper` / the land policy stepper — the same
"no engine silently drops a configured policy" bar set for freeze-thaw
and the frozen surface exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from landhydrology.domains import ColumnGrid, make_function_space
from landhydrology.models.soil import heat as sh
from landhydrology.models.soil import water as sw
from landhydrology.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology.models.soil.rhs import (
    _add_lateral,
    _face_fluxes,
    energy_center_fields,
    hydrology_center_fields,
    make_update_aux,
)
from landhydrology.ops.stencil import diffusive_flux_faces, div_f2c

Array = Any


def make_coefficient_fns(model: SoilModel, grid: ColumnGrid | None = None):
    """``(compute_coeffs, rhs_with_coeffs)`` for the model's component
    combination:

    - ``compute_coeffs(Y, Ya, t) -> C`` evaluates the laggable nonlinear
      coefficient fields at a state (the expensive pointwise closures);
    - ``rhs_with_coeffs(C, Y, Ya, t) -> dY`` is the tendency with those
      coefficients held fixed — the flux-form spatial discretization of
      ``rhs.py`` with the closure sweep replaced by ``C`` lookups.

    ``rhs_with_coeffs(compute_coeffs(Y, Ya, t), Y, Ya, t)`` differs from
    ``make_rhs(model)(Y, Ya, t)`` only in floating-point association (the
    temperature diagnosis multiplies by the stored reciprocal heat
    capacity instead of dividing), so stage-level use would reproduce the
    plain rhs to roundoff; the point is evaluating ``compute_coeffs`` once
    per step (:class:`LaggedCoefficientStepper`).
    """
    if grid is None:
        grid = make_function_space(model.domain, model.float_dtype)
    name = model.name
    dz = grid.dz
    sp = model.soil_param_set
    param_set = model.earth_param_set
    energy = model.energy_model
    hydrology = model.hydrology_model
    update_aux_en = make_update_aux(energy)
    update_aux_hydr = make_update_aux(hydrology)

    def update_aux(Ya, t):
        Ya = update_aux_en(Ya, t, name)
        return update_aux_hydr(Ya, t, name)

    dyn_energy = isinstance(energy, SoilEnergyModel)
    dyn_hydrology = isinstance(hydrology, SoilHydrologyModel)
    no_ice = model.assume_no_ice

    if not dyn_energy and not dyn_hydrology:
        raise ValueError(
            "coefficient_update='step' requires at least one dynamic "
            "component (the fully prescribed model has no coefficients to "
            "lag)"
        )

    # --- the laggable coefficient sweep (once per step) ---

    def compute_coeffs(Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux(Ya, t)
        if dyn_hydrology:
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
        else:
            ref = Y[name]["rho_e_int"]
            vartheta_l = jnp.broadcast_to(Ya[name]["vartheta_l"], ref.shape)
            theta_i = jnp.broadcast_to(Ya[name]["theta_i"], ref.shape)
        nu_eff = sp.nu if no_ice else sp.nu - theta_i
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        C: dict = {}
        if dyn_energy:
            T, kappa, rho_c_s = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=Y[name]["rho_e_int"]
            )
            C["kappa"] = kappa
            C["rho_c_s"] = rho_c_s
            C["inv_rho_c_s"] = 1.0 / rho_c_s
        else:
            T = jnp.broadcast_to(Ya[name]["T"], vartheta_l.shape)
        if dyn_hydrology:
            _, K, _ = hydrology_center_fields(model, vartheta_l, theta_i, T)
            C["K"] = K
            if dyn_energy:
                # the advected-energy coefficient is lagged as the product
                C["KE"] = sh.volumetric_internal_energy_liq(T, param_set) * K
        return C

    # --- the per-stage tendency with frozen coefficients ---

    def _diagnose_T(C, rho_e_int, theta_i):
        """T through the FROZEN heat capacity (reciprocal-multiply): the
        latent-heat offset stays live with theta_i."""
        if no_ice:
            return param_set.T_0 + rho_e_int * C["inv_rho_c_s"]
        return param_set.T_0 + (
            rho_e_int + theta_i * param_set.rho_cloud_ice * param_set.LH_f0
        ) * C["inv_rho_c_s"]

    def rhs_with_coeffs(C: dict, Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux(Ya, t)
        zc = Ya["zc"]
        out: dict = {}

        if dyn_hydrology:
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
        else:
            ref = Y[name]["rho_e_int"]
            vartheta_l = jnp.broadcast_to(Ya[name]["vartheta_l"], ref.shape)
            theta_i = jnp.broadcast_to(Ya[name]["theta_i"], ref.shape)

        if dyn_energy:
            rho_e_int = Y[name]["rho_e_int"]
            T = _diagnose_T(C, rho_e_int, theta_i)
        else:
            T = jnp.broadcast_to(
                Ya[name]["T"], vartheta_l.shape
            )

        X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
        required = ()
        if dyn_hydrology:
            required += ("f_vartheta_l",)
        if dyn_energy:
            required += ("f_rho_e_int",)
        fluxes = _face_fluxes(model, grid, X, t, required=required)

        if dyn_hydrology:
            nu_eff = sp.nu if no_ice else sp.nu - theta_i
            psi = sw.pressure_head(
                hydrology.hydraulic_model, vartheta_l, nu_eff, sp.S_s
            )
            h = psi + zc
            water_flux = diffusive_flux_faces(C["K"], h, dz)
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            d_vartheta_l = _add_lateral(model, d_vartheta_l, h, dz)
            out["vartheta_l"] = d_vartheta_l
            out["theta_i"] = jnp.zeros_like(theta_i)

        if dyn_energy:
            energy_flux = diffusive_flux_faces(C["kappa"], T, dz)
            if dyn_hydrology:
                energy_flux = energy_flux + diffusive_flux_faces(C["KE"], h, dz)
            d_rho_e_int = -div_f2c(
                energy_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )
            out["rho_e_int"] = d_rho_e_int

        # freeze-thaw rate sources stay live per stage (they are the phase
        # dynamics, not a coefficient); only rho_c_s inside them is frozen
        if dyn_hydrology and dyn_energy:
            from landhydrology.models.soil.freeze_thaw import (
                EquilibriumFreezeThaw as _EqFT,
                phase_change_sources,
            )

            if model.freeze_thaw is not None and not isinstance(
                model.freeze_thaw, _EqFT
            ):
                theta_l = sw.volumetric_liquid_fraction(
                    vartheta_l, sp.nu - theta_i
                )
                src_l, src_i = phase_change_sources(
                    model.freeze_thaw,
                    hydrology.hydraulic_model,
                    theta_l,
                    theta_i,
                    T,
                    sp.nu,
                    C["rho_c_s"],
                    param_set,
                )
                out["vartheta_l"] = out["vartheta_l"] + src_l
                out["theta_i"] = out["theta_i"] + src_i

        return {name: out}

    return compute_coeffs, rhs_with_coeffs


@dataclasses.dataclass(frozen=True)
class LaggedCoefficientStepper:
    """Stepper decorator realizing ``SoilModel(coefficient_update="step")``:
    evaluate the nonlinear coefficient sweep ONCE at the step's initial
    state and drive the inner stepper with the frozen-coefficient rhs.

    Like :class:`~landhydrology.models.land.FrozenExchangeStepper`,
    the wrapped ``step`` IGNORES the rhs argument it is handed and drives
    the coefficient-parametrized rhs directly — by construction the two
    trace the same physics, and ignoring the argument guarantees no
    stage-level coefficient sweep sneaks back in.  The ``model``/``grid``
    fields follow the rebind protocol (``_rebind`` in the segment runner
    and the shard_map path retargets them to row- or shard-local
    models).
    """

    inner: Any
    model: Any
    grid: Any = None

    @property
    def stages(self) -> int:
        return getattr(self.inner, "stages", 1)

    @property
    def order(self) -> int:
        return getattr(self.inner, "order", 1)

    @property
    def unconditionally_stable(self) -> bool:
        return getattr(self.inner, "unconditionally_stable", False)

    def step(self, rhs, Y, Ya, t, dt):
        grid = self.grid
        if grid is None:
            grid = make_function_space(
                self.model.domain, self.model.float_dtype
            )
        compute_coeffs, rhs_c = make_coefficient_fns(self.model, grid)
        C = compute_coeffs(Y, Ya, t)

        def frozen_rhs(Y_, Ya_, t_):
            return rhs_c(C, Y_, Ya_, t_)

        return self.inner.step(frozen_rhs, Y, Ya, t, dt)


def _chain_contains(stepper, cls) -> bool:
    st = stepper
    while st is not None:
        if isinstance(st, cls):
            return True
        st = getattr(st, "inner", None)
    return False


def wrap_stepper_for_soil(stepper, model, grid=None):
    """Apply a plain SoilModel's configured coefficient-update policy to a
    stepper (idempotent; no-op for ``coefficient_update="stage"`` and for
    non-soil models).  LandModel composition is handled by the land policy
    stepper (``models/land.py``), not here."""
    if (
        isinstance(model, SoilModel)
        and getattr(model, "coefficient_update", "stage") == "step"
        and not _chain_contains(stepper, LaggedCoefficientStepper)
    ):
        return LaggedCoefficientStepper(inner=stepper, model=model, grid=grid)
    return stepper
