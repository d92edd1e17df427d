"""Simulation driver — jit-compiled time integration with strided saving.

Replacement for the reference's Simulations layer
(``/root/reference/src/Simulations/simulation.jl``): instead of wrapping a
DiffEq integrator object, a :class:`Simulation` compiles the whole stepping
loop into one ``lax.scan`` program:

- outer scan over save intervals, inner scan over steps (the reference's
  ``saveat`` machinery, ``richards_equation.jl:67``);
- prescribed-field updates happen inside the rhs (``make_update_aux``), so
  the auxiliary state is loop-invariant and stays resident on device;
- the saved trajectory is a stacked pytree (leading axis = save index),
  the jit analogue of DiffEq's ``sol.u``.

``step()``/``run()`` mirror the reference's ``step!``/``run!``
(``simulation.jl:79-87``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from landhydrology.models.soil.rhs import make_rhs
from landhydrology.segment import reject_removed_options
from landhydrology.timestepping import AbstractTimestepper, SSPRK33

Array = Any


@dataclasses.dataclass
class Solution:
    """Saved trajectory: ``ts`` (n_saved,) and ``us`` — a pytree stacked
    along a leading save axis.  ``us[k]``-style access is provided by
    :meth:`state`."""

    ts: Array
    us: dict

    def __len__(self) -> int:
        return int(self.ts.shape[0])

    def state(self, k: int) -> dict:
        """The k-th saved state (supports negative indices)."""
        return jax.tree_util.tree_map(lambda x: x[k], self.us)


class Simulation:
    """Wraps a model + stepper + state and compiles the integration loop
    (cf. ``simulation.jl:11-73``).

    Parameters mirror the reference constructor: ``Y_init``/``Ya_init`` may
    be ``None`` to use the model's default ICs (``simulation.jl:46-53``).
    ``saveat`` is a time interval; it must be (close to) an integer multiple
    of ``dt``.  The initial state is always the first saved entry, matching
    DiffEq's saveat semantics.
    """

    def __init__(
        self,
        model,
        stepper: AbstractTimestepper = SSPRK33(),
        *,
        Y_init: Optional[dict] = None,
        Ya_init: Optional[dict] = None,
        dt: float,
        tspan: tuple,
        saveat: Optional[float] = None,
        callbacks=None,
        **removed,
    ):
        reject_removed_options("Simulation", removed)
        if Y_init is None:
            Y_init, Ya_init = model.default_initial_conditions()
        elif Ya_init is None:
            # derive the auxiliary state from the model (it depends only on
            # the grid and prescribed profiles)
            from landhydrology.domains import make_function_space
            from landhydrology.models.soil.initial_conditions import (
                initialize_auxiliary,
            )

            soil_like = getattr(model, "soil", model)
            if not hasattr(soil_like, "domain"):
                raise ValueError(
                    "Ya_init is required for this model type (cannot derive "
                    "auxiliary state without a column domain)"
                )
            grid0 = make_function_space(soil_like.domain, model.float_dtype)
            Ya_init = initialize_auxiliary(
                soil_like, jnp.asarray(tspan[0], dtype=model.float_dtype), grid0.zc
            )
        self.model = model
        # EquilibriumFreezeThaw models project onto phase equilibrium after
        # every step: wrap any stepper transparently (idempotent no-op for
        # other configs).  Composed models (LandModel) carry the freeze-thaw
        # config on their soil component — the projection acts on Y['soil']
        # and preserves the other state groups, so the same wrap applies.
        ft_owner = getattr(model, "soil", model)
        if getattr(ft_owner, "freeze_thaw", None) is not None:
            from landhydrology.models.soil.freeze_thaw import (
                wrap_stepper_with_projection,
            )

            stepper = wrap_stepper_with_projection(stepper, ft_owner)
        # Step-level policies — LandModel(surface_update="step") freezes the
        # surface exchange (MOST solve, potential infiltration) and
        # SoilModel(coefficient_update="step") freezes the nonlinear
        # coefficient sweep across the RK stages of each step.  Outermost
        # wrap — the frozen rhs flows through any projection stepper
        # unchanged.
        if hasattr(model, "surface"):  # LandModel: both policies in one wrap
            from landhydrology.models.land import wrap_stepper_for_land

            stepper = wrap_stepper_for_land(stepper, model)
        else:
            from landhydrology.models.soil.lagged import (
                wrap_stepper_for_soil,
            )

            stepper = wrap_stepper_for_soil(stepper, model)
        self.stepper = stepper
        self.dt = float(dt)
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.Y = Y_init
        self.Ya = Ya_init
        self.t = self.tspan[0]
        self.saveat = None if saveat is None else float(saveat)
        #: user callbacks ``fn(Y, t) -> Optional[Y]`` invoked host-side at
        #: every save point (the reference's DiscreteCallback machinery,
        #: ``simulation.jl:16-21,64-70``); a returned dict replaces the
        #: state (discrete interventions — e.g. precipitation resets)
        self.callbacks = list(callbacks) if callbacks else []
        # AbstractModel protocol: any model exposing make_rhs() plugs in
        # (SoilModel, LandModel, ...); fall back to the soil builder
        self._rhs = (
            model.make_rhs() if hasattr(model, "make_rhs") else make_rhs(model)
        )
        self._warn_if_cfl_unstable(model)

        dtype = model.float_dtype
        rhs, stepper_, dt_ = self._rhs, self.stepper, self.dt

        @jax.jit
        def _step(Y, Ya, t):
            return stepper_.step(rhs, Y, Ya, t, jnp.asarray(dt_, dtype=dtype))

        self._step_fn = _step

        self._dtype = dtype
        self._run_cache: dict = {}

    def _warn_if_cfl_unstable(self, model) -> None:
        """Warn at construction when the explicit dt exceeds the estimated
        Richards CFL limit (the saturated-compressibility regime makes this
        failure mode silent and violent — see diagnostics.explicit_dt_limit).
        Implicit steppers are unconditionally stable; skip them."""
        import warnings

        from landhydrology.models.soil.model import (
            SoilHydrologyModel,
            SoilModel as _SoilModel,
        )

        if not isinstance(model, _SoilModel):
            return
        if not isinstance(model.hydrology_model, SoilHydrologyModel):
            return
        if getattr(self.stepper, "unconditionally_stable", False):
            return
        try:
            from landhydrology.diagnostics import explicit_dt_limit

            limit = float(explicit_dt_limit(model, self.Y))
        except Exception:
            return  # traced/abstract state or exotic config: skip the check
        # 4x margin: the estimator is a linearization at the initial state;
        # warn only on clear violations (the silent-blow-up regime)
        if self.dt > 4.0 * limit:
            warnings.warn(
                f"dt={self.dt:g} exceeds ~4x the estimated explicit Richards "
                f"CFL limit ({limit:.3g}s) for this initial state "
                "(saturated-zone diffusivity is K/S_s); expect instability — "
                "reduce dt or use an implicit stepper from "
                "landhydrology.imex",
                RuntimeWarning,
                stacklevel=3,
            )

    def _make_run_fn(self, n_saves: int, save_every: int, rem: int):
        """Compiled runner for a given (saves x stride + remainder) split;
        memoized so repeated runs reuse the executable."""
        key = (n_saves, save_every, rem)
        if key in self._run_cache:
            return self._run_cache[key]
        rhs, stepper_, dt_, dtype = self._rhs, self.stepper, self.dt, self._dtype

        def _run(Y, Ya, t0):
            dt_a = jnp.asarray(dt_, dtype=dtype)

            def inner(carry, _):
                Y, t = carry
                return (stepper_.step(rhs, Y, Ya, t, dt_a), t + dt_a), None

            def outer(carry, _):
                carry, _ = jax.lax.scan(inner, carry, None, length=save_every)
                Y, t = carry
                return carry, (t, Y)

            carry = (Y, jnp.asarray(t0, dtype=dtype))
            carry, (ts, us) = jax.lax.scan(outer, carry, None, length=n_saves)
            if rem:
                carry, _ = jax.lax.scan(inner, carry, None, length=rem)
            Yf, tf = carry
            return Yf, tf, ts, us

        fn = jax.jit(_run)
        self._run_cache[key] = fn
        return fn

    def _run_segmented(self, Y0, t0, n_saves, save_every, rem):
        """Host-segmented loop invoking callbacks at each save point."""
        segment = self._make_run_fn(1, save_every, 0)
        Y, t = Y0, jnp.asarray(t0, dtype=self._dtype)
        ts_list, us_list = [], []
        for _ in range(n_saves):
            Y, t, _, _ = segment(Y, self.Ya, t)
            for cb in self.callbacks:
                replaced = cb(Y, float(t))
                if replaced is not None:
                    Y = replaced
            ts_list.append(t)
            us_list.append(Y)
        if rem:
            tail = self._make_run_fn(1, rem, 0)
            Y, t, _, _ = tail(Y, self.Ya, t)
        ts = jnp.stack(ts_list) if ts_list else jnp.zeros((0,), self._dtype)
        us = (
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *us_list)
            if us_list
            else jax.tree_util.tree_map(lambda x: jnp.zeros((0, *x.shape), x.dtype), Y)
        )
        return Y, t, ts, us

    # -- reference step!/run! analogues (simulation.jl:79-87) --

    def step(self) -> None:
        """Advance one time step (cf. ``step!``, ``simulation.jl:79-80``)."""
        self.Y = self._step_fn(self.Y, self.Ya, jnp.asarray(self.t))
        self.t += self.dt

    def run(self, sink=None) -> Solution:
        """Integrate to the end of ``tspan`` and return the saved trajectory
        (cf. ``run!``, ``simulation.jl:86-87``).  Continues from the current
        (Y, t) to ``tspan[1]`` exactly (DiffEq ``solve!`` semantics); stores
        the result on ``self.sol`` as well.

        ``sink``: optional
        :class:`~landhydrology.runtime.TrajectorySink` — every saved
        state is streamed to it (async on the native writer thread).

        With ``callbacks`` set, the loop is segmented at save points and
        each callback runs host-side on (Y, t); a returned dict replaces
        the state."""
        Y0, t0 = self.Y, self.t
        n_steps = max(0, int(round((self.tspan[1] - t0) / self.dt)))
        if self.saveat is not None:
            save_every = max(1, int(round(self.saveat / self.dt)))
        else:
            save_every = max(1, n_steps)
        n_saves, rem = divmod(n_steps, save_every)
        self._rem = rem
        if self.callbacks:
            Yf, tf, ts, us = self._run_segmented(
                Y0, t0, n_saves, save_every, rem
            )
        else:
            Yf, tf, ts, us = self._make_run_fn(n_saves, save_every, rem)(
                Y0, self.Ya, t0
            )
        self.Y = Yf
        self.t = float(tf)
        # prepend the initial state (DiffEq saves t0); append final if the
        # last partial interval wasn't saved
        ts_full = jnp.concatenate([jnp.asarray([t0], dtype=ts.dtype), ts])
        us_full = jax.tree_util.tree_map(
            lambda x0, xs: jnp.concatenate([x0[None], xs]), Y0, us
        )
        if self._rem:
            ts_full = jnp.concatenate([ts_full, jnp.asarray([tf], dtype=ts.dtype)])
            us_full = jax.tree_util.tree_map(
                lambda xs, xf: jnp.concatenate([xs, xf[None]]), us_full, Yf
            )
        self.sol = Solution(ts=ts_full, us=us_full)
        if sink is not None:
            from landhydrology.checkpoint import _flatten_with_paths

            for k in range(len(self.sol)):
                sink.append(
                    k, float(self.sol.ts[k]), _flatten_with_paths(self.sol.state(k))
                )
            sink.flush()
        return self.sol


def step(simulation: Simulation) -> None:
    """Functional alias of :meth:`Simulation.step` (reference ``step!``)."""
    simulation.step()


def run(simulation: Simulation) -> Solution:
    """Functional alias of :meth:`Simulation.run` (reference ``run!``)."""
    return simulation.run()
