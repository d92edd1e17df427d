"""Diagnostics, conservation monitors, NaN guards, and profiling hooks.

The reference has no tracing/profiling subsystem and its only
numerical-safety measure is the eps-clamp in ``effective_saturation``
(SURVEY.md §5).  This package provides:

- :func:`water_mass` / :func:`energy_total` — the conservation scalars the
  FV scheme preserves exactly under zero-flux BCs (the strongest cheap
  oracles for long runs);
- :func:`nan_guard` — a jit-compatible finite-state check (``jax.debug``
  callback raising on host) for stiff Richards runs near saturation;
- :func:`monitor` — a host-callback scalar logger usable inside scan loops;
- :class:`Profiler` — a thin ``jax.profiler`` wrapper producing
  xprof-compatible traces plus a grid-points/s throughput meter (the
  north-star metric).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

Array = Any


def water_mass(Y: dict, dz, name: str = "soil", param_set=None) -> Array:
    """Column-integrated water (liquid + ice as liquid-equivalent), summed
    over all columns: sum(vartheta_l + (rho_i/rho_l) theta_i) dz."""
    from landhydrology.constants import default_earth_param_set

    if param_set is None:
        param_set = default_earth_param_set
    soil = Y[name]
    total = soil["vartheta_l"]
    if "theta_i" in soil:
        total = total + (
            param_set.rho_cloud_ice / param_set.rho_cloud_liq
        ) * soil["theta_i"]
    return jnp.sum(total) * dz


def energy_total(Y: dict, dz, name: str = "soil") -> Array:
    """Column-integrated volumetric internal energy."""
    return jnp.sum(Y[name]["rho_e_int"]) * dz


def explicit_dt_limit(model, Y: dict, safety: float = 1.0) -> Array:
    """Estimate the explicit SSPRK-stable time step for the Richards
    diffusion from the *face-coupled* stiffness

        lambda_i ~ (K_{i-1/2} + K_{i+1/2}) C_i / dz^2,
        dt <= safety * 2.5 / max_i lambda_i

    (2.5 ~ SSPRK33's real-axis stability extent).  The nonlinear
    diffusivity ``K dpsi/dtheta`` reaches ``K / S_s`` in the saturated
    (compressibility) regime — ~1000x the unsaturated value at the default
    S_s — which silently destabilizes explicit runs that look fine while
    unsaturated.  Use this before choosing dt, or switch to the implicit
    steppers in ``imex.py`` (unconditionally stable).  The face coupling
    matters: K and dpsi/dtheta peak at different moistures, so the
    pointwise product badly overestimates the stiffness of wetting fronts.
    """
    import jax

    from landhydrology.domains import make_function_space
    from landhydrology.models.soil import water as sw
    from landhydrology.ops.stencil import interp_c2f_interior

    sp = model.soil_param_set
    hm = model.hydrology_model.hydraulic_model
    grid = make_function_space(model.domain, model.float_dtype)
    v = Y[model.name]["vartheta_l"]
    theta_i = Y[model.name].get("theta_i", jnp.zeros_like(v))
    nu_eff = sp.nu - theta_i
    S = sw.effective_saturation(sp.nu, v, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, 1.0, 1.0)

    def total(vv):
        return jnp.sum(sw.pressure_head(hm, vv, nu_eff, sp.S_s))

    C = jnp.abs(jax.grad(total)(v))
    Kf = interp_c2f_interior(K)
    zeros = jnp.zeros_like(K[:1])
    K_minus = jnp.concatenate([zeros, Kf], axis=0)
    K_plus = jnp.concatenate([Kf, zeros], axis=0)
    lam = (K_minus + K_plus) * C / (grid.dz * grid.dz)
    return safety * 2.5 / jnp.maximum(jnp.max(lam), 1e-30)


def nan_guard(Y: dict, where: str = "state") -> dict:
    """Check every leaf is finite; raises (via host callback) naming the
    first offending leaf.  Identity on the value, jit-safe."""

    def check(path_str, ok):
        if not ok:
            raise FloatingPointError(
                f"non-finite values detected in {where}:{path_str}"
            )

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(Y)[0]:
        path_str = "/".join(str(getattr(p, "key", p)) for p in path)
        ok = jnp.all(jnp.isfinite(leaf))
        jax.debug.callback(check, path_str, ok)
    return Y


def monitor(tag: str, **scalars) -> None:
    """Log named scalars from inside jit/scan via host callback."""

    def log(**kw):
        items = ", ".join(f"{k}={float(v):.6g}" for k, v in kw.items())
        print(f"[{tag}] {items}", flush=True)

    jax.debug.callback(log, **scalars)


class Profiler:
    """``jax.profiler`` trace + throughput meter.

    >>> prof = Profiler("/tmp/trace")
    >>> with prof.trace():
    ...     out = step(Y, Ya, t); jax.block_until_ready(out)
    >>> gps = prof.throughput(points=nz * ncol * steps)
    """

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._t0 = None
        self._elapsed = None

    @contextlib.contextmanager
    def trace(self, annotate: str = "landhydrology_step"):
        ctx = (
            jax.profiler.trace(self.log_dir)
            if self.log_dir
            else contextlib.nullcontext()
        )
        with ctx:
            with jax.profiler.TraceAnnotation(annotate):
                self._t0 = time.perf_counter()
                yield
                self._elapsed = time.perf_counter() - self._t0

    def throughput(self, points: int) -> float:
        """Grid-points per second over the last traced region."""
        if not self._elapsed:
            raise RuntimeError("no completed trace")
        return points / self._elapsed
