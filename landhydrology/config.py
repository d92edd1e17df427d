"""Config serialization for the model lattice.

The reference has no config/flag system — configuration is typed
constructors composed in scripts (SURVEY.md §5).  This module keeps that
constructor lattice as the source of truth and adds a JSON-able dict form:

    cfg = to_config(model)            # nested {"__type__": ..., fields...}
    model = from_config(cfg)          # reconstructs the dataclass lattice
    model = from_config(json.loads(open("run.json").read()))

Array-valued fields round-trip as nested lists; callables (profiles,
time-dependent BC values) are not serializable and raise with a clear
message — configs cover the declarative subset, scripts the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from landhydrology.constants import EarthParameterSet
from landhydrology.domains import Column, VariableDepthColumn
from landhydrology.models.soil.boundary import (
    BatchedBC,
    Dirichlet,
    FreeDrainage,
    NoBC,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
)
from landhydrology.models.land import (
    ConstantPrecipitation,
    KinematicWaveRouting,
    LandModel,
    PulsePrecipitation,
    RunoffRouting,
    SurfaceWaterModel,
)
from landhydrology.models.soil.freeze_thaw import (
    EquilibriumFreezeThaw,
    FreezeThaw,
)
from landhydrology.models.soil.model import (
    LateralSurfaceCoupling,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology.models.soil.params import SoilParams
from landhydrology.models.soil.water import (
    IceImpedance,
    NoEffect,
    TemperatureDependentViscosity,
    vanGenuchten,
)

_REGISTRY = {
    cls.__name__: cls
    for cls in [
        Column,
        VariableDepthColumn,
        EarthParameterSet,
        SoilParams,
        vanGenuchten,
        NoEffect,
        TemperatureDependentViscosity,
        IceImpedance,
        SoilEnergyModel,
        SoilHydrologyModel,
        PrescribedTemperatureModel,
        PrescribedHydrologyModel,
        SoilModel,
        LateralSurfaceCoupling,
        FreezeThaw,
        EquilibriumFreezeThaw,
        NoBC,
        VerticalFlux,
        Dirichlet,
        FreeDrainage,
        SoilComponentBC,
        SoilColumnBC,
        PrescribedAtmosForcing,
        BatchedBC,
        LandModel,
        SurfaceWaterModel,
        RunoffRouting,
        KinematicWaveRouting,
        ConstantPrecipitation,
        PulsePrecipitation,
    ]
}


def to_config(obj: Any) -> Any:
    """Dataclass lattice -> JSON-able nested dict."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_config(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_config(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_config(v) for k, v in obj.items()}
    if isinstance(obj, type) or str(type(obj).__name__) == "dtype":
        try:
            return {"__dtype__": str(np.dtype(obj))}
        except TypeError:
            raise TypeError(f"cannot serialize type {obj!r}")
    if hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        return {"__array__": arr.tolist(), "dtype": str(arr.dtype)}
    if callable(obj):
        raise TypeError(
            f"cannot serialize callable {obj!r}: time/space-dependent "
            "profiles belong in scripts, not configs"
        )
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "dtype") and np.ndim(obj) == 0:  # numpy scalar
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj).__name__}: {obj!r}")


def from_config(cfg: Any) -> Any:
    """Nested dict -> dataclass lattice (inverse of :func:`to_config`)."""
    if isinstance(cfg, dict) and "__type__" in cfg:
        cls = _REGISTRY.get(cfg["__type__"])
        if cls is None:
            raise KeyError(f"unknown config type {cfg['__type__']!r}")
        kwargs = {
            k: from_config(v) for k, v in cfg.items() if k != "__type__"
        }
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kwargs) - field_names
        if unknown:
            raise KeyError(f"{cfg['__type__']}: unknown fields {sorted(unknown)}")
        return cls(**kwargs)
    if isinstance(cfg, dict) and "__dtype__" in cfg:
        import jax.numpy as jnp

        return jnp.dtype(cfg["__dtype__"])
    if isinstance(cfg, dict) and "__array__" in cfg:
        import jax.numpy as jnp

        return jnp.asarray(np.asarray(cfg["__array__"], dtype=cfg["dtype"]))
    if isinstance(cfg, list):
        out = [from_config(v) for v in cfg]
        return tuple(out)
    if isinstance(cfg, dict):
        return {k: from_config(v) for k, v in cfg.items()}
    return cfg
