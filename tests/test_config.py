"""Config serialization round-trip tests (SURVEY.md §5: the constructor
lattice as declarative configs)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    FreeDrainage,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
)
from landhydrology.config import from_config, to_config
from landhydrology.models.soil import vanGenuchten
from landhydrology.models.soil.freeze_thaw import FreezeThaw
from landhydrology.models.soil.model import LateralSurfaceCoupling
from landhydrology.models.soil.rhs import make_rhs


def _model():
    return SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=16, batch_shape=(4, 4)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.01)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=0.34, theta_atm=299.0, z_atm=0.05, theta_scale=299.0,
                rho_a_sfc=1.17, q_atm=0.015,
            ),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=SoilParams(nu=0.45),
        lateral_coupling=LateralSurfaceCoupling(conductance=1e-5, dx=2.0),
        freeze_thaw=FreezeThaw(tau=1800.0),
        coefficient_update="step",
    )


def test_roundtrip_through_json():
    model = _model()
    cfg = to_config(model)
    blob = json.dumps(cfg)  # must be JSON-serializable
    model2 = from_config(json.loads(blob))
    assert model2 == model
    # and the reconstructed model builds a working rhs
    make_rhs(model2)


def test_array_fields_roundtrip():
    import dataclasses

    model = _model()
    hm = vanGenuchten(n=jnp.asarray([2.0, 3.0]), alpha=2.6, Ksat=1e-6, theta_r=0.0)
    model = dataclasses.replace(
        model,
        hydrology_model=dataclasses.replace(
            model.hydrology_model, hydraulic_model=hm
        ),
    )
    cfg = json.loads(json.dumps(to_config(model)))
    model2 = from_config(cfg)
    np.testing.assert_allclose(
        np.asarray(model2.hydrology_model.hydraulic_model.n), [2.0, 3.0]
    )


def test_callables_rejected_with_clear_error():
    from landhydrology import Dirichlet

    bc = Dirichlet(lambda t: 0.1)
    with pytest.raises(TypeError, match="callable"):
        to_config(bc)


def test_unknown_type_and_fields_rejected():
    with pytest.raises(KeyError):
        from_config({"__type__": "NotAModel"})
    with pytest.raises(KeyError):
        from_config({"__type__": "SoilParams", "bogus_field": 1.0})
