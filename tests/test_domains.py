"""Domain construction tests (mirrors ``/root/reference/test/test_domains.jl``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology.domains import Column, make_function_space


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_instantiate_column(dtype):
    domain = Column(zlim=(0.0, 1.0), nelements=2)
    assert domain.zlim == (0.0, 1.0)
    assert domain.nelements == 2
    assert domain.ndims == 1
    assert domain.boundary_tags == ("bottom", "top")

    # length = physical height (reference Base.length, test_domains.jl:21-26)
    assert Column(zlim=(1.0, 2.0), nelements=2).height == 1.0
    assert Column(zlim=(1.0, 4.0), nelements=2).size == 3.0

    # show
    assert repr(domain) == "[0.0, 1.0]"


def test_zlim_validation():
    with pytest.raises(ValueError):
        Column(zlim=(1.0, 0.0), nelements=4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_function_space_layout(dtype):
    """Centers at midpoints, faces at edges — the reference layout verified
    at ``test/SoilModel/coupled.jl:198``."""
    domain = Column(zlim=(-2.0, 0.0), nelements=20)
    grid = make_function_space(domain, dtype)
    assert grid.nz == 20
    np.testing.assert_allclose(
        np.asarray(grid.zc).ravel(), np.arange(-1.95, 0.0, 0.1), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(grid.zf).ravel(), np.arange(-2.0, 0.01, 0.1), atol=1e-6
    )
    assert grid.zc.dtype == jnp.dtype(dtype)
    assert float(grid.dz) == pytest.approx(0.1)
    assert float(grid.dz_boundary) == pytest.approx(0.05)


def test_batched_grid_broadcasting():
    domain = Column(zlim=(-1.0, 0.0), nelements=10, batch_shape=(4, 8))
    grid = make_function_space(domain, jnp.float32)
    assert grid.shape == (10, 4, 8)
    assert grid.zc.shape == (10, 1, 1)
    field = jnp.zeros(grid.shape)
    assert (grid.zc + field).shape == (10, 4, 8)
