"""Stencil-operator tests against a hand-rolled finite-volume oracle —
the single best bit-level check in the reference
(``/root/reference/test/SoilModel/coupled.jl:230-234``)."""

import jax.numpy as jnp
import numpy as np

from landhydrology.ops.stencil import (
    diffusive_flux_faces,
    div_f2c,
    grad_c2f_interior,
    interp_c2f_interior,
)
from landhydrology.ops.tridiag import thomas_solve


def test_interp_and_grad():
    x = jnp.array([1.0, 3.0, 7.0])
    np.testing.assert_allclose(interp_c2f_interior(x), [2.0, 5.0])
    np.testing.assert_allclose(grad_c2f_interior(x, 0.5), [4.0, 8.0])


def test_div_f2c_oracle():
    """div = diff(flux)/dz with SetValue boundary faces, exactly the
    reconstruction at coupled.jl:230-234."""
    rng = np.random.default_rng(0)
    nz, dz = 21, 0.1
    K = jnp.asarray(rng.uniform(0.1, 1.0, nz))
    h = jnp.asarray(rng.uniform(-1.0, 1.0, nz))
    fb, ft = 0.3, -0.2

    flux_int = diffusive_flux_faces(K, h, dz)
    div = div_f2c(flux_int, fb, ft, dz)

    # oracle: assemble the full face flux array by hand
    flux = np.empty(nz + 1)
    flux[0] = fb
    flux[-1] = ft
    Kf = 0.5 * (np.asarray(K)[:-1] + np.asarray(K)[1:])
    gradh = (np.asarray(h)[1:] - np.asarray(h)[:-1]) / dz
    flux[1:-1] = -Kf * gradh
    expected = np.diff(flux) / dz
    np.testing.assert_allclose(div, expected, rtol=1e-14)


def test_div_f2c_batched_and_broadcast_boundaries():
    nz, ncol = 8, 5
    rng = np.random.default_rng(1)
    flux_int = jnp.asarray(rng.normal(size=(nz - 1, ncol)))
    # scalar bottom, per-column top
    ft = jnp.asarray(rng.normal(size=(ncol,)))
    div = div_f2c(flux_int, 0.0, ft, 0.25)
    assert div.shape == (nz, ncol)
    full = np.concatenate(
        [np.zeros((1, ncol)), np.asarray(flux_int), np.asarray(ft)[None]], axis=0
    )
    np.testing.assert_allclose(div, np.diff(full, axis=0) / 0.25, rtol=1e-14)


def test_thomas_solve_matches_dense():
    rng = np.random.default_rng(2)
    n, batch = 16, 7
    dl = rng.uniform(0.1, 0.5, (n, batch))
    du = rng.uniform(0.1, 0.5, (n, batch))
    d = 2.0 + dl + du  # diagonally dominant
    b = rng.normal(size=(n, batch))
    x = thomas_solve(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b))
    for j in range(batch):
        A = (
            np.diag(d[:, j])
            + np.diag(dl[1:, j], -1)
            + np.diag(du[:-1, j], 1)
        )
        np.testing.assert_allclose(x[:, j], np.linalg.solve(A, b[:, j]), rtol=1e-10)


def test_pcr_solve_matches_dense_and_thomas():
    """Parallel cyclic reduction == dense solve == Thomas on diagonally
    dominant batches, for power-of-2 and odd sizes."""
    import numpy as np

    from landhydrology.ops.tridiag import pcr_solve

    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 16, 24, 64):
        batch = 5
        dl = rng.uniform(-1.0, 0.0, (n, batch))
        du = rng.uniform(-1.0, 0.0, (n, batch))
        d = 2.5 + rng.uniform(0.0, 1.0, (n, batch))  # strictly dominant
        b = rng.standard_normal((n, batch))
        x_pcr = np.asarray(
            pcr_solve(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
                      jnp.asarray(b))
        )
        x_th = np.asarray(
            thomas_solve(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
                         jnp.asarray(b))
        )
        for j in range(batch):
            A = np.diag(d[:, j])
            for i in range(1, n):
                A[i, i - 1] = dl[i, j]
                A[i - 1, i] = du[i - 1, j]
            x_dense = np.linalg.solve(A, b[:, j])
            np.testing.assert_allclose(x_pcr[:, j], x_dense, rtol=1e-11,
                                       atol=1e-13, err_msg=f"pcr n={n}")
            np.testing.assert_allclose(x_th[:, j], x_dense, rtol=1e-11,
                                       atol=1e-13, err_msg=f"thomas n={n}")


def test_backward_euler_delta_single_cell_shape():
    """nz == 1 column: the tridiagonal assembly degenerates to a diagonal
    solve and must preserve the (1, batch) shape (the concat-based
    assembly once duplicated the lone row)."""
    from landhydrology.domains import ColumnGrid
    from landhydrology.imex import _backward_euler_delta

    grid = ColumnGrid(
        zc=np.zeros((1, 1)), zf=np.zeros((2, 1)), dz=0.5, nz=1,
        batch_shape=(3,),
    )
    K = jnp.ones((1, 3))
    C = jnp.full((1, 3), 2.0)
    b = jnp.asarray([[1.0, 2.0, 3.0]])
    out = _backward_euler_delta(K, C, b, 10.0, grid)
    assert out.shape == (1, 3)
    np.testing.assert_allclose(np.asarray(out), np.asarray(b))  # A = I
    # with a boundary boost the diagonal changes but the shape holds
    out2 = _backward_euler_delta(K, C, b, 10.0, grid, diag_boost_top=-0.05)
    assert out2.shape == (1, 3)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(b) / 1.5)
