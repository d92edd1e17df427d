"""Vertical stencil operators and numerical kernels."""

from landhydrology.ops.stencil import (
    div_f2c,
    diffusive_flux_faces,
    grad_c2f_interior,
    interp_c2f_interior,
)
from landhydrology.ops.tridiag import thomas_solve

__all__ = [
    "interp_c2f_interior",
    "grad_c2f_interior",
    "div_f2c",
    "diffusive_flux_faces",
    "thomas_solve",
]
