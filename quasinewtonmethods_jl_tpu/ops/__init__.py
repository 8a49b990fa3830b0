"""Numerics kernels: line search, BFGS/L-BFGS updates."""

from .bfgs import bfgs_update, bfgs_update_reference, initial_inv_hessian
from .linesearch import BackTracking, LineSearchResult, backtracking_linesearch

__all__ = [
    "bfgs_update",
    "bfgs_update_reference",
    "initial_inv_hessian",
    "BackTracking",
    "LineSearchResult",
    "backtracking_linesearch",
]
