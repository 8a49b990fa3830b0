"""NaN-aware scalar helpers and precision constants.

accelerator-native re-expression of the reference's scalar utilities
(reference: src/QuasiNewtonMethods.jl:152-155). These are used to make the
backtracking line search robust when interpolation produces NaN: `nanmin` /
`nanmax` prefer the non-NaN argument so step clamping always yields a usable
step size, and `sqrt_tolerance` is the degenerate-cubic detection threshold
(2**(-significand_bits/2)).

Everything here is branchless (`jnp.where`) so it traces cleanly under
`jax.jit` / `jax.vmap` and inside `lax.while_loop` bodies.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "nanmin",
    "nanmax",
    "significand_bits",
    "sqrt_tolerance",
    "finite_halving_limit",
]


def nanmin(a, b):
    """min(a, b), preferring the non-NaN argument.

    Semantics match the reference (src/QuasiNewtonMethods.jl:152):
    ``a < b ? a : (isnan(b) ? a : b)`` — if ``a`` is NaN the comparison is
    false and we fall through to ``b`` (unless ``b`` is also NaN).
    """
    return jnp.where(a < b, a, jnp.where(jnp.isnan(b), a, b))


def nanmax(a, b):
    """max(a, b), preferring the non-NaN argument.

    Semantics match the reference (src/QuasiNewtonMethods.jl:153):
    ``a < b ? b : (isnan(a) ? b : a)``.
    """
    return jnp.where(a < b, b, jnp.where(jnp.isnan(a), b, a))


_SIGNIFICAND_BITS = {
    np.dtype(np.float64): 52,
    np.dtype(np.float32): 23,
    np.dtype(np.float16): 10,
}
try:  # bfloat16 lives in ml_dtypes; always present with jax installed
    import ml_dtypes

    _SIGNIFICAND_BITS[np.dtype(ml_dtypes.bfloat16)] = 7
except ImportError:  # pragma: no cover
    pass


def significand_bits(dtype) -> int:
    """Number of explicit mantissa bits for a float dtype.

    Mirror of Julia's ``Base.Math.significand_bits`` as used by the
    reference for the finite-search iteration cap
    (src/QuasiNewtonMethods.jl:179) and sqrt tolerance (:155).
    """
    return _SIGNIFICAND_BITS[np.dtype(dtype)]


def sqrt_tolerance(dtype) -> float:
    """``2 ** -(significand_bits // 2)`` — ≈1.49e-8 for f64, ≈4.9e-4 for f32.

    Reference: src/QuasiNewtonMethods.jl:155.
    """
    return float(1.0 / (1 << (significand_bits(dtype) >> 1)))


def finite_halving_limit(dtype) -> int:
    """Max number of step-halvings while searching for a finite objective.

    The reference halves alpha up to ``significand_bits(T)`` times
    (src/QuasiNewtonMethods.jl:179-184) — 52 for f64.
    """
    return significand_bits(dtype)
