"""Laplace approximation of the log marginal likelihood (model evidence).

The third leg of the MAP workflow the reference serves: after the mode
x* and curvature are in hand, the Gaussian integral approximation

    log Z  ≈  L(x*) + (n/2)·log(2π) − (1/2)·log det(−H)

(H = ∇²L at the mode, negative definite under the maximization
convention) turns a batched MAP fleet into batched evidence estimates —
model comparison, Bayes factors, and the empirical-Bayes objectives that
`optimize_implicit` differentiates.

Two curvature sources:

  * exact: ``obj`` given → `jax.hessian` at x* (O(n²) memory, the right
    choice at MAP-scale n). Exact for Gaussians by construction.
  * approximate: the solver's converged inverse Hessian B ≈ (−H)⁻¹
    (free — it is already in `result.state`). BFGS curvature is a
    secant-subspace estimate, so treat B-based evidence as a cheap
    screen, not a certified value (the B path's error is tested and
    documented, not hidden).
  * approximate, large n: an L-BFGS fleet state carries its curvature in
    the (m, n) history rings; log det H comes from the compact-form
    determinant identity (`ops.lbfgs_compact.lbfgs_logdet_inv_hessian`,
    O(m³ + m²n)) — the dense-free MAP→evidence pipeline, no n×n matrix
    ever materializes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .api import as_logdensity

__all__ = ["laplace_evidence"]

# math, not jnp: a module-level jnp op would run at package import (before
# the user can enable x64 or pin the CPU backend — it would eagerly
# initialize the default backend) and bake an f32-truncated constant
_LOG_2PI = math.log(2.0 * math.pi)


def _hessian_fn(obj):
    # as_logdensity: the same normalizer every other entry point uses, so
    # duck-typed .logdensity objects work here too
    return jax.hessian(as_logdensity(obj))


def laplace_evidence(
    result,
    obj: Optional[Callable] = None,
) -> jax.Array:
    """log Z under the Laplace approximation at a solve result's mode.

    ``result``: an `OptimizeResult` (scalar or batched fleet) or an
    L-BFGS result. With ``obj`` the Hessian is computed exactly at x*
    (recommended); without it the solver's own curvature stands in for
    (−H)⁻¹ — log Z ≈ L* + (n/2) log 2π + (1/2) log det B, where log det B
    is the dense slogdet for a BFGS state, or the O(m³ + m²n)
    compact-form determinant identity over the history rings for an
    L-BFGS state (large n, no dense matrix).

    Failed lanes (fun is NaN by the in-band contract) propagate NaN.
    Returns a scalar for a scalar solve, (batch,) for a fleet.
    """
    x = result.x
    fun = result.fun  # NaN on any failure (the in-band contract) — a
    # non-converged lane's "evidence" must not look like a number
    batched = x.ndim == 2
    n = x.shape[-1]
    const = 0.5 * n * _LOG_2PI

    if obj is not None:
        hess = _hessian_fn(obj)

        def logdet_neg_h(xi):
            sign, logdet = jnp.linalg.slogdet(-hess(xi))
            # a non-PD −H means xi is not a proper interior maximum:
            # the Gaussian integral does not exist there — NaN in-band
            return jnp.where(sign > 0, logdet, jnp.nan)

        ld = jax.vmap(logdet_neg_h)(x) if batched else logdet_neg_h(x)
        return fun + const - 0.5 * ld

    state = result.state
    if hasattr(state, "B"):
        sign, logdet_b = jnp.linalg.slogdet(state.B)
        logdet_b = jnp.where(sign > 0, logdet_b, jnp.nan)
        return fun + const + 0.5 * logdet_b
    if hasattr(state, "S") and hasattr(state, "hist"):
        from .ops.lbfgs_compact import lbfgs_logdet_inv_hessian

        if batched:
            logdet_b = jax.vmap(lbfgs_logdet_inv_hessian)(
                state.S, state.Y, state.hist, state.gamma
            )
        else:
            logdet_b = lbfgs_logdet_inv_hessian(
                state.S, state.Y, state.hist, state.gamma
            )
        return fun + const + 0.5 * logdet_b
    raise ValueError(
        "result carries no curvature (neither dense B nor L-BFGS rings); "
        "pass obj= for an exact-Hessian Laplace evidence"
    )
