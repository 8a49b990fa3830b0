"""Evidence-grade polish: batched Newton refinement of a converged fleet.

The f32 fleet certifies max|∇| < 1e-3 (the documented throughput
contract); Laplace evidence and B-as-covariance want tighter modes. This
module adds the polish stage: a few safeguarded exact-Hessian Newton
steps on the CONVERGED lanes drive the gradient norm to the objective's
evaluation floor — quadratic convergence means 2-3 steps from 1e-3 reach
it. At n = MAP scale the per-lane Hessian is small (60×60 = 14 KB f32),
so the whole fleet's polish is a handful of batched `jax.hessian` +
`linalg.solve` calls — microseconds next to the solve.

Precision reality (measured, documented in the polish result rather than
hidden): in f32 the achievable max|∇| is set by the f32 evaluation noise
of the gradient itself (cancellation at the mode), typically ~1e-5·scale
for Rosenbrock-like objectives — NOT 0. For certified 1e-6+ gradients,
run the polish in f64 (`dtype=jnp.float64`; requires x64 enabled — 2-3
steps on an already-converged fleet are cheap) or use the native C++ host path
(`host.optimize_host`, f64 end to end).

Safeguards (all per-lane, in-band): a step is KEPT only if it is finite
and does not increase max|∇| — a lane at its evaluation floor simply
keeps its iterate (`improved` reports which lanes moved). Failed lanes
(status != CONVERGED) are never touched.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .api import as_logdensity, as_value_and_grad
from .state import Status

__all__ = ["PolishResult", "polish_newton"]


class PolishResult(NamedTuple):
    """Refined modes + the before/after certificate.

    x: (batch, n) (or (n,)) polished iterates
    fun: objective at x (NaN where the input lane had failed)
    grad: gradient at x
    grad_norm_before / grad_norm_after: per-lane max|∇|
    improved: bool per lane — a Newton step was accepted
    """

    x: jax.Array
    fun: jax.Array
    grad: jax.Array
    grad_norm_before: jax.Array
    grad_norm_after: jax.Array
    improved: jax.Array


@partial(
    jax.jit,
    static_argnames=("obj", "steps", "value_and_grad_fn", "dtype"),
)
def _polish_jit(obj, x, status, steps, value_and_grad_fn, dtype):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    hess = jax.hessian(as_logdensity(obj))

    if dtype is not None:
        x = x.astype(dtype)

    def polish_one(xi, ok):
        f0, g0 = vag(xi)
        norm0 = jnp.max(jnp.abs(g0))

        def step(carry, _):
            xc, gc, normc = carry
            H = hess(xc)
            # maximization: H is negative definite at a proper mode;
            # Newton step d = (-H)^-1 g
            d = jnp.linalg.solve(-H, gc)
            x_new = xc + d
            f_new, g_new = vag(x_new)
            norm_new = jnp.max(jnp.abs(g_new))
            # keep only finite, gradient-decreasing steps (the lane may
            # already sit at its dtype's evaluation floor)
            take = jnp.isfinite(norm_new) & (norm_new < normc) & ok
            xc = jnp.where(take, x_new, xc)
            gc = jnp.where(take, g_new, gc)
            normc = jnp.where(take, norm_new, normc)
            return (xc, gc, normc), take

        (x1, g1, norm1), takes = jax.lax.scan(
            step, (xi, g0, norm0), None, length=steps
        )
        f1 = vag(x1)[0]
        return x1, f1, g1, norm0, norm1, jnp.any(takes)

    if x.ndim == 2:
        ok = status == Status.CONVERGED
        x1, f1, g1, n0, n1, imp = jax.vmap(polish_one)(x, ok)
        nan = jnp.asarray(jnp.nan, x.dtype)
        f1 = jnp.where(ok, f1, nan)
    else:
        ok = status == Status.CONVERGED
        x1, f1, g1, n0, n1, imp = polish_one(x, ok)
        f1 = jnp.where(ok, f1, jnp.asarray(jnp.nan, x.dtype))
    return PolishResult(
        x=x1, fun=f1, grad=g1, grad_norm_before=n0, grad_norm_after=n1,
        improved=imp,
    )


def polish_newton(
    obj,
    result,
    steps: int = 3,
    value_and_grad_fn: Optional[Callable] = None,
    dtype=None,
) -> PolishResult:
    """Refine a solve result's modes with safeguarded Newton steps.

    ``result``: any OptimizeResult (scalar or fleet, BFGS or L-BFGS).
    ``dtype``: optionally recast the polish stage (e.g. ``jnp.float64``
    with x64 enabled) — the f32→f64 promotion is what buys gradients
    below the f32 evaluation floor. Non-converged lanes pass through
    untouched with NaN fun (the in-band contract).
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return _polish_jit(
        obj, result.x, result.status, steps, value_and_grad_fn, dtype
    )
