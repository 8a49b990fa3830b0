"""Backtracking line search (quadratic / cubic interpolation), maximization form.

accelerator-native re-expression of the reference line search
(reference: src/QuasiNewtonMethods.jl:72-80 `BackTracking`,
:165-232 `linesearch!`). The reference's two imperative phases —
(A) halve alpha until the objective is finite, (B) an Armijo
sufficient-*increase* loop with interpolated proposals — become two nested
`lax.while_loop`s so the whole search traces into a single XLA computation
(and therefore batches under `jax.vmap` and nests inside the outer solver
while-loop).

Conventions preserved from the reference (these are API contracts with the
HMC-initialization use case):
  * maximization: the Armijo test is ``f(x + a*d) >= f0 + a*c1*m`` with
    ``m = gradᵀ d > 0`` the directional derivative along an ascent direction;
  * failure is in-band: alpha == 0 means the search exhausted its iteration
    budget (src/QuasiNewtonMethods.jl:193);
  * NaN-robust clamping via nanmin/nanmax (:224-225): a NaN interpolation
    proposal falls back to the [rho_lo*a, rho_hi*a] bracket;
  * the cubic degenerates to ``m / (2b)`` when the cubic coefficient is
    negligible (:211-212).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.scalars import finite_halving_limit, nanmin, nanmax, sqrt_tolerance

__all__ = ["BackTracking", "LineSearchResult", "backtracking_linesearch", "run_linesearch"]


@dataclasses.dataclass(frozen=True)
class BackTracking:
    """Backtracking line-search hyperparameters.

    Mirror of the reference's ``BackTracking{O}`` config struct
    (src/QuasiNewtonMethods.jl:72-80) with the same defaults. ``order`` is a
    *static* (trace-time) parameter, the analog of the reference's
    compile-time type parameter O ∈ {2, 3}: order 2 always proposes via
    quadratic interpolation of (f(0), f'(0), f(a)); order 3 proposes via a
    cubic through the last two trial points (quadratic on the first
    iteration, when only one trial exists).
    """

    order: int = 2
    c1: float = 1e-4
    rho_hi: float = 0.5
    rho_lo: float = 0.1
    iterations: int = 1000

    def __post_init__(self):
        if self.order not in (2, 3):
            raise ValueError(f"BackTracking order must be 2 or 3, got {self.order}")


class LineSearchResult(NamedTuple):
    """Functional result of one line search.

    ``alpha == 0`` is the in-band failure sentinel (iteration budget
    exhausted), matching src/QuasiNewtonMethods.jl:193.
    """

    alpha: jax.Array  # accepted step size (0.0 on failure)
    f_final: jax.Array  # objective at x + alpha*d (stale/unused on failure)
    n_fev: jax.Array  # int32: number of objective evaluations performed
    iterations: jax.Array  # int32: Armijo backtracking rounds used
    failed: jax.Array  # bool: iteration budget exhausted


def _quadratic_proposal(m, a2, fx1, f0):
    # Minimizer (in backtracking sense) of the quadratic interpolating
    # f(0)=f0, f'(0)=m, f(a2)=fx1. Reference: src/QuasiNewtonMethods.jl:205.
    return -(m * a2 * a2) / (2.0 * (fx1 - f0 - m * a2))


def _cubic_proposal(m, a1, a2, fx0, fx1, f0, eps, sqrttol):
    # Cubic through (a1, fx0) and (a2, fx1) with f(0)=f0, f'(0)=m.
    # Reference: src/QuasiNewtonMethods.jl:207-219, including the degenerate
    # fallback to m/(2b) when |a| is negligible and the NaN-guarded
    # discriminant clamp.
    denom = 1.0 / (a1 * a1 * a2 * a2 * (a2 - a1))
    r1 = fx1 - f0 - m * a2
    r0 = fx0 - f0 - m * a1
    a = (a1 * a1 * r1 - a2 * a2 * r0) * denom
    b = (-a1 * a1 * a1 * r1 + a2 * a2 * a2 * r0) * denom
    degenerate = jnp.abs(a) <= eps + sqrttol * jnp.abs(a)
    disc = nanmax(b * b - 3.0 * a * m, jnp.zeros_like(b))
    root = (jnp.sqrt(disc) + b) / (-3.0 * a)
    return jnp.where(degenerate, m / (2.0 * b), root)


class _FiniteCarry(NamedTuple):
    a1: jax.Array
    a2: jax.Array
    fx1: jax.Array
    it: jax.Array
    n_fev: jax.Array


class _ArmijoCarry(NamedTuple):
    a1: jax.Array
    a2: jax.Array
    fx0: jax.Array
    fx1: jax.Array
    iteration: jax.Array
    n_fev: jax.Array


def backtracking_linesearch(
    phi: Callable[[jax.Array], jax.Array],
    f0: jax.Array,
    m: jax.Array,
    ls: BackTracking = BackTracking(),
) -> LineSearchResult:
    """Run the backtracking line search for a maximization step.

    Args:
      phi: scalar trial evaluator, ``phi(alpha) = logdensity(x + alpha * d)``.
        Traced inline; each loop round costs exactly one evaluation
        (the analog of the reference's `step!`, src/QuasiNewtonMethods.jl:157-162).
      f0: objective value at alpha=0.
      m: directional derivative ``gradᵀ d`` at alpha=0 (must be > 0 for a
        genuine ascent direction; the solver guarantees this via its
        steepest-ascent restart).
      ls: static hyperparameters.

    Returns:
      LineSearchResult with the accepted alpha (or 0.0 on failure).
    """
    dtype = jnp.result_type(f0)
    c1 = jnp.asarray(ls.c1, dtype)
    rho_hi = jnp.asarray(ls.rho_hi, dtype)
    rho_lo = jnp.asarray(ls.rho_lo, dtype)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    sqrttol = jnp.asarray(sqrt_tolerance(dtype), dtype)
    one = jnp.ones((), dtype)

    # Initial trial at alpha = 1 (reference :169-174).
    fx1_init = phi(one)

    # Phase A — halve alpha until the objective is finite (reference
    # :176-184). Note the reference's subtle bracket bookkeeping: on each
    # halving, a1 takes the *previous* a2.
    iterfinitemax = finite_halving_limit(dtype)

    # A search with non-finite m (or f0) is doomed: the Armijo RHS is NaN,
    # so no trial can ever satisfy it and the reference would burn the whole
    # iteration budget before returning the alpha=0 failure. Failing fast is
    # outcome-identical and matters enormously under vmap, where one doomed
    # lane (e.g. the discarded cond-branch of an already-converged lane)
    # would otherwise drag every lane through the full budget, every outer
    # iteration.
    doomed = ~(jnp.isfinite(m) & jnp.isfinite(f0))

    def finite_cond(c: _FiniteCarry):
        return ~doomed & ~jnp.isfinite(c.fx1) & (c.it < iterfinitemax)

    def finite_body(c: _FiniteCarry):
        a2 = 0.5 * c.a2
        return _FiniteCarry(c.a2, a2, phi(a2), c.it + 1, c.n_fev + 1)

    fc = lax.while_loop(
        finite_cond,
        finite_body,
        _FiniteCarry(one, one, fx1_init, jnp.zeros((), jnp.int32), jnp.ones((), jnp.int32)),
    )

    # Phase B — Armijo sufficient-increase loop (reference :186-230).
    # A NaN fx1 keeps the loop running (~(NaN >= t) is True), exactly like
    # the reference, and the NaN-robust clamps keep proposals usable.
    def sufficient(c: _ArmijoCarry):
        return c.fx1 >= f0 + c.a2 * c1 * m

    def armijo_cond(c: _ArmijoCarry):
        return ~doomed & ~sufficient(c) & (c.iteration < ls.iterations)

    def armijo_body(c: _ArmijoCarry):
        it = c.iteration + 1
        quad = _quadratic_proposal(m, c.a2, c.fx1, f0)
        if ls.order == 2:
            at = quad
        else:
            cubic = _cubic_proposal(m, c.a1, c.a2, c.fx0, c.fx1, f0, eps, sqrttol)
            at = jnp.where(it == 1, quad, cubic)
        a1 = c.a2
        at = nanmin(at, c.a2 * rho_hi)  # avoid too-small reductions
        a2 = nanmax(at, c.a2 * rho_lo)  # avoid too-big reductions
        fx1 = phi(a2)
        return _ArmijoCarry(a1, a2, c.fx1, fx1, it, c.n_fev + 1)

    ac = lax.while_loop(
        armijo_cond,
        armijo_body,
        _ArmijoCarry(fc.a1, fc.a2, f0, fc.fx1, jnp.zeros((), jnp.int32), fc.n_fev),
    )

    budget_exhausted = ~sufficient(ac)
    alpha = jnp.where(budget_exhausted, jnp.zeros((), dtype), ac.a2)
    # The failure contract is alpha == 0 (reference :284 `iszero(α₂) && break`):
    # this covers both budget exhaustion and the underflow path where alpha
    # shrinks to exactly 0 and the Armijo test trivially "succeeds" at the
    # unmoved point.
    failed = alpha == 0.0
    return LineSearchResult(alpha, ac.fx1, ac.n_fev, ac.iteration, failed)


def run_linesearch(ls, f, vag, x, d, f0, m, dot=None):
    """Dispatch to the configured line search (trace-time on the config type).

    Returns ``(alpha, failed, extra_fev, extra_gev)``. BackTracking trials
    are value-only; Wolfe trials evaluate value+gradient (the curvature test
    needs the directional derivative) and so count toward both counters.

    ``dot`` is the injectable contraction used for the Wolfe trial slope
    gradᵀd. The parameter-sharded driver (parallel.mesh) substitutes a
    local-dot + psum: without it each device would see only its partial
    directional derivative, the Wolfe while-loop trip counts would diverge
    across devices, and the collectives would deadlock.
    """
    from .wolfe import Wolfe, wolfe_linesearch

    if dot is None:
        dot = jnp.dot
    if isinstance(ls, Wolfe):

        def phi_vag(alpha):
            fv, gv = vag(x + alpha * d)
            return fv, dot(gv, d)

        wr = wolfe_linesearch(phi_vag, f0, m, ls)
        return wr.alpha, wr.failed, wr.n_fev, wr.n_fev

    def phi(alpha):
        return f(x + alpha * d)

    lsr = backtracking_linesearch(phi, f0, m, ls)
    return lsr.alpha, lsr.failed, lsr.n_fev, jnp.zeros((), jnp.int32)
