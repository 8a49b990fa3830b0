"""L-BFGS maximization driver — the large-n companion to solve.optimize.

Same outer structure as the BFGS driver (one jitted `lax.while_loop`, the
reference optimize! skeleton, src/QuasiNewtonMethods.jl:237-292) with the
dense rank-2 update replaced by the two-loop recursion over an m-pair
history ring (ops/lbfgs.py). Differences from the dense driver, all forced
by limited memory:

  * curvature pairs are pushed *after* an accepted step, and pairs with
    sᵀy <= 0 are skipped instead of updating (cautious rule);
  * the m_dir <= 0 reset clears the history ring (the dense driver resets
    B to I, :272-280) and takes the steepest-ascent direction;
  * H0 is the Barzilai–Borwein scaling gamma = sᵀy/yᵀy instead of I.

The ``dot`` injection point threads through to the recursion so the
'model'-sharded large-n path (parallel.mesh) reuses this exact driver.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .ops.lbfgs import lbfgs_direction, lbfgs_push
from .ops.lbfgs_compact import lbfgs_direction_compact
from .ops.linesearch import BackTracking, run_linesearch
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT
from .state import LBFGSState, Status, init_lbfgs_state

__all__ = ["LBFGSResult", "optimize_lbfgs", "optimize_lbfgs_from_state"]


class LBFGSResult(NamedTuple):
    """Mirrors OptimizeResult with the L-BFGS state pytree."""

    x: jax.Array
    fun: jax.Array
    grad: jax.Array
    status: jax.Array
    iterations: jax.Array
    n_fev: jax.Array
    n_gev: jax.Array
    n_resets: jax.Array
    last_value: jax.Array
    state: LBFGSState

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


def _lbfgs_loop(
    vag: Callable,
    f: Callable,
    state: LBFGSState,
    ls: BackTracking,
    tol,
    max_iterations: int,
    dot: Callable,
    max_abs: Optional[Callable] = None,
    direction_method: str = "compact",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSState:
    """``dot`` and ``max_abs`` are injectable contraction/reduction hooks:
    the sharded path (parallel.mesh) substitutes local-op + psum/pmax so the
    whole driver runs unmodified inside shard_map on parameter shards.

    ``direction_method``: 'compact' (Byrd–Nocedal–Schnabel; two small
    matmuls + triangular solves — ~20x fewer sequential steps, the
    default) or 'two_loop' (classic recursion; required for the sharded
    path, whose dot products must psum). Both produce identical directions
    to machine precision (tested)."""
    if direction_method == "compact":
        direction_fn = lbfgs_direction_compact
    elif direction_method == "two_loop":
        direction_fn = lambda S, Y, rho, hist, gamma, g: lbfgs_direction(
            S, Y, rho, hist, gamma, g, dot=dot
        )
    else:
        raise ValueError(f"unknown direction_method {direction_method!r}")
    dtype = state.x.dtype
    tol = jnp.asarray(tol, dtype)
    if max_abs is None:
        max_abs = lambda g: jnp.max(jnp.abs(g))

    def cond(s: LBFGSState):
        return jnp.logical_and(s.status == Status.RUNNING, s.k < max_iterations)

    def body(s: LBFGSState):
        f0, g = vag(s.x)
        n_fev = s.n_fev + 1
        n_gev = s.n_gev + 1

        nonfinite = ~jnp.isfinite(f0)
        converged = max_abs(g) < tol
        improved = jnp.where(jnp.isnan(s.fun), True, f0 > s.fun)
        stall = jnp.where(improved, jnp.int32(0), s.stall + 1)
        stalled = (stall >= stall_limit) if stall_limit else jnp.asarray(False)
        status_pre = jnp.where(
            nonfinite,
            jnp.int32(Status.NONFINITE_VALUE),
            jnp.where(
                converged,
                jnp.int32(Status.CONVERGED),
                jnp.where(
                    stalled,
                    jnp.int32(Status.LINESEARCH_FAILURE),
                    jnp.int32(Status.RUNNING),
                ),
            ),
        )

        def finish(_):
            return s._replace(
                grad=g, fun=f0, status=status_pre, n_fev=n_fev, n_gev=n_gev,
                stall=stall,
            )

        def advance(_):
            # Push the curvature pair produced by the previous accepted step
            # (skipped on the first iteration: step is zero, sty = 0 -> reject).
            y_pair = s.grad_old - g
            S, Y, rho, hist, gamma = lbfgs_push(
                s.S, s.Y, s.rho, s.hist, s.gamma, s.step, y_pair, dot=dot
            )

            d, m = direction_fn(S, Y, rho, hist, gamma, g)

            # Indefinite direction: clear the history and restart from
            # steepest ascent (the limited-memory analog of the dense
            # driver's B = I reset, reference :272-280).
            reset = m <= 0.0
            d = jnp.where(reset, g, d)
            m = jnp.where(reset, dot(g, g), m)
            hist = jnp.where(reset, jnp.zeros_like(hist), hist)
            gamma = jnp.where(reset, jnp.ones_like(gamma), gamma)

            alpha, ls_failed, ls_fev, ls_gev = run_linesearch(
                ls, f, vag, s.x, d, f0, m, dot=dot
            )
            # explicit mask: 0 * NaN direction would otherwise destroy x
            step = jnp.where(ls_failed, jnp.zeros_like(d), alpha * d)
            new_status = jnp.where(
                ls_failed,
                jnp.int32(Status.LINESEARCH_FAILURE),
                jnp.int32(Status.RUNNING),
            )
            return LBFGSState(
                x=s.x + step,
                grad=g,
                grad_old=g,
                step=step,
                S=S,
                Y=Y,
                rho=rho,
                hist=hist,
                gamma=gamma,
                fun=f0,
                k=s.k + 1,
                status=new_status,
                n_fev=n_fev + ls_fev,
                n_gev=n_gev + ls_gev,
                n_resets=s.n_resets + reset.astype(jnp.int32),
                stall=stall,
            )

        return lax.cond(status_pre != Status.RUNNING, finish, advance, None)

    final = lax.while_loop(cond, body, state)
    return final._replace(
        status=jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            final.status,
        )
    )


def _result_from_state(state: LBFGSState) -> LBFGSResult:
    nan = jnp.asarray(jnp.nan, state.x.dtype)
    return LBFGSResult(
        x=state.x,
        fun=jnp.where(state.status == Status.CONVERGED, state.fun, nan),
        grad=state.grad,
        status=state.status,
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        last_value=state.fun,
        state=state,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "ls", "history", "max_iterations", "value_and_grad_fn",
        "direction_method", "stall_limit",
    ),
)
def _optimize_lbfgs_jit(
    obj, x0, history, ls, tol, max_iterations, value_and_grad_fn,
    direction_method, stall_limit,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    state = init_lbfgs_state(x0, history)
    return _result_from_state(
        _lbfgs_loop(vag, f, state, ls, tol, max_iterations, jnp.dot,
                    direction_method=direction_method,
                    stall_limit=stall_limit)
    )


def optimize_lbfgs(
    obj,
    x0: jax.Array,
    history: int = 10,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """Maximize a log-density with L-BFGS(m) + backtracking line search.

    The O(m·n) large-n path (BASELINE.md config 5). Same callback protocol,
    line search, tolerances, and in-band status contract as `optimize`.
    ``direction_method``: 'compact' (default; matmul-friendly BNS form) or
    'two_loop' (classic recursion). ``stall_limit=0`` disables the stall
    detector (exact reference behavior: crawl to the iteration cap).
    """
    return _optimize_lbfgs_jit(
        obj, x0, history, ls, tol, max_iterations, value_and_grad_fn,
        direction_method, stall_limit,
    )


def optimize_lbfgs_from_state(
    obj,
    state: LBFGSState,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """Resume an L-BFGS solve from a saved state (history ring included)."""
    return _optimize_lbfgs_from_state_jit(
        obj, state, ls, tol, max_iterations, value_and_grad_fn,
        direction_method, stall_limit,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "ls", "max_iterations", "value_and_grad_fn",
        "direction_method", "stall_limit",
    ),
)
def _optimize_lbfgs_from_state_jit(
    obj, state, ls, tol, max_iterations, value_and_grad_fn,
    direction_method, stall_limit,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    # re-arm + fresh stall budget (see _optimize_from_state_jit)
    state = state._replace(
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        stall=jnp.zeros_like(state.stall),
    )
    return _result_from_state(
        _lbfgs_loop(vag, f, state, ls, tol, max_iterations, jnp.dot,
                    direction_method=direction_method,
                    stall_limit=stall_limit)
    )
