"""The BFGS maximization driver — one jitted `lax.while_loop`.

accelerator-native re-expression of the reference driver `optimize!`
(reference: src/QuasiNewtonMethods.jl:237-292). The reference's imperative
loop with mid-loop breaks and pointer swaps becomes a single
`lax.while_loop` whose carry is the full BFGSState pytree; `break`s become
status codes, the ∇_old↔∇_new / s↔y pointer swaps (:268, :286) become
functional rebinding (free under XLA), and the in-band NaN/0.0 failure
sentinels become the Status enum.

Per-iteration structure, kept identical to the reference:
  1. evaluate value + gradient at the current iterate        (:254)
  2. break on non-finite value                               (:255)
  3. converge when max|grad| < tol, returning the value      (:257-262)
  4. first iteration: sentinel m = -1; otherwise the rank-2
     inverse-BFGS update producing direction d and m = ∇ᵀB⁻¹∇ (:263-268)
  5. m <= 0: reset B=I, d=grad, m=‖grad‖² (steepest ascent)   (:272-280)
  6. backtracking line search; alpha==0 -> failure            (:283-284)
  7. x += alpha*d; remember the scaled step and the gradient  (:285-286)

Failure contract preserved: `fun` in the result is the reference's return
value — the converged log-density, or NaN on *any* failure path (:291). The
richer diagnostics the reference only had as commented-out @show lines
(:251-256) are first-class here: status, iteration count, f/g eval counts,
reset count, and the final state (reusable for resume).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .ops.bfgs import bfgs_update, dfp_update, initial_inv_hessian, sr1_update

# Broyden-family inverse updates selectable on the dense driver
# (beyond-reference breadth; the reference is BFGS-only, :34-69).
_UPDATE_FNS = {"bfgs": bfgs_update, "dfp": dfp_update, "sr1": sr1_update}
from .ops.linesearch import BackTracking, run_linesearch
from .state import BFGSState, Status, init_bfgs_state

__all__ = ["OptimizeResult", "optimize", "optimize_from_state", "MAX_ITERATIONS_DEFAULT"]

# The reference hardcodes N = 10_000 outer iterations (:250).
MAX_ITERATIONS_DEFAULT = 10_000

# Stall detector: a MONOTONE ascent method that fails to strictly increase
# the objective for this many consecutive iterations is grinding below
# floating-point measurement precision (the line search keeps "accepting"
# absorption-level steps); exit in-band instead of crawling to the
# iteration cap. The reference would crawl (same class of outcome, reached
# 200x slower). Set stall_limit=0 to disable (exact reference behavior).
STALL_LIMIT_DEFAULT = 50


class OptimizeResult(NamedTuple):
    """Solve result. ``fun`` keeps the reference's in-band contract: the
    maximized log-density on convergence, NaN otherwise. ``last_value`` is
    the final objective value regardless of status (diagnostic)."""

    x: jax.Array  # final iterate (reference `optimum`, :149)
    fun: jax.Array  # converged value or NaN (reference return, :261/:291)
    grad: jax.Array  # gradient at x (reference `gradient`, :150)
    status: jax.Array  # int32 Status code
    iterations: jax.Array  # int32 outer iterations executed
    n_fev: jax.Array  # int32 objective evaluations
    n_gev: jax.Array  # int32 gradient evaluations
    n_resets: jax.Array  # int32 steepest-ascent restarts
    last_value: jax.Array  # final objective value (even on failure)
    state: BFGSState  # full state, resumable via optimize_from_state

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


def _solve_loop(
    vag: Callable,
    f: Callable,
    state: BFGSState,
    ls: BackTracking,
    tol,
    max_iterations: int,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    peel_first: bool = False,
    update_method: str = "bfgs",
) -> BFGSState:
    """Rotated driver loop (round-4 scalar-latency redesign).

    The loop is ROTATED relative to the reference's ``for`` loop: each
    while-loop body runs [update -> line search -> step -> evaluate at the
    NEW iterate -> classify], carrying the invariant that ``(s.fun,
    s.grad)`` always hold the evaluation at ``s.x``. The initial
    evaluation and the sentinel first iteration (m = -1, :263-264) are
    peeled in front. This removes the per-iteration
    ``lax.cond(finish/advance)`` of the direct transcription — measured at
    +2.4 us/iteration on XLA-CPU (the cond joins full-state operands
    including the (n, n) B) — for a 1.66x scalar-solve speedup (1139 ->
    688 us typical Rosenbrock n=60) with bitwise-identical values and
    exact counter parity.

    Trajectory semantics are unchanged: the body advances only states the
    while-condition proved RUNNING, so no masking is needed; a line-search
    failure overrides the trailing classification (the trailing evaluation
    re-evaluates the unmoved x — bitwise the carried value — and is not
    counted, preserving the reference's eval counts).

    ``peel_first`` keeps its meaning (fresh solves, k == 0 statically
    known): it decides whether the sentinel peel is emitted inline or
    behind a once-per-solve runtime ``k == 0`` cond (resume paths).
    """
    n = state.x.shape[0]
    dtype = state.x.dtype
    tol = jnp.asarray(tol, dtype)
    eye = initial_inv_hessian(n, dtype)
    if max_iterations < 1:
        # no iteration budget: no evaluation happens at all (matches the
        # batched engines and the reference's 1:N loop with N = 0)
        return state._replace(
            status=jnp.where(
                state.status == Status.RUNNING,
                jnp.int32(Status.MAX_ITERATIONS),
                state.status,
            )
        )
    if update_method not in _UPDATE_FNS:
        raise ValueError(
            f"update_method must be one of {sorted(_UPDATE_FNS)}, "
            f"got {update_method!r}"
        )
    update_fn = _UPDATE_FNS[update_method]

    def classify(f1, g1, prev_fun, prev_stall):
        """Status determination for the evaluation (f1, g1) at the current
        iterate. Non-finite precedes convergence, matching :255 / :257."""
        nonfinite = ~jnp.isfinite(f1)
        converged = jnp.max(jnp.abs(g1)) < tol
        improved = jnp.where(jnp.isnan(prev_fun), True, f1 > prev_fun)
        stall = jnp.where(improved, jnp.int32(0), prev_stall + 1)
        stalled = (stall >= stall_limit) if stall_limit else jnp.asarray(False)
        status = jnp.where(
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
        return status, stall

    def advance(s: BFGSState, first: bool) -> BFGSState:
        # rotation invariant: (s.fun, s.grad) are the eval at s.x
        f0, g = s.fun, s.grad
        if first:
            # sentinel m = -1 forces the steepest-ascent branch (:263-264)
            B1, d, m = s.B, jnp.zeros_like(g), jnp.asarray(-1.0, dtype)
        else:
            # H0 scaling (Nocedal 6.20) when B is a fresh identity —
            # documented improvement over the reference; h0_scale=False
            # restores exact reference semantics.
            B1, d, m = update_fn(
                s.B, s.step, g, s.grad_old,
                fresh=s.fresh if h0_scale else None,
            )

        # m <= 0: indefinite curvature — reset to identity and take the
        # steepest-ascent direction (:272-280). NaN m deliberately does
        # NOT reset (NaN <= 0 is false), matching the reference's IEEE
        # in-band failure propagation.
        reset = m <= 0.0
        B2 = jnp.where(reset, eye, B1)
        d = jnp.where(reset, g, d)
        m = jnp.where(reset, jnp.dot(g, g, preferred_element_type=dtype), m)

        # BackTracking trials are value-only (the reference's step! ->
        # logdensity path, :157-162 — never pay for a backward pass);
        # Wolfe trials use value+slope.
        alpha, ls_failed, ls_fev, ls_gev = run_linesearch(
            ls, f, vag, s.x, d, f0, m
        )
        # On failure x must stay at the last good iterate (the reference
        # breaks before update_state!, :284-285). alpha is 0 then, but
        # 0 * d is NaN when the direction itself is NaN (degenerate
        # update), so the masking must be explicit.
        step = jnp.where(ls_failed, jnp.zeros_like(d), alpha * d)
        x_new = s.x + step

        f1, g1 = vag(x_new)
        status, stall = classify(f1, g1, f0, s.stall)
        # the failure exit keeps the stall value the failing iteration
        # entered with (the old driver stored the top-of-iteration stall)
        status = jnp.where(
            ls_failed, jnp.int32(Status.LINESEARCH_FAILURE), status
        )
        stall = jnp.where(ls_failed, s.stall, stall)
        # on failure the trailing eval re-evaluated the unmoved x (bitwise
        # the carried values) and is not counted — the reference exits
        # without re-evaluating
        cnt = (~ls_failed).astype(jnp.int32)
        return BFGSState(
            x=x_new,
            grad=g1,
            grad_old=g,
            step=step,
            B=B2,
            fun=f1,
            k=s.k + 1,
            status=status,
            n_fev=s.n_fev + ls_fev + cnt,
            n_gev=s.n_gev + ls_gev + cnt,
            n_resets=s.n_resets + reset.astype(jnp.int32),
            fresh=reset,  # reset leaves a fresh identity behind
            stall=stall,
        )

    def live(s: BFGSState):
        return jnp.logical_and(
            s.status == Status.RUNNING, s.k < max_iterations
        )

    # peel 0: evaluate at the entry iterate and classify
    f0, g0 = vag(state.x)
    status0, stall0 = classify(f0, g0, state.fun, state.stall)
    state = state._replace(
        fun=f0, grad=g0, status=status0, stall=stall0,
        n_fev=state.n_fev + 1, n_gev=state.n_gev + 1,
    )

    # peel 1: the sentinel first iteration. Fresh solves (peel_first) have
    # k == 0 statically; resume paths gate it behind a ONE-TIME runtime
    # cond (vs the old design's per-iteration branch).
    if peel_first:
        state = lax.cond(
            live(state), lambda s: advance(s, True), lambda s: s, state
        )
    else:
        state = lax.cond(
            jnp.logical_and(live(state), state.k == 0),
            lambda s: advance(s, True),
            lambda s: s,
            state,
        )

    final = lax.while_loop(live, lambda s: advance(s, False), state)
    # Loop exhausted while still RUNNING -> iteration cap (reference falls
    # off the for-loop and returns NaN, :288-291).
    return final._replace(
        status=jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            final.status,
        )
    )


def _result_from_state(state: BFGSState) -> OptimizeResult:
    nan = jnp.asarray(jnp.nan, state.x.dtype)
    return OptimizeResult(
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
        "obj", "ls", "max_iterations", "value_and_grad_fn", "h0_scale",
        "stall_limit", "update_method",
    ),
)
def _optimize_jit(
    obj, x0, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
    stall_limit, update_method="bfgs",
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    state = init_bfgs_state(x0)
    return _result_from_state(
        _solve_loop(vag, f, state, ls, tol, max_iterations, h0_scale,
                    stall_limit, peel_first=True, update_method=update_method)
    )


def optimize(
    obj,
    x0: jax.Array,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    jit: bool = True,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    update_method: str = "bfgs",
) -> OptimizeResult:
    """Maximize a log-density with BFGS + backtracking line search.

    The functional analog of ``optimize!(state, obj, x, ls, tol)``
    (src/QuasiNewtonMethods.jl:237). ``obj`` is a pure
    ``logdensity(theta) -> scalar`` callable or a ProbabilityModel; an
    analytic value-and-gradient can be supplied via ``value_and_grad_fn``
    (the ∂logdensity! analog). Maximization convention.

    ``update_method`` selects the Broyden-family inverse update:
    ``"bfgs"`` (default — the reference algorithm), ``"dfp"``, or
    ``"sr1"`` (rank-1, standard angle-based skip safeguard; indefinite
    curvature is absorbed by the m <= 0 steepest-ascent reset).

    ``h0_scale=True`` (default) applies the Barzilai–Borwein H0 scaling to
    fresh identity inverse-Hessians (Nocedal 6.20) — a documented
    improvement over the reference that cut median iteration counts ~2.5x
    on the benchmark fleet; set False for exact reference semantics.

    With jit=True (default) the entire solve — driver loop, line search,
    and the user objective — compiles to one XLA computation; the objective
    and configs must then be hashable (use a def/named function or a
    ProbabilityModel instance, not a fresh lambda per call, to benefit from
    the compilation cache).
    """
    if jit:
        return _optimize_jit(
            obj, x0, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
            stall_limit, update_method,
        )
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    state = init_bfgs_state(x0)
    return _result_from_state(
        _solve_loop(vag, f, state, ls, tol, max_iterations, h0_scale,
                    stall_limit, peel_first=True, update_method=update_method)
    )


def optimize_from_state(
    obj,
    state: BFGSState,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    update_method: str = "bfgs",
) -> OptimizeResult:
    """Resume a solve from a saved/checkpointed BFGSState.

    The reference's architecture is checkpoint-shaped — all progress lives in
    the flat state struct and a state can be re-fed to optimize!
    (test/runtests.jl:42,47); this is the explicit resume entry point. The
    state is re-armed to RUNNING so a converged state can also be re-solved
    under a tighter tolerance.
    """
    return _optimize_from_state_jit(
        obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
        stall_limit, update_method,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "ls", "max_iterations", "value_and_grad_fn", "h0_scale",
        "stall_limit", "update_method",
    ),
)
def _optimize_from_state_jit(
    obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
    stall_limit, update_method="bfgs",
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    # Re-arm, and clear the stall counter: a state that exited via the
    # stall detector carries stall == stall_limit and would otherwise
    # re-fail after exactly one iteration without attempting a step (the
    # resume leg gets a fresh no-improvement budget).
    state = state._replace(
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        stall=jnp.zeros_like(state.stall),
    )
    return _result_from_state(
        _solve_loop(vag, f, state, ls, tol, max_iterations, h0_scale,
                    stall_limit, update_method=update_method)
    )
