"""Minimization-convention adapter.

The library's native convention is MAXIMIZATION of a log-density — the
reference's API contract (src/QuasiNewtonMethods.jl:8-9: `logdensity`,
ascent directions, sufficient-increase Armijo; see SURVEY §3.3). Most
optimizer users arrive from scipy.optimize / jaxopt expecting
`minimize(fun, x0)`. This module is that thin, lossless shim: it negates
the objective (and analytic value_and_grad, when given), runs the native
engines unchanged, and flips the signs back on the way out (`fun`,
`last_value`, and `grad` — the gradient of the minimized function is the
negated log-density gradient).

Everything else is the native result contract: in-band Status codes,
`fun` NaN unless converged, resumable state, batched fleets via a
(batch, n) x0.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .ops.linesearch import BackTracking
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult

__all__ = ["minimize"]


class _Negated:
    """Hashable negation wrapper: jit caches key on the objective, so the
    wrapper must compare/hash by the wrapped callable (a fresh lambda per
    call would defeat the compilation cache)."""

    __slots__ = ("fun",)

    def __init__(self, fun: Callable):
        self.fun = fun

    def __call__(self, x):
        return -self.fun(x)

    def __hash__(self):
        return hash((_Negated, self.fun))

    def __eq__(self, other):
        return type(other) is _Negated and other.fun == self.fun


class _NegatedVag(_Negated):
    """Negation of an analytic value-and-grad callable."""

    def __call__(self, x):
        v, g = self.fun(x)
        return -v, jax.tree_util.tree_map(jnp.negative, g)

    def __hash__(self):
        return hash((_NegatedVag, self.fun))

    def __eq__(self, other):
        return type(other) is _NegatedVag and other.fun == self.fun


def _flip_signs(res):
    """fun/last_value/grad back to the minimization convention. The saved
    state keeps the INTERNAL (maximization) convention so it resumes
    through the native `*_from_state` entry points unchanged."""
    return res._replace(
        fun=-res.fun, last_value=-res.last_value, grad=-res.grad
    )


def minimize(
    fun: Callable,
    x0: jax.Array,
    *,
    method: str = "bfgs",
    history: int = 10,
    ls: Optional[BackTracking] = None,
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    ctol: float = 1e-8,
    **kwargs,
):
    """Minimize ``fun`` — the scipy-convention entry point.

    ``method``: 'bfgs' (dense inverse Hessian, the reference algorithm),
    'lbfgs' (limited memory, large n; ``history`` applies), 'tr'
    (trust-region Newton–Krylov — exact curvature via matrix-free HVPs;
    ``bounds=``/``max_cg=``/``cg_tol=`` pass through kwargs; ``ls`` and
    ``h0_scale`` do not apply), or 'cg' (nonlinear conjugate gradients —
    O(n) state for very large n; the β formula is selected with
    ``cg_method='hz'|'pr'|'fr'|'dy'`` since ``method`` itself names the
    engine here). ``ls=None`` (the default) resolves to each engine's own
    default line search — BackTracking() for bfgs/lbfgs, Wolfe(approx=True)
    for cg and the constrained route; an explicitly-passed ``ls``
    (including a default-hyperparameter BackTracking()) always passes
    through verbatim. A rank-1 x0
    runs a single solve; a rank-2 (batch, n) x0 runs the batched fleet
    engine (`optimize_batched` / `optimize_lbfgs_batched`), with every
    result leaf carrying the batch axis. Extra keyword args pass through
    to the underlying driver (e.g. ``fold_eval=`` / ``backend=`` for
    batched BFGS, ``gram_precision=`` for batched L-BFGS).

    Constraints (the scipy-shaped surface): ``eq``/``ineq`` are
    jax-differentiable callables with the feasible set eq(x) = 0,
    ineq(x) ≥ 0 — given either, the solve routes through
    `optimize_auglag` with ``method`` as the inner engine (a rank-2
    (batch, n) x0 runs the masked-lockstep constrained fleet;
    ``ctol`` is the feasibility tolerance, and auglag knobs —
    ``rho0=``, ``max_outer=``, ``lam0=``/``mu0=``, ... — pass through
    kwargs). The returned `AugLagResult` has ``fun``/``grad`` flipped to
    the minimization convention; ``lam``/``mu`` need NO flip — they are
    exactly the multipliers of the minimization Lagrangian
    L = fun + λᵀ·eq − μᵀ·ineq (μ ≥ 0), KKT-tested both ways.

    Returns the native result type with ``fun``, ``last_value`` and
    ``grad`` in the minimization convention: `res.fun` is the minimized
    value on convergence (NaN otherwise, the in-band failure contract) and
    `res.grad` is the gradient of ``fun`` at `res.x`. ``res.state`` stays
    in the internal maximization convention so it feeds the native
    ``*_from_state`` resume entry points directly.
    """
    from .parallel.batch import optimize_batched, optimize_lbfgs_batched
    from .lbfgs_solve import optimize_lbfgs
    from .solve import optimize

    obj = _Negated(fun)
    vag = _NegatedVag(value_and_grad_fn) if value_and_grad_fn else None
    x0 = jnp.asarray(x0)
    batched = x0.ndim == 2

    if eq is not None or ineq is not None:
        from .constrained import optimize_auglag

        if method not in ("bfgs", "lbfgs", "cg", "tr"):
            raise ValueError(
                f"constrained minimize needs method in "
                f"'bfgs'/'lbfgs'/'cg'/'tr', got {method!r}"
            )
        # these knobs have no auglag counterpart — loud, not silent
        if h0_scale is not True:
            raise ValueError(
                "h0_scale does not apply to the constrained route "
                "(optimize_auglag's inner engines keep their defaults)"
            )
        if stall_limit != STALL_LIMIT_DEFAULT:
            raise ValueError(
                "stall_limit does not apply to the constrained route "
                "(optimize_auglag's inner engines keep their defaults)"
            )
        # ls=None defers to auglag's own default (HZ approximate Wolfe —
        # the |F*|>0 endgame needs it); an explicit ls — including an
        # explicit default-hyperparameter BackTracking() — passes through
        res = optimize_auglag(
            obj, x0, eq=eq, ineq=ineq, engine=method, tol=tol, ctol=ctol,
            max_iterations=max_iterations,
            lam0=kwargs.pop("lam0", None), mu0=kwargs.pop("mu0", None),
            ls=ls,
            history=history, value_and_grad_fn=vag, **kwargs,
        )
        # lam/mu/viol/eq/ineq are convention-invariant (see docstring);
        # only the objective-valued fields flip
        return res._replace(
            fun=-res.fun, grad=-res.grad, last_value=-res.last_value
        )

    # ls=None resolves per engine: BackTracking() for the bfgs/lbfgs
    # family, the engine's own Wolfe(approx=True) for cg, nothing for tr
    if ls is None:
        ls_bt = BackTracking()
    else:
        ls_bt = ls

    if method == "bfgs":
        if batched:
            # the batched router keeps h0_scale at its engine default (on);
            # pass fold_eval=/backend= through kwargs
            res = optimize_batched(
                obj, x0, ls=ls_bt, tol=tol, max_iterations=max_iterations,
                value_and_grad_fn=vag,
                stall_limit=stall_limit, **kwargs,
            )
        else:
            res = optimize(
                obj, x0, ls=ls_bt, tol=tol, max_iterations=max_iterations,
                value_and_grad_fn=vag, h0_scale=h0_scale,
                stall_limit=stall_limit, **kwargs,
            )
    elif method == "lbfgs":
        if batched:
            res = optimize_lbfgs_batched(
                obj, x0, history=history, ls=ls_bt, tol=tol,
                max_iterations=max_iterations, value_and_grad_fn=vag,
                stall_limit=stall_limit, **kwargs,
            )
        else:
            res = optimize_lbfgs(
                obj, x0, history=history, ls=ls_bt, tol=tol,
                max_iterations=max_iterations, value_and_grad_fn=vag,
                stall_limit=stall_limit, **kwargs,
            )
    elif method == "tr":
        from .trust_region import optimize_tr

        # ls/h0_scale/history are line-search/secant knobs — not
        # applicable; TR knobs (bounds=, max_cg=, cg_tol=, delta0=, ...)
        # pass through kwargs
        if ls is not None:
            raise ValueError(
                "ls does not apply to method='tr' (trust region has no "
                "line search)"
            )
        res = optimize_tr(
            obj, x0, tol=tol, max_iterations=max_iterations,
            value_and_grad_fn=vag, **kwargs,
        )
    elif method == "cg":
        from .cg_solve import optimize_cg

        # ls=None → the engine's own Wolfe(approx=True) default (CG's β
        # quality needs the curvature condition); any explicit ls —
        # including an explicit default BackTracking() — passes through
        if ls is not None:
            kwargs = {"ls": ls, **kwargs}
        # `method` names the engine in this shim, so the β formula rides
        # the `cg_method` kwarg
        if "cg_method" in kwargs:
            kwargs["method"] = kwargs.pop("cg_method")
        res = optimize_cg(
            obj, x0, tol=tol, max_iterations=max_iterations,
            value_and_grad_fn=vag, stall_limit=stall_limit, **kwargs,
        )
    else:
        raise ValueError(
            f"method must be 'bfgs', 'lbfgs', 'tr', or 'cg', got {method!r}"
        )
    return _flip_signs(res)
