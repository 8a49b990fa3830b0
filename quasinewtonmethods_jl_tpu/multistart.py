"""Multi-start MAP: batched solves from many starts, best mode selected.

The batched engine's natural companion for multimodal or poorly-initialized
problems: run a fleet of solves from random (or user-provided) starting
points in one XLA computation and pick the best converged mode — the
workflow ProbabilityModels-style callers hand-roll around the reference
(README.md:14: many chains, one mode finder).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .ops.linesearch import BackTracking
from .parallel.batch import optimize_batched
from .solve import MAX_ITERATIONS_DEFAULT, OptimizeResult
from .state import Status
from .utils.device import default_dtype

__all__ = ["MultistartResult", "optimize_multistart"]


class MultistartResult(NamedTuple):
    x: jax.Array  # (n,) best converged iterate
    fun: jax.Array  # () its log-density (NaN if no start converged)
    best_index: jax.Array  # () int32 index into the fleet
    n_converged: jax.Array  # () int32
    fleet: OptimizeResult  # the full batched result (leading batch axis)

    @property
    def converged(self) -> jax.Array:
        return self.n_converged > 0


def optimize_multistart(
    obj,
    key: jax.Array,
    n_starts: int,
    dim: int,
    init_scale: float = 1.0,
    x0s: Optional[jax.Array] = None,
    ls: Optional[BackTracking] = None,
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    dtype=None,
    engine: str = "bfgs",
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    **batch_kwargs,
) -> MultistartResult:
    """Maximize from ``n_starts`` starting points; return the best mode.

    Starts are N(0, init_scale²) draws from ``key`` unless ``x0s``
    ((n_starts, dim)) is given. Only converged lanes compete; with zero
    converged lanes the result carries NaN fun and ``converged`` is False
    (the in-band contract, fleet-level).

    ``engine``: 'bfgs' (default, the fused fleet), 'tr' (the
    trust-region Newton–Krylov fleet — prefer it when random starts land
    in stiff or saddle-ridden regions, exactly where secant updates get
    corrupted; `ls` does not apply, TR knobs like ``bounds=``/``max_cg=``
    pass through ``batch_kwargs``), or 'cg' (the O(n)-state nonlinear-CG
    fleet — for very large dim where per-lane curvature state would
    dominate fleet memory; a `Wolfe` can be passed via ``ls``, CG knobs
    like ``method=``/``restart_nu=`` pass through ``batch_kwargs``). The
    result's ``fleet`` field carries the engine's native result type
    either way.

    Constrained multistart (round 5): given ``eq``/``ineq``, the fleet
    routes through the constrained auglag fleet with ``engine`` as the
    INNER solve ('bfgs'/'lbfgs'/'cg'/'tr'; auglag knobs — ``ctol=``,
    ``rho0=``, ``max_outer=``, ... — pass through ``batch_kwargs``).
    Constrained problems are often multimodal exactly BECAUSE of the
    feasible set's boundary (distinct KKT points on different faces) —
    only KKT-certified lanes compete, and ``fleet`` is the full
    `AugLagResult` (per-lane multipliers included).
    """
    if x0s is None:
        if dtype is None:
            dtype = default_dtype()
        x0s = init_scale * jax.random.normal(key, (n_starts, dim), dtype)
    else:
        x0s = jnp.asarray(x0s)

    if eq is not None or ineq is not None:
        from .constrained import optimize_auglag

        # ls=None defers to auglag's Wolfe(approx=True) default; an
        # explicit ls — including an explicit default BackTracking() —
        # passes through (the minimize ls=None convention; a
        # `ls == BackTracking()` sentinel cannot tell explicit intent
        # from the signature default)
        fleet = optimize_auglag(
            obj, x0s, eq=eq, ineq=ineq, engine=engine, tol=tol,
            max_iterations=max_iterations,
            value_and_grad_fn=value_and_grad_fn, ls=ls,
            **batch_kwargs,
        )
        ok = fleet.status == Status.CONVERGED
        score = jnp.where(ok, fleet.fun, -jnp.inf)
        best = jnp.argmax(score)
        n_conv = jnp.sum(ok).astype(jnp.int32)
        nan = jnp.asarray(jnp.nan, fleet.fun.dtype)
        return MultistartResult(
            x=fleet.x[best],
            fun=jnp.where(n_conv > 0, fleet.fun[best], nan),
            best_index=best.astype(jnp.int32),
            n_converged=n_conv,
            fleet=fleet,
        )

    ls_bt = BackTracking() if ls is None else ls
    if engine == "bfgs":
        fleet = optimize_batched(
            obj, x0s, ls=ls_bt, tol=tol, max_iterations=max_iterations,
            value_and_grad_fn=value_and_grad_fn, **batch_kwargs,
        )
    elif engine == "tr":
        # stiff or locally indefinite basins: the trust-region fleet
        # (negative curvature ridden, not feared — multistart geometry
        # is exactly where secant updates get corrupted by saddles).
        # `ls` is a line-search knob and does not apply.
        from .trust_region import optimize_tr

        fleet = optimize_tr(
            obj, x0s, tol=tol, max_iterations=max_iterations,
            value_and_grad_fn=value_and_grad_fn, **batch_kwargs,
        )
    elif engine == "cg":
        from .cg_solve import optimize_cg
        from .ops.wolfe import Wolfe

        # ls=None -> the engine's Wolfe(approx=True) default (same rule
        # as minimize(method='cg')); any explicit ls passes through
        cg_ls = Wolfe(approx=True) if ls is None else ls
        fleet = optimize_cg(
            obj, x0s, ls=cg_ls, tol=tol, max_iterations=max_iterations,
            value_and_grad_fn=value_and_grad_fn, **batch_kwargs,
        )
    else:
        raise ValueError(
            f"engine must be 'bfgs', 'tr', or 'cg', got {engine!r}"
        )
    ok = fleet.status == Status.CONVERGED
    # fleet.fun is NaN on non-converged lanes already; argmax over a
    # -inf-masked copy picks the best converged mode deterministically.
    score = jnp.where(ok, fleet.last_value, -jnp.inf)
    best = jnp.argmax(score)
    n_conv = jnp.sum(ok).astype(jnp.int32)
    nan = jnp.asarray(jnp.nan, fleet.last_value.dtype)
    return MultistartResult(
        x=fleet.x[best],
        fun=jnp.where(n_conv > 0, fleet.last_value[best], nan),
        best_index=best.astype(jnp.int32),
        n_converged=n_conv,
        fleet=fleet,
    )
