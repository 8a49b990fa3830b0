"""First-class vmap batching of whole solves.

The reference's answer to many simultaneous solves is `PtrBFGSState` — carve
one preallocated buffer into per-thread solver states and run them
side-by-side on CPU threads (reference: src/QuasiNewtonMethods.jl:117-121,
the multi-chain HMC-init workload of README.md:14). The JAX answer is
`jax.vmap` over the entire solve: every leaf of the BFGSState carry gains a
leading batch axis, the two nested `lax.while_loop`s batch lockstep (JAX
rewrites the predicate to "any lane still active" and freezes finished lanes
by select), and the per-iteration work becomes batched matvecs/outer
products. On an accelerator ``backend="auto"`` takes the fused batch-minor
engine (batched_solve.py) instead; see `utils.device`.

Lockstep caveat (SURVEY.md §7 hard parts): a batch runs until its slowest
lane converges; converged lanes are frozen (status != RUNNING short-circuits
their body via the solver's finish branch) so no NaN pollution occurs, but
wall-clock follows the straggler. For heterogeneous workloads, split into
shards and use parallel.mesh to spread shards over chips.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..api import as_value_and_grad, as_value_fn
from ..lbfgs_solve import _lbfgs_loop
from ..lbfgs_solve import _result_from_state as _lbfgs_result_from_state
from ..ops.linesearch import BackTracking
from ..solve import (
    MAX_ITERATIONS_DEFAULT,
    STALL_LIMIT_DEFAULT,
    OptimizeResult,
    _result_from_state,
    _solve_loop,
)
from ..state import init_bfgs_state, init_lbfgs_state
from ..utils.device import default_fleet_backend

__all__ = ["optimize_batched", "optimize_lbfgs_batched"]


@partial(
    jax.jit,
    static_argnames=("obj", "ls", "max_iterations", "value_and_grad_fn",
                     "stall_limit"),
)
def _optimize_batched_jit(
    obj, x0s, ls, tol, max_iterations, value_and_grad_fn,
    stall_limit=STALL_LIMIT_DEFAULT,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)

    def solve_one(x0):
        state = init_bfgs_state(x0)
        return _result_from_state(
            _solve_loop(vag, f, state, ls, tol, max_iterations,
                        stall_limit=stall_limit, peel_first=True)
        )

    return jax.vmap(solve_one)(x0s)


def optimize_batched(
    obj,
    x0s: jax.Array,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    backend: str = "auto",
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
    unroll: int = 1,
) -> OptimizeResult:
    """Run ``x0s.shape[0]`` independent BFGS solves in one XLA computation.

    Args:
      obj: logdensity callable or ProbabilityModel (shared across the batch —
        the HMC-chain-init pattern: one model, many starting points).
      x0s: (batch, n) starting points. Every result field gains the leading
        batch axis; check ``result.status`` per-lane.
      backend: 'fused' = the native batch-minor driver (throughput path,
        batched_solve.py), 'vmap' = jax.vmap of the scalar solver, 'auto' =
        fused on an accelerator, vmap on the CPU
        (`utils.device.default_fleet_backend`; the fused path is correct
        everywhere).

    Returns:
      OptimizeResult pytree with leading batch dimension on every leaf.
    """
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")

    if backend == "auto":
        backend = default_fleet_backend()
    if backend == "fused":
        from ..batched_solve import optimize_batched_fused

        return optimize_batched_fused(
            obj, x0s, ls, tol, max_iterations, value_and_grad_fn,
            stall_limit=stall_limit, fold_eval=fold_eval, unroll=unroll,
        )
    if backend != "vmap":
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'fused' or 'vmap'")
    if fold_eval or unroll != 1:
        raise ValueError("fold_eval/unroll are fused-engine options; use backend='fused'")
    return _optimize_batched_jit(
        obj, x0s, ls, tol, max_iterations, value_and_grad_fn, stall_limit
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "history", "ls", "max_iterations", "value_and_grad_fn",
        "direction_method", "stall_limit",
    ),
)
def _optimize_lbfgs_batched_jit(
    obj, x0s, history, ls, tol, max_iterations, value_and_grad_fn,
    direction_method, stall_limit=STALL_LIMIT_DEFAULT,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)

    def solve_one(x0):
        state = init_lbfgs_state(x0, history)
        return _lbfgs_result_from_state(
            _lbfgs_loop(vag, f, state, ls, tol, max_iterations, jnp.dot,
                        direction_method=direction_method,
                        stall_limit=stall_limit)
        )

    return jax.vmap(solve_one)(x0s)


def optimize_lbfgs_batched(
    obj,
    x0s: jax.Array,
    history: int = 10,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    backend: str = "fused",
    stall_limit: int = STALL_LIMIT_DEFAULT,
    gram_precision=None,
    unroll: int = 1,
):
    """Batched L-BFGS fleet: many independent large-n solves in one XLA
    computation (O(batch * m * n) memory — the regime where per-lane dense
    (n, n) inverse Hessians would not fit).

    ``backend='fused'`` (default) is the masked-lockstep engine
    (lbfgs_batched_solve.py): explicit active-lane masks keep frozen lanes
    out of every nested loop, and the BNS compact direction runs as batched
    einsums — profiled ~20x faster than the vmap engine, whose frozen
    lanes' discarded branches drag every lane through their garbage line
    searches. ``backend='vmap'`` keeps the jax.vmap-of-scalar engine (the
    equivalence oracle; honors ``direction_method``).
    Returns an LBFGSResult with a leading batch axis on every leaf.
    """
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    if backend == "fused":
        from ..lbfgs_batched_solve import optimize_lbfgs_batched_fused

        return optimize_lbfgs_batched_fused(
            obj, x0s, history, ls, tol, max_iterations, value_and_grad_fn,
            stall_limit, gram_precision, unroll,
        )
    if backend != "vmap":
        raise ValueError(f"unknown backend {backend!r}; use 'fused' or 'vmap'")
    if unroll != 1:
        raise ValueError("unroll is a fused-engine option; use backend='fused'")
    return _optimize_lbfgs_batched_jit(
        obj, x0s, history, ls, tol, max_iterations, value_and_grad_fn,
        direction_method, stall_limit,
    )
