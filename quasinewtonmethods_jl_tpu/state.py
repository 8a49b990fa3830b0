"""Solver state pytrees — the accelerator-native analog of the reference's BFGSState.

The reference packs all solver memory into one preallocated, SIMD-padded
mutable struct of inline tuples (reference: src/QuasiNewtonMethods.jl:82-150,
`BFGSState{P,T,L,LT}` with L = align(P, vector_width)) accessed through raw
pointers. Under XLA none of that machinery is needed: XLA owns buffers, shapes
are static under jit, and "views" become functional threading of a NamedTuple
through a `lax.while_loop` carry. What *is* preserved:

  * every array is static-shape, so one compilation serves every solve;
  * the full solver state is a single flat pytree — trivially serializable
    (checkpoint/resume, utils/checkpoint.py) and trivially batchable
    (`jax.vmap` maps over a leading axis of every leaf), which is the JAX
    replacement for the reference's `PtrBFGSState` carve-a-state-out-of-a-
    shared-buffer pattern (:117-121);
  * in-band status/failure signaling instead of exceptions (the reference
    uses NaN / alpha==0 sentinels; we carry an int status code because
    `lax.while_loop` cannot raise).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["Status", "BFGSState", "LBFGSState", "init_bfgs_state", "init_lbfgs_state"]


class Status(enum.IntEnum):
    """In-band solver status (replaces the reference's NaN / 0.0 sentinels,
    src/QuasiNewtonMethods.jl:193, :291)."""

    RUNNING = 0
    CONVERGED = 1  # max|grad| < tol                      (:257-262)
    MAX_ITERATIONS = 2  # outer-iteration cap hit         (:250, N=10_000)
    LINESEARCH_FAILURE = 3  # line search returned alpha==0 (:284)
    NONFINITE_VALUE = 4  # logdensity became non-finite    (:255)


class BFGSState(NamedTuple):
    """Full-matrix BFGS solver state (carry of the solve while-loop).

    Field correspondence with the reference struct (src/QuasiNewtonMethods.jl:84-92):
      x         <-> x_old   (current iterate; `optimum` reads it, :149)
      grad      <-> ∇_new   (gradient at x; `gradient` reads it, :150)
      grad_old  <-> ∇_old
      step      <-> s       (last *accepted* step, already scaled by alpha —
                             the reference stores alpha*s in place, :21-27)
      B         <-> B⁻¹     (inverse-Hessian approximation)
    x_new / y / B⁻¹y need no fields — they are loop-local temporaries that
    XLA materializes (or fuses away) on its own.
    """

    x: jax.Array  # (n,)
    grad: jax.Array  # (n,)
    grad_old: jax.Array  # (n,)
    step: jax.Array  # (n,)
    B: jax.Array  # (n, n)
    fun: jax.Array  # () latest objective value (NaN until first eval)
    k: jax.Array  # () int32 outer-iteration counter
    status: jax.Array  # () int32 Status code
    n_fev: jax.Array  # () int32 objective evaluations
    n_gev: jax.Array  # () int32 gradient evaluations
    n_resets: jax.Array  # () int32 steepest-ascent restarts (m <= 0 path)
    fresh: jax.Array  # () bool: B is an unscaled fresh identity (enables
    #     the H0 scaling on the next update; set after init and every reset)
    stall: jax.Array  # () int32: consecutive iterations without a strict
    #     objective increase (stall detector; see solve.STALL_LIMIT_DEFAULT)


class LBFGSState(NamedTuple):
    """Limited-memory BFGS state: (m, n) history rings instead of an (n, n) B.

    Capability beyond the reference (which is dense-B only and targets small
    n) — this is the large-n path, O(m·n) memory, shardable across devices.
    """

    x: jax.Array  # (n,)
    grad: jax.Array  # (n,)
    grad_old: jax.Array  # (n,)
    step: jax.Array  # (n,) last accepted step
    S: jax.Array  # (m, n) step history ring buffer
    Y: jax.Array  # (m, n) gradient-difference history ring buffer
    rho: jax.Array  # (m,) 1 / sᵀy per ring slot
    hist: jax.Array  # () int32 number of valid history pairs (<= m)
    gamma: jax.Array  # () H0 scaling sᵀy / yᵀy
    fun: jax.Array
    k: jax.Array
    status: jax.Array
    n_fev: jax.Array
    n_gev: jax.Array
    n_resets: jax.Array
    stall: jax.Array  # () int32 consecutive no-improvement iterations


def _zero_i32():
    return jnp.zeros((), jnp.int32)


def init_bfgs_state(x0: jax.Array) -> BFGSState:
    """Fresh solver state at the starting point (analog of
    ``BFGSState{P}(undef)`` + the driver's copyto!, :96-99, :248)."""
    x0 = jnp.asarray(x0)
    if x0.ndim != 1:
        raise ValueError(f"x0 must be a rank-1 array, got shape {x0.shape}")
    n = x0.shape[0]
    dtype = x0.dtype
    z = jnp.zeros((n,), dtype)
    return BFGSState(
        x=x0,
        grad=z,
        grad_old=z,
        step=z,
        B=jnp.eye(n, dtype=dtype),
        fun=jnp.asarray(jnp.nan, dtype),
        k=_zero_i32(),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        n_fev=_zero_i32(),
        n_gev=_zero_i32(),
        n_resets=_zero_i32(),
        fresh=jnp.asarray(True),
        stall=_zero_i32(),
    )


def init_lbfgs_state(x0: jax.Array, history: int = 10) -> LBFGSState:
    """Fresh L-BFGS state with an m-slot history ring."""
    x0 = jnp.asarray(x0)
    if x0.ndim != 1:
        raise ValueError(f"x0 must be a rank-1 array, got shape {x0.shape}")
    n = x0.shape[0]
    dtype = x0.dtype
    z = jnp.zeros((n,), dtype)
    return LBFGSState(
        x=x0,
        grad=z,
        grad_old=z,
        step=z,
        S=jnp.zeros((history, n), dtype),
        Y=jnp.zeros((history, n), dtype),
        rho=jnp.zeros((history,), dtype),
        hist=_zero_i32(),
        gamma=jnp.ones((), dtype),
        fun=jnp.asarray(jnp.nan, dtype),
        k=_zero_i32(),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        n_fev=_zero_i32(),
        n_gev=_zero_i32(),
        n_resets=_zero_i32(),
        stall=_zero_i32(),
    )
