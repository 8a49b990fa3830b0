"""Constrained optimization: augmented-Lagrangian outer loop over the
native engines.

The reference is an unconstrained maximizer (src/QuasiNewtonMethods.jl
:237-292); constrained MAP problems (simplexes, monotone orderings,
budget/feasibility sets) are usually handled upstream by reparametrizing
(`transforms.py` covers the smooth-bijection cases). This module covers
the cases a bijection cannot: GENERAL smooth equality and inequality
constraints, via the Powell–Hestenes–Rockafellar augmented Lagrangian
(the LANCELOT/ALGENCAN scheme, Nocedal & Wright ch. 17) in the library's
maximization convention:

    maximize f(x)  s.t.  eq(x) = 0,  ineq(x) >= 0

Each outer iteration maximizes the smooth augmented objective

    F(x) = f(x) − λᵀh − (ρ/2)‖h‖²  −  (1/2ρ) Σᵢ [max(0, μᵢ − ρ cᵢ)² − μᵢ²]

with any of the library's engines (BFGS / L-BFGS / CG / TR — the inner
solve is the same jitted machinery users already run unconstrained),
then does the first-order multiplier updates λ ← λ + ρ h(x*),
μ ← max(0, μ − ρ c(x*)) and grows ρ only when the KKT violation
max(|h|, |min(c, μ/ρ)|) failed to shrink by ``viol_decrease``.

Accelerator shape: ONE jitted program — the outer loop is a `lax.while_loop`
whose body inlines the engine's full solve (itself a while_loop), so a
20-outer-iteration constrained solve costs one compile and zero host
round-trips. The inner objective closes over the loop-carried (λ, μ, ρ)
tracers; no recompilation per outer iteration (the Python-loop
formulation would recompile the engine on every multiplier update).

Contracts (the library-wide ones): in-band failure — ``fun`` is NaN
unless the KKT certificate holds (inner max|∇L| < tol AND violation
≤ ctol); only a NON-FINITE objective is a hard inner failure that stops
the outer loop and reports that status — a line-search stall is soft
(the multiplier update re-centers the Lagrangian and the next round
usually certifies); the iterate is always the last inner solution.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .cg_solve import _cg_loop_batched, optimize_cg
from .lbfgs_solve import optimize_lbfgs
from .ops.linesearch import BackTracking
from .ops.wolfe import Wolfe
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, optimize
from .state import Status
from .trust_region import (
    _init_tr_state,
    _tr_body,
    _tr_cond,
    optimize_tr,
)

__all__ = ["AugLagResult", "optimize_auglag"]

_ENGINES = ("bfgs", "lbfgs", "cg", "tr")


class AugLagResult(NamedTuple):
    """Constrained solve result (in-band contract as everywhere):
    ``fun`` is f(x) when the KKT certificate holds — inner convergence
    (max|∇L| < tol) AND constraint violation ≤ ctol — and NaN otherwise.
    ``viol`` is the final KKT violation max(|eq|, |min(ineq, μ/ρ)|);
    ``eq``/``ineq`` the final constraint values ((0,) when absent);
    ``lam``/``mu`` the converged multipliers (the constraint shadow
    prices); ``inner_status`` the last inner engine status;
    ``last_value`` is f(x) at the final iterate regardless of status
    (the library-wide result convention)."""

    x: jax.Array
    fun: jax.Array
    grad: jax.Array  # ∇f at x (maximization orientation)
    status: jax.Array
    viol: jax.Array
    eq: jax.Array
    ineq: jax.Array
    lam: jax.Array
    mu: jax.Array
    rho: jax.Array
    n_outer: jax.Array
    iterations: jax.Array  # total inner iterations across outer rounds
    n_fev: jax.Array
    inner_status: jax.Array
    last_value: jax.Array  # f(x) at the final iterate, any status

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


class _Flat1D:
    """Hashable at-least-1d constraint wrapper: jit caches key on the
    callable, so the wrapper must compare/hash by the wrapped function
    (a fresh lambda per call would defeat the compilation cache).
    Extra positional args (per-lane ``constraint_data``) pass through."""

    __slots__ = ("fn", "__weakref__")  # jax.eval_shape weakref-caches fns

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x, *args):
        return jnp.atleast_1d(self.fn(x, *args))

    def __hash__(self):
        return hash((_Flat1D, self.fn))

    def __eq__(self, other):
        return type(other) is _Flat1D and other.fn == self.fn


def _run_engine(engine, F, x, F_vag, tol, max_iterations, ls, history,
                cg_method):
    """One inner maximize of the augmented objective; returns the common
    (x, status, iterations, n_fev) slice of the engine's result."""
    if engine == "bfgs":
        r = optimize(F, x, ls=ls, tol=tol, max_iterations=max_iterations,
                     value_and_grad_fn=F_vag, jit=False)
    elif engine == "lbfgs":
        r = optimize_lbfgs(F, x, history=history, ls=ls, tol=tol,
                           max_iterations=max_iterations,
                           value_and_grad_fn=F_vag)
    elif engine == "cg":
        r = optimize_cg(F, x, method=cg_method, ls=ls, tol=tol,
                        max_iterations=max_iterations,
                        value_and_grad_fn=F_vag)
    else:  # tr
        r = optimize_tr(F, x, tol=tol, max_iterations=max_iterations,
                        value_and_grad_fn=F_vag)
    return r.x, r.status, r.iterations, r.n_fev


@partial(
    jax.jit,
    static_argnames=(
        "obj", "eq", "ineq", "engine", "value_and_grad_fn", "ls",
        "max_outer", "max_iterations", "history", "cg_method",
        "tol", "ctol",  # tol is static in the TR engine's jit
    ),
)
def _auglag_core(
    obj, x0, eq, ineq, lam0, mu0, rho0, tol, ctol, rho_growth,
    viol_decrease, rho_max, engine, value_and_grad_fn, ls, max_outer,
    max_iterations, history, cg_method, cdata=None,
):
    vag_f = as_value_and_grad(obj, value_and_grad_fn)
    f_val = as_value_fn(obj, value_and_grad_fn)
    dtype = x0.dtype
    zero1 = jnp.zeros((0,), dtype)
    # constraint_data: constraints are fn(x, cdata) when given (the
    # `cdata is None` branch is a trace-time constant)
    ca = () if cdata is None else (cdata,)

    def h_of(x):
        return eq(x, *ca) if eq is not None else zero1

    def c_of(x):
        return ineq(x, *ca) if ineq is not None else zero1

    def violation(h, c, mu, rho):
        v = jnp.zeros((), dtype)
        if eq is not None:
            v = jnp.maximum(v, jnp.max(jnp.abs(h)))
        if ineq is not None:
            v = jnp.maximum(v, jnp.max(jnp.abs(jnp.minimum(c, mu / rho))))
        return v

    def penalty(x, lam, mu, rho):
        p = jnp.zeros((), dtype)
        if eq is not None:
            h = eq(x, *ca)
            p = p + jnp.dot(lam, h) + 0.5 * rho * jnp.dot(h, h)
        if ineq is not None:
            t = jnp.maximum(0.0, mu - rho * ineq(x, *ca))
            p = p + (0.5 / rho) * (jnp.dot(t, t) - jnp.dot(mu, mu))
        return p

    def body(carry):
        (x, lam, mu, rho, vprev, k, tot_it, tot_fev, _succ, _hard,
         _inner) = carry

        def F(xx):
            # value-only trials (line searches) never pay a gradient
            return f_val(xx) - penalty(xx, lam, mu, rho)

        def F_vag(xx):
            fv, fg = vag_f(xx)
            pv, pg = jax.value_and_grad(penalty)(xx, lam, mu, rho)
            return fv - pv, fg - pg

        x1, st, it, fev = _run_engine(
            engine, F, x, F_vag, tol, max_iterations, ls, history,
            cg_method,
        )
        h = h_of(x1)
        c = c_of(x1)
        v = violation(h, c, mu, rho)
        lam1 = lam + rho * h
        mu1 = jnp.maximum(0.0, mu - rho * c)
        success = (st == Status.CONVERGED) & (v <= ctol)
        # soft inner outcomes (iteration cap, line-search stall at the
        # fp floor of an ill-conditioned augmented objective) continue —
        # the multiplier update re-centers the Lagrangian and the next
        # round usually certifies; only a non-finite objective is hard
        hard = st == Status.NONFINITE_VALUE
        rho1 = jnp.where(
            v > viol_decrease * vprev,
            jnp.minimum(rho * rho_growth, rho_max),
            rho,
        )
        return (x1, lam1, mu1, rho1, v, k + 1, tot_it + it,
                tot_fev + fev, success, hard, st)

    def cond(carry):
        _x, _l, _m, _r, _v, k, _ti, _tf, succ, hard, _st = carry
        return (~succ) & (~hard) & (k < max_outer)

    carry0 = (
        x0, lam0, mu0, rho0, jnp.asarray(jnp.inf, dtype),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.asarray(False), jnp.asarray(False),
        jnp.asarray(Status.RUNNING, jnp.int32),
    )
    (x, lam, mu, rho, v, k, tot_it, tot_fev, success, hard,
     inner_st) = lax.while_loop(cond, body, carry0)

    fv, fg = vag_f(x)
    nan = jnp.asarray(jnp.nan, dtype)
    status = jnp.where(
        success,
        jnp.int32(Status.CONVERGED),
        jnp.where(hard, inner_st, jnp.int32(Status.MAX_ITERATIONS)),
    )
    return AugLagResult(
        x=x,
        fun=jnp.where(success, fv, nan),
        grad=fg,
        status=status,
        viol=v,
        eq=h_of(x),
        ineq=c_of(x),
        lam=lam,
        mu=mu,
        rho=rho,
        n_outer=k,
        iterations=tot_it,
        n_fev=tot_fev,
        inner_status=inner_st,
        last_value=fv,
    )


def optimize_auglag(
    obj,
    x0: jax.Array,
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    *,
    engine: str = "bfgs",
    tol: float = 1e-8,
    ctol: float = 1e-8,
    rho0: float = 10.0,
    rho_growth: float = 10.0,
    rho_max: float = 1e8,
    viol_decrease: float = 0.25,
    max_outer: int = 20,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    lam0: Optional[jax.Array] = None,
    mu0: Optional[jax.Array] = None,
    ls=None,
    history: int = 10,
    cg_method: str = "hz",
    value_and_grad_fn: Optional[Callable] = None,
    constraint_data=None,
) -> AugLagResult:
    """Maximize f(x) subject to eq(x) = 0 and ineq(x) >= 0.

    Powell–Hestenes–Rockafellar augmented Lagrangian: ``max_outer``
    rounds of [maximize the augmented objective with ``engine`` →
    first-order multiplier update → grow ρ if the violation stalled],
    compiled as ONE program (`lax.while_loop` outer, the engine's own
    while_loop inner — multipliers ride the carry, so there is no
    per-round recompilation and no host round-trip).

    ``eq``/``ineq``: jax-differentiable callables x ↦ (m,) (scalars are
    promoted); at least one required. ``engine``: 'bfgs' (default) /
    'lbfgs' / 'cg' / 'tr' — the same inner machinery as the
    unconstrained entry points (``ls`` defaults per engine; ``history``
    rides 'lbfgs', ``cg_method`` rides 'cg'). ``lam0``/``mu0`` warm-start
    the multipliers (defaults: zeros, i.e. the first round is a pure
    quadratic-penalty solve at ``rho0``).

    Checkpoint/resume: the outer state IS (x, λ, μ, ρ) — continue a
    truncated run with ``optimize_auglag(obj, r.x, ..., lam0=r.lam,
    mu0=r.mu, rho0=float(r.rho))`` (regression-tested: the chunked run
    reaches the same KKT point and multipliers as the one-shot run).

    Success = the KKT certificate: the last inner solve CONVERGED
    (max|∇ₓL| < ``tol``) AND the violation max(|eq|, |min(ineq, μ/ρ)|)
    ≤ ``ctol``; then ``fun`` = f(x) and ``lam``/``mu`` are the
    multipliers (μ ≥ 0, complementary by construction). Otherwise
    ``fun`` is NaN in-band: a hard inner failure reports that status, an
    exhausted outer budget reports MAX_ITERATIONS (``viol`` says how
    infeasible it still is).

    Per-lane constraint data (``constraint_data``, the `least_squares
    (data=)` analog): when given, ``eq``/``ineq`` are called as
    ``fn(x, data)`` — for a FLEET, ``constraint_data`` is a pytree whose
    leaves carry the leading batch axis and each lane sees its own
    slice, so one compiled program fits 4096 problems with 4096
    different feasible sets (per-lane budgets, per-lane radii, ...);
    for a scalar solve the pytree passes through whole.

    Fleets: a rank-2 (batch, n) ``x0`` runs the masked-lockstep
    constrained fleet — per-lane (λ, μ, ρ, violation) in the outer
    carry, the library's BATCHED engines as the inner solve, frozen
    lanes entering each inner fleet with a non-RUNNING placeholder so
    the inner masking skips them (NOT vmap-of-auglag, which is the
    documented round-1 trip-count trap). ``lam0``/``mu0`` then accept
    either the per-constraint shape (m,) (broadcast across lanes) or
    per-lane (batch, m); every result leaf gains the leading batch
    axis.

    f32 guidance (4096-lane n=60 fleets): tol = ctol = 1e-3 certifies
    every lane; 1e-4 is the marginal edge (rare stragglers exhaust the
    outer budget); 1e-5 is beyond the f32 mantissa once ρ ladders (the
    augmented value's resolution drops below eps·|F| and the line
    search reports the in-band stall). ``rho_max`` has no effect until
    the certificate demands violations f32 cannot express. For
    constraints a smooth bijection can absorb (positivity, boxes,
    simplexes), prefer `transforms.py` — unconstrained geometry samples
    and solves better; this is for the genuinely coupled constraints.
    """
    x0 = jnp.asarray(x0)
    if x0.ndim not in (1, 2):
        raise ValueError(
            f"x0 must be rank 1 (single solve) or rank 2 (batch, n) "
            f"(constrained fleet); got shape {x0.shape}"
        )
    if eq is None and ineq is None:
        raise ValueError(
            "at least one of eq=/ineq= is required — unconstrained "
            "problems: use optimize/optimize_lbfgs/optimize_cg/optimize_tr"
        )
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
    for name, fn in (("eq", eq), ("ineq", ineq)):
        if fn is not None and not callable(fn):
            raise TypeError(f"{name} must be callable, got {type(fn)!r}")
    if max_outer < 1:
        raise ValueError("max_outer must be >= 1")
    if not (rho0 > 0 and rho_growth >= 1 and rho_max >= rho0):
        raise ValueError("need rho0 > 0, rho_growth >= 1, rho_max >= rho0")
    dtype = x0.dtype
    eqw = _Flat1D(eq) if eq is not None else None
    inw = _Flat1D(ineq) if ineq is not None else None
    batched = x0.ndim == 2
    x_probe = x0[0] if batched else x0
    if constraint_data is not None:
        constraint_data = jax.tree_util.tree_map(
            jnp.asarray, constraint_data
        )
        if batched:
            leaves = jax.tree_util.tree_leaves(constraint_data)
            if not leaves or any(
                l.ndim < 1 or l.shape[0] != x0.shape[0] for l in leaves
            ):
                raise ValueError(
                    "constraint_data leaves must carry the fleet's "
                    f"leading batch axis ({x0.shape[0]})"
                )
            d_probe = (
                jax.tree_util.tree_map(lambda l: l[0], constraint_data),
            )
        else:
            d_probe = (constraint_data,)
    else:
        d_probe = ()

    def _mult_init(given, fn, label):
        """Validated multipliers: (m,) for the scalar path; (batch, m)
        for the fleet (an (m,) warm start broadcasts across lanes)."""
        if fn is None:
            if given is not None:
                raise ValueError(f"{label}0 given without {label}=")
            return jnp.zeros(
                (x0.shape[0], 0) if batched else (0,), dtype
            )
        shape = jax.eval_shape(fn, x_probe, *d_probe).shape
        if len(shape) != 1:
            raise ValueError(
                f"{label}(x0) must be rank-0/1, got shape {shape}"
            )
        full = (x0.shape[0],) + shape if batched else shape
        if given is None:
            return jnp.zeros(full, dtype)
        given = jnp.asarray(given, dtype)
        if batched and given.shape == shape:
            given = jnp.broadcast_to(given, full)
        if given.shape != full:
            raise ValueError(
                f"{label}0 shape {given.shape} != expected {full} "
                f"(constraint shape {shape})"
            )
        return given

    lam = _mult_init(lam0, eqw, "lam")
    mu = _mult_init(mu0, inw, "mu")
    if mu0 is not None:
        # validate the USER's array (not the broadcast product) and only
        # when it is concrete — the public entry must stay wrappable in
        # an outer jax.jit (a traced mu0 defers to the in-band μ >= 0
        # projection of the multiplier updates)
        try:
            negative = bool(jnp.any(jnp.asarray(mu0) < 0))
        except jax.errors.TracerBoolConversionError:
            negative = False
        if negative:
            raise ValueError("mu0 must be elementwise >= 0")
    if ls is None:
        # the augmented objective has |F*| > 0 whenever a constraint is
        # active and grows ill-conditioned with rho — exactly the regime
        # where the Armijo VALUE test hits the fp floor one step short
        # of the gradient certificate (the measured CG endgame failure,
        # STATUS round-4); the HZ approximate-Wolfe slope acceptance is
        # the fix, so it is the default for every line-search engine here
        ls = Wolfe(approx=True)
    if batched:
        return _auglag_fleet_core(
            obj, x0, eqw, inw, lam, mu,
            jnp.asarray(rho0, dtype), float(tol), float(ctol),
            jnp.asarray(rho_growth, dtype),
            jnp.asarray(viol_decrease, dtype), jnp.asarray(rho_max, dtype),
            engine, value_and_grad_fn, ls, max_outer, max_iterations,
            history, cg_method, cdata=constraint_data,
        )
    return _auglag_core(
        obj, x0, eqw, inw, lam, mu,
        jnp.asarray(rho0, dtype), float(tol), float(ctol),
        jnp.asarray(rho_growth, dtype),
        jnp.asarray(viol_decrease, dtype), jnp.asarray(rho_max, dtype),
        engine, value_and_grad_fn, ls, max_outer, max_iterations,
        history, cg_method, cdata=constraint_data,
    )


# --------------------------------------------------------------------------
# Batched fleet (round 5): masked-lockstep outer loop over per-lane
# (λ, μ, ρ, violation) with the library's BATCHED engines as the inner
# solve. Naive vmap-of-auglag is the documented round-1 trip-count trap
# (frozen lanes' discarded inner solves set every outer loop's trip
# count); here frozen lanes enter each inner fleet solve with a
# non-RUNNING placeholder status, so the inner cores' own lane masking
# freezes them at zero marginal work, and the outer while_loop runs to
# the slowest lane's KKT certificate only.
#
# Reference design brief: many side-by-side solver states carved out of
# one buffer (`PtrBFGSState`, src/QuasiNewtonMethods.jl:117-121; the
# multi-chain init workload, reference README.md:14) — the constrained
# fleet is that idea with per-lane multiplier state riding alongside.
# --------------------------------------------------------------------------


def _fleet_penalty_fns(eq, ineq, vag_f, f_val, dtype, has_data=False):
    """Per-lane penalty machinery over the lane-minor (n, batch) layout.

    ``pen_one(x, lam_i, mu_i, rho_i, *d_i)`` is the scalar PHR penalty
    of one lane (``d_i`` is the lane's constraint-data slice when
    ``has_data``); the batched forms close over nothing — multipliers
    (and data) are passed per call so the outer carry's tracers thread
    through cleanly."""

    def pen_one(x, lam_i, mu_i, rho_i, *d_i):
        p = jnp.zeros((), dtype)
        if eq is not None:
            h = eq(x, *d_i)
            p = p + jnp.dot(lam_i, h) + 0.5 * rho_i * jnp.dot(h, h)
        if ineq is not None:
            t = jnp.maximum(0.0, mu_i - rho_i * ineq(x, *d_i))
            p = p + (0.5 / rho_i) * (jnp.dot(t, t) - jnp.dot(mu_i, mu_i))
        return p

    d_ax = (0,) if has_data else ()
    # (n, B), (me, B), (mi, B), (B,)[, data] -> ((B,), (n, B))
    pen_vag_b = jax.vmap(
        jax.value_and_grad(pen_one), in_axes=(1, 1, 1, 0) + d_ax,
        out_axes=(0, 1),
    )
    vag_b = jax.vmap(vag_f, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f_val, in_axes=1, out_axes=0)
    pen_b = jax.vmap(pen_one, in_axes=(1, 1, 1, 0) + d_ax, out_axes=0)
    return pen_one, pen_vag_b, vag_b, f_b, pen_b


def _run_fleet_bfgs(F_vag_b, F_b, X, active, ls, tol, max_iterations,
                    dtype):
    from .batched_solve import _fresh_bfgs_carry, _solve_loop_batched

    status0 = jnp.where(
        active, jnp.int32(Status.RUNNING), jnp.int32(Status.MAX_ITERATIONS)
    )
    carry0 = _fresh_bfgs_carry(X, status0)
    fc = _solve_loop_batched(
        F_vag_b, F_b, carry0, ls, tol, max_iterations, h0_scale=True, stall_limit=STALL_LIMIT_DEFAULT,
    )
    return fc.X, fc.status, fc.iterations, fc.n_fev


def _run_fleet_lbfgs(F_vag_b, F_b, X, active, ls, tol, max_iterations,
                     history, dtype):
    from .lbfgs_batched_solve import (
        _RING_CIRCULAR_MIN_N,
        _fresh_lbfgs_carry,
        _lbfgs_loop_batched,
    )

    n, _batch = X.shape
    circular = n >= _RING_CIRCULAR_MIN_N
    status0 = jnp.where(
        active, jnp.int32(Status.RUNNING), jnp.int32(Status.MAX_ITERATIONS)
    )
    carry0 = _fresh_lbfgs_carry(X, history, status0, circular,
                                incremental_gram=False)
    fc = _lbfgs_loop_batched(
        F_vag_b, F_b, carry0, ls, tol, max_iterations,
        STALL_LIMIT_DEFAULT, circular,
    )
    return fc.X, fc.status, fc.iterations, fc.n_fev


def _run_fleet_cg(F_vag_b, F_b, X, active, ls, tol, max_iterations,
                  cg_method, dtype):
    from .cg_solve import _fresh_cg_carry

    status0 = jnp.where(
        active, jnp.int32(Status.RUNNING), jnp.int32(Status.MAX_ITERATIONS)
    )
    carry0 = _fresh_cg_carry(X, status0)
    fc = _cg_loop_batched(
        F_vag_b, F_b, carry0, cg_method, ls, tol, max_iterations,
        STALL_LIMIT_DEFAULT, 0.2,
    )
    return fc.X, fc.status, fc.iterations, fc.n_fev


def _run_fleet_tr(vag_f, pen_one, X, lam, mu, rho, active, tol,
                  max_iterations, dtype, cdata=None):
    """TR inner solve: batch-major (B, n) like the TR engine itself; the
    per-lane augmented value_and_grad/HVP close over THIS round's
    multipliers (outer-carry tracers thread through the vmaps)."""
    n = X.shape[0]
    lamT, muT = lam.T, mu.T  # (B, me), (B, mi)
    cd = (cdata,) if cdata is not None else ()
    d_ax = (0,) if cdata is not None else ()

    def vag_min_one(x, li, mui, ri, *d_i):
        fv, fg = vag_f(x)
        pv, pg = jax.value_and_grad(pen_one)(x, li, mui, ri, *d_i)
        return -(fv - pv), -(fg - pg)

    def grad_min_one(x, li, mui, ri, *d_i):
        return vag_min_one(x, li, mui, ri, *d_i)[1]

    def hvp_one(x, v, li, mui, ri, *d_i):
        return jax.jvp(
            lambda xx: grad_min_one(xx, li, mui, ri, *d_i), (x,), (v,)
        )[1]

    def vag_fleet(Xb):
        return jax.vmap(vag_min_one, in_axes=(0, 0, 0, 0) + d_ax)(
            Xb, lamT, muT, rho, *cd
        )

    def hvp_fleet(Xb, V):
        return jax.vmap(hvp_one, in_axes=(0, 0, 0, 0, 0) + d_ax)(
            Xb, V, lamT, muT, rho, *cd
        )

    s0 = _init_tr_state(vag_fleet, X.T, 1.0)
    crit0 = jnp.max(jnp.abs(s0.g), axis=-1)
    st0 = jnp.where(
        s0.status == Status.RUNNING,
        jnp.where(crit0 < tol, jnp.int32(Status.CONVERGED),
                  jnp.int32(Status.RUNNING)),
        s0.status,
    )
    st0 = jnp.where(active, st0, jnp.int32(Status.MAX_ITERATIONS))
    s0 = s0._replace(status=st0.astype(jnp.int32))
    body = partial(
        _tr_body, vag_fleet, hvp_fleet, None, tol, max_iterations,
        min(n, 64), 1.0, 1e6, 1e-4, "none", 2, None,
    )
    s = lax.while_loop(_tr_cond(max_iterations), body, s0)
    return s.x.T, s.status, s.k, s.n_fev


@partial(
    jax.jit,
    static_argnames=(
        "obj", "eq", "ineq", "engine", "value_and_grad_fn", "ls",
        "max_outer", "max_iterations", "history", "cg_method",
        "tol", "ctol",
    ),
)
def _auglag_fleet_core(
    obj, x0s, eq, ineq, lam0, mu0, rho0, tol, ctol, rho_growth,
    viol_decrease, rho_max, engine, value_and_grad_fn, ls, max_outer,
    max_iterations, history, cg_method, cdata=None,
):
    vag_f = as_value_and_grad(obj, value_and_grad_fn)
    f_val = as_value_fn(obj, value_and_grad_fn)
    batch, n = x0s.shape
    dtype = x0s.dtype

    me = lam0.shape[1]
    mi = mu0.shape[1]
    has_data = cdata is not None
    cd = (cdata,) if has_data else ()
    pen_one, pen_vag_b, vag_b, f_b, pen_b = _fleet_penalty_fns(
        eq, ineq, vag_f, f_val, dtype, has_data
    )
    d_ax = (0,) if has_data else ()
    eq_b = (
        jax.vmap(eq, in_axes=(1,) + d_ax, out_axes=1)
        if eq is not None else None
    )
    ineq_b = (
        jax.vmap(ineq, in_axes=(1,) + d_ax, out_axes=1)
        if ineq is not None else None
    )

    def violation(H, C, mu, rho):
        v = jnp.zeros((batch,), dtype)
        if eq is not None:
            v = jnp.maximum(v, jnp.max(jnp.abs(H), axis=0))
        if ineq is not None:
            v = jnp.maximum(
                v, jnp.max(jnp.abs(jnp.minimum(C, mu / rho[None, :])), axis=0)
            )
        return v

    def body(carry):
        (X, lam, mu, rho, vprev, k, n_outer, tot_it, tot_fev, succ, hard,
         inner_st) = carry
        active = (~succ) & (~hard)

        def F_b(Xv):
            return f_b(Xv) - pen_b(Xv, lam, mu, rho, *cd)

        def F_vag_b(Xv):
            fv, fg = vag_b(Xv)
            pv, pg = pen_vag_b(Xv, lam, mu, rho, *cd)
            return fv - pv, fg - pg

        if engine == "bfgs":
            X1, st, it, fev = _run_fleet_bfgs(
                F_vag_b, F_b, X, active, ls, tol, max_iterations, dtype,
            )
        elif engine == "lbfgs":
            X1, st, it, fev = _run_fleet_lbfgs(
                F_vag_b, F_b, X, active, ls, tol, max_iterations,
                history, dtype,
            )
        elif engine == "cg":
            X1, st, it, fev = _run_fleet_cg(
                F_vag_b, F_b, X, active, ls, tol, max_iterations,
                cg_method, dtype,
            )
        else:  # tr
            X1, st, it, fev = _run_fleet_tr(
                vag_f, pen_one, X, lam, mu, rho, active, tol,
                max_iterations, dtype, cdata,
            )

        X1 = jnp.where(active[None, :], X1, X)
        H1 = (
            eq_b(X1, *cd) if eq is not None
            else jnp.zeros((0, batch), dtype)
        )
        C1 = (
            ineq_b(X1, *cd) if ineq is not None
            else jnp.zeros((0, batch), dtype)
        )
        v = violation(H1, C1, mu, rho)
        lam1 = jnp.where(active[None, :], lam + rho[None, :] * H1, lam)
        mu1 = jnp.where(
            active[None, :], jnp.maximum(0.0, mu - rho[None, :] * C1), mu
        )
        succ_round = active & (st == Status.CONVERGED) & (v <= ctol)
        hard_round = active & (st == Status.NONFINITE_VALUE)
        rho1 = jnp.where(
            active & (v > viol_decrease * vprev),
            jnp.minimum(rho * rho_growth, rho_max),
            rho,
        )
        return (
            X1, lam1, mu1, rho1,
            jnp.where(active, v, vprev),
            k + 1,
            n_outer + active.astype(jnp.int32),
            tot_it + jnp.where(active, it, 0),
            tot_fev + jnp.where(active, fev, 0),
            succ | succ_round,
            hard | hard_round,
            jnp.where(active, st, inner_st),
        )

    def cond(carry):
        _X, _l, _m, _r, _v, k, _no, _ti, _tf, succ, hard, _st = carry
        return (k < max_outer) & jnp.any((~succ) & (~hard))

    carry0 = (
        x0s.T, lam0.T, mu0.T,
        jnp.full((batch,), rho0, dtype),
        jnp.full((batch,), jnp.inf, dtype),
        jnp.zeros((), jnp.int32),
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), bool),
        jnp.zeros((batch,), bool),
        jnp.full((batch,), Status.RUNNING, jnp.int32),
    )
    (X, lam, mu, rho, v, _k, n_outer, tot_it, tot_fev, succ, hard,
     inner_st) = lax.while_loop(cond, body, carry0)

    fv, fg = vag_b(X)
    nan = jnp.asarray(jnp.nan, dtype)
    status = jnp.where(
        succ,
        jnp.int32(Status.CONVERGED),
        jnp.where(hard, inner_st, jnp.int32(Status.MAX_ITERATIONS)),
    )
    Hf = eq_b(X, *cd) if eq is not None else jnp.zeros((0, batch), dtype)
    Cf = (
        ineq_b(X, *cd) if ineq is not None
        else jnp.zeros((0, batch), dtype)
    )
    res = AugLagResult(
        x=X.T,
        fun=jnp.where(succ, fv, nan),
        grad=fg.T,
        status=status,
        viol=v,
        eq=Hf.T,
        ineq=Cf.T,
        lam=lam.T,
        mu=mu.T,
        rho=rho,
        n_outer=n_outer,
        iterations=tot_it,
        n_fev=tot_fev,
        inner_status=inner_st,
        last_value=fv,
    )
    return res
