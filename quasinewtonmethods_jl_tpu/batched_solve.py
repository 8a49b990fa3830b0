"""Native batched BFGS driver — batch-minor layout, masked lockstep loops.

This is the accelerator execution engine for fleets of independent solves
(the HMC-chain-init workload, reference README.md:14). Where `parallel.batch`
gets batching "for free" via `jax.vmap` of the scalar solver, this driver is
*written* batched, which buys three things the vmap path cannot express:

  1. **batch-minor layout**: the inverse-Hessian stack is (n, n, batch) and
     every vector is (n, batch), so per-lane scalar ops run along the
     contiguous lane axis and loads of B coalesce across lanes;
  2. **few passes over B**: the rank-2 update + next direction + reset
     logic evaluate through one fused formulation (closed-form d and m — no
     second matvec through B_new, `ops.bfgs.fused_bfgs_update_reference`),
     instead of the vmapped scalar solver's solver-level selects on B and
     separate matvec kernels;
  3. **explicit lane masking**: the driver controls exactly which carry
     leaves are touched for frozen lanes, so no B-sized select ever
     materializes outside the update.

Semantics are lane-for-lane those of `solve.optimize` (itself matching the
reference optimize!, src/QuasiNewtonMethods.jl:237-292): same line search,
same reset rule, same in-band status codes; `k` is global (all lanes start
together and run lockstep until every lane finishes or the cap hits).

Two throughput options beyond the reference's semantics (both default-off,
both trajectory-preserving):

  * ``fold_eval=True``: line-search trials evaluate value+gradient, so the
    ACCEPTED trial seeds the next iteration and the separate
    top-of-iteration evaluation disappears — the reference re-evaluates at
    the accepted point every iteration (:254 after linesearch! already
    evaluated there, :283). Saves ~1 objective evaluation per iteration
    when trials usually accept at the first alpha; costs a backward pass
    per *rejected* trial, so keep it off for objectives whose gradient is
    much more expensive than their value.
  * `optimize_batched_compacted`: run in chunks, and between chunks gather
    the still-running lanes into a smaller dense fleet — stragglers stop
    costing full-fleet-width iterations (lockstep wall time follows the
    compacted width, not the original batch).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .ops.linesearch import BackTracking
from .ops.wolfe import wolfe_propose
from .ops.bfgs import fused_bfgs_update_reference
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult
from .state import BFGSState, Status
from .utils.scalars import finite_halving_limit, nanmax, nanmin, sqrt_tolerance

__all__ = [
    "optimize_batched_fused",
    "optimize_batched_fused_from_state",
    "optimize_batched_compacted",
]


class _Carry(NamedTuple):
    X: jax.Array  # (n, batch) iterates
    G: jax.Array  # (n, batch) gradient at X (last evaluated / carried)
    G_old: jax.Array  # (n, batch)
    STEP: jax.Array  # (n, batch) last accepted step (alpha * d)
    B: jax.Array  # (n, n, batch) inverse Hessians
    fun: jax.Array  # (batch,) objective at X (last evaluated / carried)
    fprev: jax.Array  # (batch,) previous iteration's objective (stall test)
    k: jax.Array  # () global iteration counter
    status: jax.Array  # (batch,) int32
    iterations: jax.Array  # (batch,) int32
    n_fev: jax.Array  # (batch,) int32
    n_gev: jax.Array  # (batch,) int32
    n_resets: jax.Array  # (batch,) int32
    fresh: jax.Array  # (batch,) bool: lane's B is a fresh identity
    stall: jax.Array  # (batch,) int32 consecutive no-improvement iterations


class _LSCarry(NamedTuple):
    a1: jax.Array
    a2: jax.Array
    fx0: jax.Array
    fx1: jax.Array
    it: jax.Array  # (batch,) int32 armijo rounds (or finite halvings)
    n_fev: jax.Array  # (batch,) int32


class _LSFoldCarry(NamedTuple):
    a1: jax.Array
    a2: jax.Array
    fx0: jax.Array
    fx1: jax.Array
    G1: jax.Array  # (n, batch) gradient at the current trial
    it: jax.Array
    n_ev: jax.Array


def _armijo_propose(m, f0, a1, a2, fx0, fx1, it, lane, ls, eps, sqrttol,
                    rho_hi, rho_lo):
    """One Armijo backtracking proposal, per-lane (reference :205-225):
    quadratic (order 2 / first round) or cubic interpolation with the
    degenerate-cubic fallback and the NaN-robust [rho_lo*a, rho_hi*a]
    clamps. Returns (a1_new, a2_new) with frozen lanes untouched."""
    quad = -(m * a2 * a2) / (2.0 * (fx1 - f0 - m * a2))
    if ls.order == 2:
        at = quad
    else:
        denom = 1.0 / (a1 * a1 * a2 * a2 * (a2 - a1))
        r1 = fx1 - f0 - m * a2
        r0 = fx0 - f0 - m * a1
        a = (a1 * a1 * r1 - a2 * a2 * r0) * denom
        b = (-a1 * a1 * a1 * r1 + a2 * a2 * a2 * r0) * denom
        degenerate = jnp.abs(a) <= eps + sqrttol * jnp.abs(a)
        disc = nanmax(b * b - 3.0 * a * m, jnp.zeros_like(b))
        cubic = jnp.where(
            degenerate, m / (2.0 * b), (jnp.sqrt(disc) + b) / (-3.0 * a)
        )
        at = jnp.where(it == 1, quad, cubic)
    a1_new = jnp.where(lane, a2, a1)
    at = nanmin(at, a2 * rho_hi)
    a2_new = jnp.where(lane, nanmax(at, a2 * rho_lo), a2)
    return a1_new, a2_new


def _ls_consts(ls, dtype):
    return (
        jnp.asarray(ls.c1, dtype),
        jnp.asarray(ls.rho_hi, dtype),
        jnp.asarray(ls.rho_lo, dtype),
        jnp.asarray(jnp.finfo(dtype).eps, dtype),
        jnp.asarray(sqrt_tolerance(dtype), dtype),
    )


def _batched_linesearch(phi, f0, m, active, ls: BackTracking, dtype):
    """Masked lockstep backtracking line search over a lane batch.

    Per-lane semantics identical to ops.linesearch.backtracking_linesearch
    (reference :165-232); `active=False` lanes are frozen throughout and
    return alpha = 0 (no step). phi maps an (batch,) alpha vector to the
    (batch,) objective values at X + alpha*d.
    """
    batch = f0.shape[0]
    c1, rho_hi, rho_lo, eps, sqrttol = _ls_consts(ls, dtype)
    one = jnp.ones((batch,), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)

    fx1 = phi(one)
    n_fev = active.astype(jnp.int32)

    # Unlike the scalar search, there is no separate finite-halving phase:
    # every extra lax.while_loop costs a fixed sequential dispatch per OUTER
    # solver iteration even when it runs zero rounds, which measurably taxes
    # the lockstep engine. A non-finite trial fails the Armijo test (NaN >=
    # t is False) and the NaN-robust clamps then shrink alpha by rho_hi
    # (= 0.5 by default — exactly the reference's halving, :182) inside the
    # single Armijo loop. The only behavioral difference vs the two-phase
    # form is the shared iteration budget and a x0.1 shrink for -inf trials.
    budget = ls.iterations + finite_halving_limit(dtype)
    # doomed-lane fast-fail: NaN m/f0 can never satisfy Armijo (see
    # ops/linesearch.py) — exclude such lanes from the loop mask entirely.
    doomed = ~(jnp.isfinite(m) & jnp.isfinite(f0))

    def suff(c: _LSCarry):
        return c.fx1 >= f0 + c.a2 * c1 * m

    def arm_lane(c: _LSCarry):
        return active & ~doomed & ~suff(c) & (c.it < budget)

    def arm_cond(c: _LSCarry):
        return jnp.any(arm_lane(c))

    def arm_body(c: _LSCarry):
        lane = arm_lane(c)
        it = c.it + lane
        a1, a2 = _armijo_propose(
            m, f0, c.a1, c.a2, c.fx0, c.fx1, it, lane, ls, eps, sqrttol,
            rho_hi, rho_lo,
        )
        fx0 = jnp.where(lane, c.fx1, c.fx0)
        fx1 = jnp.where(lane, phi(a2), c.fx1)
        return _LSCarry(a1, a2, fx0, fx1, it, c.n_fev + lane)

    ac = lax.while_loop(
        arm_cond, arm_body, _LSCarry(one, one, f0, fx1, zero_i, n_fev)
    )

    ok = suff(ac)
    alpha = jnp.where(active & ok, ac.a2, jnp.zeros((), dtype))
    # alpha == 0 is the in-band failure sentinel (reference :193/:284),
    # covering both budget exhaustion and underflow-to-zero.
    failed = active & (alpha == 0.0)
    return alpha, ac.n_fev, ac.it, failed


def _batched_linesearch_fold(phi_vag, f0, m, active, ls: BackTracking, dtype):
    """Value+gradient variant of `_batched_linesearch` for ``fold_eval``:
    identical trial points and acceptance (same proposals, same clamps,
    same budget), but every trial evaluates value_and_grad so the ACCEPTED
    trial's (value, gradient) can seed the next outer iteration — no
    separate top-of-iteration evaluation. Returns
    ``(alpha, n_ev, it, failed, f_acc, G_acc)``; (f_acc, G_acc) are the
    value/gradient at the final trial (valid where not failed)."""
    batch = f0.shape[0]
    c1, rho_hi, rho_lo, eps, sqrttol = _ls_consts(ls, dtype)
    one = jnp.ones((batch,), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)

    fx1, G1 = phi_vag(one)
    n_ev = active.astype(jnp.int32)
    budget = ls.iterations + finite_halving_limit(dtype)
    doomed = ~(jnp.isfinite(m) & jnp.isfinite(f0))

    def suff(c: _LSFoldCarry):
        return c.fx1 >= f0 + c.a2 * c1 * m

    def arm_lane(c: _LSFoldCarry):
        return active & ~doomed & ~suff(c) & (c.it < budget)

    def arm_cond(c: _LSFoldCarry):
        return jnp.any(arm_lane(c))

    def arm_body(c: _LSFoldCarry):
        lane = arm_lane(c)
        it = c.it + lane
        a1, a2 = _armijo_propose(
            m, f0, c.a1, c.a2, c.fx0, c.fx1, it, lane, ls, eps, sqrttol,
            rho_hi, rho_lo,
        )
        fx0 = jnp.where(lane, c.fx1, c.fx0)
        f_new, G_new = phi_vag(a2)
        fx1 = jnp.where(lane, f_new, c.fx1)
        G1 = jnp.where(lane[None, :], G_new, c.G1)
        return _LSFoldCarry(a1, a2, fx0, fx1, G1, it, c.n_ev + lane)

    ac = lax.while_loop(
        arm_cond, arm_body, _LSFoldCarry(one, one, f0, fx1, G1, zero_i, n_ev)
    )

    ok = suff(ac)
    alpha = jnp.where(active & ok, ac.a2, jnp.zeros((), dtype))
    failed = active & (alpha == 0.0)
    return alpha, ac.n_ev, ac.it, failed, ac.fx1, ac.G1


class _WLSCarry(NamedTuple):
    lo: jax.Array
    flo: jax.Array
    slo: jax.Array
    hi: jax.Array
    fhi: jax.Array
    shi: jax.Array
    a: jax.Array
    fa: jax.Array
    sa: jax.Array
    Ga: jax.Array  # (n, batch) gradient at a (zeros when with_grad=False)
    it: jax.Array
    n_ev: jax.Array


def _batched_wolfe(phi_vag, f0, m, active, ls, dtype, with_grad=False):
    """Masked lockstep weak-Wolfe search (per-lane semantics of
    ops.wolfe.wolfe_linesearch). phi_vag maps (batch,) alphas to
    ((batch,) values, (batch,) slopes, (n, batch) gradients along the ray).
    With ``with_grad`` the accepted trial's (value, gradient) are returned
    for ``fold_eval``."""
    batch = f0.shape[0]
    c1 = jnp.asarray(ls.c1, dtype)
    c2 = jnp.asarray(ls.c2, dtype)
    one = jnp.ones((batch,), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)

    fa0, sa0, Ga0 = phi_vag(one)
    if not with_grad:
        Ga0 = jnp.zeros((0, batch), dtype)  # empty: carried but free

    def conds(c: _WLSCarry):
        armijo = c.fa >= f0 + c1 * c.a * m
        curv = c.sa <= c2 * m
        return armijo, curv

    def accepts(c: _WLSCarry):
        armijo, curv = conds(c)
        ok = armijo & curv
        if ls.approx:
            # Hager–Zhang approximate Wolfe (per-lane; see ops/wolfe.py)
            aw = (
                (c.sa >= (2.0 * c1 - 1.0) * m)
                & curv
                & (c.fa >= f0 - ls.approx_eps * jnp.abs(f0))
            )
            ok = ok | aw
        return ok

    doomed = ~(jnp.isfinite(m) & jnp.isfinite(f0))

    def lane_mask(c: _WLSCarry):
        return active & ~doomed & ~accepts(c) & (c.it < ls.iterations)

    def cond(c: _WLSCarry):
        return jnp.any(lane_mask(c))

    def body(c: _WLSCarry):
        lane = lane_mask(c)
        if ls.approx:
            # Hager–Zhang slope-driven interval update — see ops/wolfe.py
            # for the derivation and the measured endgame failure of the
            # Armijo-driven rule at the fp resolution floor
            bar = f0 - ls.approx_eps * jnp.abs(f0)
            bad = ~(jnp.isfinite(c.fa) & jnp.isfinite(c.sa))
            shrink = lane & ((c.sa <= 0.0) | (c.fa < bar) | bad)
        else:
            armijo, _curv = conds(c)
            shrink = lane & ~armijo
        hi = jnp.where(shrink, c.a, c.hi)
        fhi = jnp.where(shrink, c.fa, c.fhi)
        shi = jnp.where(shrink, c.sa, c.shi)
        growlo = lane & ~shrink
        lo = jnp.where(growlo, c.a, c.lo)
        flo = jnp.where(growlo, c.fa, c.flo)
        slo = jnp.where(growlo, c.sa, c.slo)
        a_next = jnp.where(
            jnp.isinf(hi),
            2.0 * lo,
            wolfe_propose(lo, flo, slo, hi, fhi, shi, ls.interp),
        )
        a = jnp.where(lane, a_next, c.a)
        fa_n, sa_n, Ga_n = phi_vag(a)
        Ga = (
            jnp.where(lane[None, :], Ga_n, c.Ga) if with_grad else c.Ga
        )
        return _WLSCarry(
            lo=lo, flo=flo, slo=slo,
            hi=hi, fhi=fhi, shi=shi,
            a=a,
            fa=jnp.where(lane, fa_n, c.fa),
            sa=jnp.where(lane, sa_n, c.sa),
            Ga=Ga,
            it=c.it + lane,
            n_ev=c.n_ev + lane,
        )

    nan_b = jnp.full((batch,), jnp.nan, dtype)
    init = _WLSCarry(
        lo=jnp.zeros((batch,), dtype), flo=f0, slo=m,
        hi=jnp.full((batch,), jnp.inf, dtype), fhi=nan_b, shi=nan_b,
        a=one, fa=fa0, sa=sa0, Ga=Ga0, it=zero_i,
        n_ev=active.astype(jnp.int32),
    )
    fc = lax.while_loop(cond, body, init)
    ok = accepts(fc)
    alpha = jnp.where(active & ok, fc.a, jnp.zeros((), dtype))
    failed = active & (alpha == 0.0)
    return alpha, fc.n_ev, fc.it, failed, fc.fa, fc.Ga


def _solve_loop_batched(
    vag_b: Callable,
    f_b: Callable,
    carry0: _Carry,
    ls: BackTracking,
    tol,
    max_iterations: int,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
    resume: bool = False,
    unroll: int = 1,
) -> _Carry:
    dtype = carry0.X.dtype
    tol = jnp.asarray(tol, dtype)

    def cond(c: _Carry):
        return jnp.logical_and(
            c.k < max_iterations, jnp.any(c.status == Status.RUNNING)
        )

    # k is global (all lanes start together), so the reference's m = -1
    # first-iteration sentinel (:263-264) is handled by PEELING iteration 1
    # out of the while loop instead of a lax.cond inside it: an XLA
    # conditional can copy its (n, n, batch)-sized operands in and out
    # every iteration just to select a branch whose predicate is true
    # exactly once.
    #
    # Three body flavors:
    #   "first"  — fresh-fleet peel: steepest ascent with m = ||g||^2;
    #   "resume" — resume peel: real update, but lanes that have never
    #              stepped (iterations == 0: step = 0 would give sty = 0 ->
    #              NaN) take the steepest first step instead — the batched
    #              analog of the scalar driver's runtime k == 0 cond. A
    #              resumed fleet therefore CONTINUES its BFGS trajectory
    #              (like optimize_from_state) rather than restarting.
    #   "loop"   — every post-peel iteration: pure update path; with
    #              fold_eval the evaluation comes from the carry.
    def make_body(mode: str):
        def body(c: _Carry):
            if fold_eval and mode == "loop":
                # carried from the accepted line-search trial (fold_eval
                # invariant: c.fun/c.G are the objective/gradient at c.X)
                f0, g = c.fun, c.G
            else:
                f0, g = vag_b(c.X)  # (batch,), (n, batch)
            # k < max_iterations keeps the cap exact under unroll > 1: the
            # chain's trailing bodies past the cap become full no-ops
            # (scalar compare; free for unroll == 1, where the while cond
            # already guarantees it)
            was_active = (c.status == Status.RUNNING) & (c.k < max_iterations)
            nonfinite = ~jnp.isfinite(f0)
            converged = jnp.max(jnp.abs(g), axis=0) < tol
            improved = jnp.where(jnp.isnan(c.fprev), True, f0 > c.fprev)
            stall = jnp.where(
                was_active & ~improved, c.stall + 1, jnp.zeros_like(c.stall)
            )
            stall = jnp.where(was_active, stall, c.stall)
            stalled = (
                stall >= stall_limit
                if stall_limit
                else jnp.zeros_like(was_active)
            )
            status_pre = jnp.where(
                was_active,
                jnp.where(
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
                ),
                c.status,
            )
            # & was_active: for a lane still RUNNING at the iteration cap,
            # status_pre falls back to c.status (= RUNNING) — without the
            # conjunction the trailing bodies of an unroll>1 chain would
            # take REAL steps past the cap (and over-count iterations)
            active = (status_pre == Status.RUNNING) & was_active
            amask = active.astype(dtype)[None, :]  # (1, batch)

            if mode == "first":
                # steepest ascent with m = ||g||^2 (the sentinel path)
                gg = jnp.sum(g * g, axis=0)
                d = g * amask
                m = jnp.where(active, gg, jnp.ones_like(gg))
                B_new, reset = c.B, active
            else:
                fmask = (
                    (c.fresh & active).astype(dtype)[None, :]
                    if h0_scale
                    else jnp.zeros_like(amask)
                )
                B_new, d, m, r = fused_bfgs_update_reference(
                    c.B, c.STEP, g, c.G_old, amask, fmask
                )
                m, reset = m[0], r[0] > 0
                if mode == "resume":
                    # never-stepped lanes: steepest first step (see above).
                    # The B-sized select runs ONCE (peel), not per iteration.
                    never = (c.iterations == 0) & active
                    gg = jnp.sum(g * g, axis=0)
                    d = jnp.where(never[None, :], g * amask, d)
                    m = jnp.where(never, gg, m)
                    B_new = jnp.where(never[None, None, :], c.B, B_new)
                    reset = reset | never

            from .ops.wolfe import Wolfe

            fresh_eval = not (fold_eval and mode == "loop")
            if isinstance(ls, Wolfe):

                def phi_vag3(alpha):
                    fv, gv = vag_b(c.X + alpha[None, :] * d)
                    return fv, jnp.sum(gv * d, axis=0), gv

                alpha, ls_ev, _ls_it, ls_failed, f_acc, G_acc = _batched_wolfe(
                    phi_vag3, f0, m, active, ls, dtype, with_grad=fold_eval
                )
                ls_fev = ls_gev = ls_ev  # every Wolfe trial is value+grad
            elif fold_eval:

                def phi_vag(alpha):
                    return vag_b(c.X + alpha[None, :] * d)

                alpha, ls_ev, _ls_it, ls_failed, f_acc, G_acc = (
                    _batched_linesearch_fold(phi_vag, f0, m, active, ls, dtype)
                )
                ls_fev = ls_gev = ls_ev  # fold trials are value+grad
            else:

                def phi(alpha):
                    return f_b(c.X + alpha[None, :] * d)

                alpha, ls_fev, _ls_it, ls_failed = _batched_linesearch(
                    phi, f0, m, active, ls, dtype
                )
                ls_gev = jnp.zeros_like(ls_fev)
                f_acc = G_acc = None
            # failed/frozen lanes take no step — explicit mask, because
            # alpha == 0 times a NaN direction (degenerate update) is NaN
            # and would destroy the lane's last good iterate.
            take = active & ~ls_failed
            take_v = take[None, :]
            step = jnp.where(take_v, alpha[None, :] * d, jnp.zeros_like(d))
            new_status = jnp.where(
                active & ls_failed, jnp.int32(Status.LINESEARCH_FAILURE),
                status_pre,
            )
            wmask = was_active[None, :]
            if fold_eval:
                # carry the accepted trial's evaluation to the next iteration
                fun_new = jnp.where(
                    take, f_acc, jnp.where(was_active, f0, c.fun)
                )
                G_new = jnp.where(take_v, G_acc, jnp.where(wmask, g, c.G))
            else:
                fun_new = jnp.where(was_active, f0, c.fun)
                G_new = jnp.where(wmask, g, c.G)
            top_ev = (
                was_active.astype(jnp.int32)
                if fresh_eval
                else jnp.zeros_like(c.n_fev)
            )
            return _Carry(
                X=c.X + step,
                G=G_new,
                G_old=jnp.where(active[None, :], g, c.G_old),
                STEP=jnp.where(active[None, :], step, c.STEP),
                B=B_new,
                fun=fun_new,
                fprev=jnp.where(was_active, f0, c.fprev),
                k=c.k + 1,
                status=new_status,
                iterations=c.iterations + active.astype(jnp.int32),
                n_fev=c.n_fev + top_ev + ls_fev,
                n_gev=c.n_gev + top_ev + ls_gev,
                n_resets=c.n_resets + reset.astype(jnp.int32),
                fresh=jnp.where(active, reset, c.fresh),
                stall=stall,
            )

        return body

    if max_iterations >= 1:
        carry1 = make_body("resume" if resume else "first")(carry0)
        # unroll > 1 chains several bodies per while-loop step, amortizing
        # the loop's per-step control cost (the predicate's device-to-host
        # readback). The body is a no-op for finished lanes (every carry
        # write is active-masked) and for bodies past the iteration cap
        # (was_active folds in k < max_iterations), so chaining k bodies
        # per step is trajectory-identical and the cap stays exact.
        body_fn = make_body("loop")
        if unroll > 1:
            def chain(c):
                for _ in range(unroll):
                    c = body_fn(c)
                return c
            final = lax.while_loop(cond, chain, carry1)
        else:
            final = lax.while_loop(cond, body_fn, carry1)
    else:
        final = carry0
    return final._replace(
        status=jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            final.status,
        )
    )


def _fresh_bfgs_carry(X, status0):
    """Fresh fused-engine carry for a (n, batch) lane-minor fleet with
    per-lane initial ``status0`` (non-RUNNING lanes are frozen from step
    one). THE single source of the carry layout — the engine's own jit
    entry and the constrained fleet's inner solves both build here, so
    a carry-field change cannot desynchronize them (review finding,
    round 5)."""
    n, batch = X.shape
    dtype = X.dtype
    zero_v = jnp.zeros((n, batch), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)
    return _Carry(
        X=X,
        G=zero_v,
        G_old=zero_v,
        STEP=zero_v,
        B=jnp.broadcast_to(jnp.eye(n, dtype=dtype)[:, :, None], (n, n, batch)),
        fun=jnp.full((batch,), jnp.nan, dtype),
        fprev=jnp.full((batch,), jnp.nan, dtype),
        k=jnp.zeros((), jnp.int32),
        status=status0,
        iterations=zero_i,
        n_fev=zero_i,
        n_gev=zero_i,
        n_resets=zero_i,
        fresh=jnp.ones((batch,), bool),
        stall=zero_i,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj",
        "ls",
        "max_iterations",
        "value_and_grad_fn",
        "h0_scale",
        "stall_limit",
        "fold_eval",
        "unroll",
    ),
)
def _optimize_batched_fused_jit(
    obj, x0s, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
    stall_limit=STALL_LIMIT_DEFAULT, fold_eval=False, unroll=1,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    # Lane axis is the trailing axis internally; the user objective stays a
    # per-lane (n,) -> scalar function, mapped over lanes.
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)

    status0 = jnp.full((x0s.shape[0],), Status.RUNNING, jnp.int32)
    carry0 = _fresh_bfgs_carry(x0s.T, status0)
    fc = _solve_loop_batched(
        vag_b, f_b, carry0, ls, tol, max_iterations, h0_scale, stall_limit,
        fold_eval, unroll=unroll,
    )
    return _result_from_batched_carry(fc)


def _result_from_batched_carry(fc: _Carry) -> OptimizeResult:
    # Back to the public (batch, ...) convention of the vmap path.
    state = BFGSState(
        x=fc.X.T,
        grad=fc.G.T,
        grad_old=fc.G_old.T,
        step=fc.STEP.T,
        B=jnp.moveaxis(fc.B, -1, 0),
        fun=fc.fun,
        k=fc.iterations,
        status=fc.status,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        fresh=fc.fresh,
        stall=fc.stall,
    )
    nan = jnp.asarray(jnp.nan, fc.X.dtype)
    return OptimizeResult(
        x=state.x,
        fun=jnp.where(fc.status == Status.CONVERGED, fc.fun, nan),
        grad=state.grad,
        status=fc.status,
        iterations=fc.iterations,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        last_value=fc.fun,
        state=state,
    )


def optimize_batched_fused(
    obj,
    x0s: jax.Array,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
    unroll: int = 1,
) -> OptimizeResult:
    """Throughput-path batched BFGS: native batch-minor driver.

    Drop-in result-compatible with `optimize_batched` (leading batch axis on
    every result leaf). The update is the closed-form fused XLA update
    (`ops.bfgs.fused_bfgs_update_reference`). ``fold_eval=True`` folds the
    accepted line-search trial's value+gradient into the next iteration
    (see module docstring).
    """
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    return _optimize_batched_fused_jit(
        obj, x0s, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
        stall_limit, fold_eval, unroll,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj",
        "ls",
        "max_iterations",
        "value_and_grad_fn",
        "h0_scale",
        "stall_limit",
        "fold_eval",
        "unroll",
    ),
)
def _optimize_batched_fused_resume_jit(
    obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale, stall_limit=STALL_LIMIT_DEFAULT, fold_eval=False, unroll=1,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)

    carry0 = _Carry(
        X=state.x.T,
        G=state.grad.T,
        G_old=state.grad_old.T,
        STEP=state.step.T,
        B=jnp.moveaxis(state.B, 0, -1),
        fun=state.fun,
        fprev=state.fun,  # last recorded value: stall comparison continues
        k=jnp.zeros((), jnp.int32),
        status=jnp.full(state.fun.shape, Status.RUNNING, jnp.int32),
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        fresh=state.fresh,
        # fresh stall budget: stall-exited lanes would otherwise re-fail
        # after one iteration without attempting a step
        stall=jnp.zeros_like(state.stall),
    )
    fc = _solve_loop_batched(
        vag_b, f_b, carry0, ls, tol, max_iterations,
        h0_scale, stall_limit,
        fold_eval, resume=True, unroll=unroll,
    )
    return _result_from_batched_carry(fc)


def optimize_batched_fused_from_state(
    obj,
    state: BFGSState,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
    unroll: int = 1,
) -> OptimizeResult:
    """Resume a batched fleet from a (possibly checkpointed) batched
    BFGSState — every leaf carries the leading batch axis, exactly as an
    earlier batched result's ``.state``. All lanes are re-armed to RUNNING
    (so converged lanes can also be re-solved under a tighter tol);
    iteration/eval counters continue from the saved values.
    ``max_iterations`` bounds the additional iterations of this resume leg.

    A resumed lane CONTINUES its BFGS trajectory (its first iteration is a
    genuine rank-2 update from the saved step/gradient pair, matching the
    scalar ``optimize_from_state``); only lanes that have never stepped
    (``state.k == 0``) take a steepest-ascent first step. Chunked solves
    are therefore trajectory-identical to one long solve — the property
    `optimize_batched_compacted` is built on.
    """
    if state.x.ndim != 2:
        raise ValueError("expected a batched BFGSState (leaves with batch axis)")
    return _optimize_batched_fused_resume_jit(
        obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale,
        stall_limit, fold_eval, unroll,
    )


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


@jax.jit
def _gather_tree(tree, idx):
    """One fused gather of every (batch, ...) leaf — a single device call
    per compaction leg instead of ~19 eager per-leaf gathers, each of which
    would be its own dispatch."""
    return jax.tree_util.tree_map(lambda a: a[idx] if a.ndim else a, tree)


@jax.jit
def _scatter_tree(full, sub, idx):
    """One fused scatter-back; `idx` entries >= batch are dropped (the
    cyclic padding lanes), so the call caches per compacted width only."""
    return jax.tree_util.tree_map(
        lambda acc, s: acc.at[idx].set(s, mode="drop") if acc.ndim else acc,
        full, sub,
    )


def optimize_batched_compacted(
    obj,
    x0s: jax.Array,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
    unroll: int = 1,
    chunk: int = 64,
    min_width: int = 128,
) -> OptimizeResult:
    """Lockstep fleet with straggler compaction.

    A lockstep fleet runs at full batch width until its SLOWEST lane
    finishes, so a handful of stragglers (max iterations ~2-3x the median
    on the benchmark fleet) dominate wall time. This driver runs the fused
    engine ``chunk`` iterations at a time and, between chunks, gathers the
    still-running lanes into the smallest power-of-two fleet >= min_width
    and resumes only those — per-iteration cost then tracks the number of
    UNFINISHED lanes instead of the original batch (the B-update is HBM
    bandwidth-bound, so cost is ~linear in width).

    When it wins: extreme straggler tails (multimodal fleets, mixed
    conditioning) and runtimes with cheap dispatch. Each leg costs a
    gather + resume + scatter + one status readback; when that exceeds the
    straggler savings (a fleet whose slowest lane needs only ~2x the median
    iterations), `optimize_batched_fused` is faster — measure your
    workload.

    Lane trajectories are bit-identical to `optimize_batched_fused`: each
    lane's arithmetic never depends on its neighbors, and the resume path
    continues a lane's BFGS trajectory exactly (see
    `optimize_batched_fused_from_state`). Only wall time changes.

    The host syncs once per chunk (to read lane statuses); each distinct
    compacted width compiles once (widths walk a fixed power-of-two ladder,
    so at most log2(batch/min_width) + 1 compilations ever happen).
    """
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    batch = x0s.shape[0]
    common = dict(
        ls=ls, tol=tol, value_and_grad_fn=value_and_grad_fn,
        h0_scale=h0_scale, stall_limit=stall_limit,
        fold_eval=fold_eval, unroll=unroll,
    )

    res = optimize_batched_fused(
        obj, x0s, max_iterations=min(chunk, max_iterations), **common
    )
    done = min(chunk, max_iterations)
    # full-width accumulated result (leaves updated in place per chunk)
    full = res

    while done < max_iterations:
        status = np.asarray(full.status)  # the one host sync per chunk
        alive = np.flatnonzero(status == Status.MAX_ITERATIONS)
        if alive.size == 0:
            break
        width = min(batch, max(min_width, _next_pow2(alive.size)))
        gather_idx = np.resize(alive, width)  # cyclic pad (unique prefix)
        # scatter drops the padding lanes via out-of-bounds indices, so the
        # jitted scatter caches on the compacted width alone
        scatter_idx = np.full(width, batch, np.int64)
        scatter_idx[: alive.size] = alive
        sub_state = _gather_tree(full.state, jnp.asarray(gather_idx))
        leg = min(chunk, max_iterations - done)
        sub = optimize_batched_fused_from_state(
            obj, sub_state, max_iterations=leg, **common
        )
        full = _scatter_tree(full, sub, jnp.asarray(scatter_idx))
        done += leg
    return full
