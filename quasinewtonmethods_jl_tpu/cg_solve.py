"""Nonlinear conjugate-gradient fleet engine (memoryless quasi-Newton).

The lightest member of the optimizer family: where BFGS carries an (n, n)
inverse Hessian (reference src/QuasiNewtonMethods.jl:34-69), L-BFGS an
(m, n) pair ring, and the trust-region engine touches curvature through
HVPs, nonlinear CG carries exactly ONE extra (n,) vector — the previous
search direction. Hager–Zhang CG is equivalent to memoryless BFGS under
exact line search, which is why it belongs in a package of quasi-Newton
methods: it is the m = 0 end of the L-BFGS memory spectrum.

Why it earns a slot on an accelerator (the bandwidth argument): at very large n
the L-BFGS fleet iteration is ring-bandwidth-bound — ~5-7 passes over the
(m, n, batch) rings (measured, see lbfgs_batched_solve.py) — while a CG
iteration is a handful of (n, batch) elementwise passes plus the line
search's gradient evaluations. When the objective's value_and_grad is
itself cheap (elementwise / fused matvec), CG's per-iteration HBM traffic
is ~m× lower; the trade is more outer iterations (no curvature memory),
so which engine wins is a measured, problem-dependent call.

accelerator-first shape, same as every engine here (SURVEY.md §3): one
masked-lockstep `lax.while_loop` over the whole fleet (the round-2
lesson — never vmap a data-dependent while), lane-minor (n, batch)
layout, static shapes, elementwise β/restart control. Library-wide
contracts hold: maximization convention (``obj`` is a logdensity),
Status codes, ``fun`` NaN on ANY failure with the iterate frozen at the
last good point, α = 0 line-search sentinel, chunked resume == one long
run, checkpointable state.

β formulas (maximization form — derived by running the textbook
minimization formulas on F = −obj, whose gradient is −g; the repo-wide
pair convention y = g_old − g IS the minimization y_F = ∇F − ∇F_old):

    FR:  β = g·g / g_old·g_old                      (Fletcher–Reeves)
    PR+: β = max(0, g·(g − g_old) / g_old·g_old)    (Polak–Ribière+)
    DY:  β = g·g / d·y                              (Dai–Yuan)
    HZ:  β = max( (2 (d·g)(y·y)/(d·y) − y·g) / (d·y),
                  −1 / (‖d‖ min(0.01, ‖g_old‖)) )   (Hager–Zhang, with
                  the CG_DESCENT lower truncation that guarantees the
                  ascent property under Wolfe searches)

Default 'hz' with the weak-Wolfe search (ops/wolfe.py) — CG's β quality
depends on the curvature condition holding, which backtracking does not
test. Any non-ascent direction (d·g ≤ 0, NaN β, first iteration) resets
in-band to steepest ascent; 'fr'/'pr' additionally take the classic
Powell restart when |g·g_old| > ν g·g (default ν = 0.2 — conjugacy lost).

Line-search warm start: the step along d is pre-scaled by
t = α_prev · m_prev / m (first-order match with the previous accepted
step, Nocedal & Wright eq. 3.60) so the shared Wolfe/backtracking
searches can keep their fixed α = 1 start — the scale rides the
direction, acceptance conditions are invariant under (d, α) → (t·d, α/t).
Without this, unit steps along raw gradients make CG uncompetitive on
badly scaled problems (BFGS gets its natural α = 1 from B; CG has no B).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .batched_solve import _batched_linesearch, _batched_wolfe
from .ops.linesearch import BackTracking
from .ops.wolfe import Wolfe
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT
from .state import Status

__all__ = ["CGResult", "CGState", "optimize_cg", "optimize_cg_from_state"]

_CG_METHODS = ("hz", "pr", "fr", "dy")


class CGState(NamedTuple):
    """Nonlinear-CG solver state (resumable / checkpointable).

    Every leaf has a leading (batch,) axis (rank-1 solves are stored as a
    batch of one). (fun, grad) hold the objective's evaluation at ``x``;
    ``d`` is the last search direction actually used (post-reset), and
    (m_prev, t_prev) are the directional derivative and effective step of
    the last accepted step — the warm-start pair. m_prev == 0 marks a
    lane that has never stepped (fresh → steepest ascent)."""

    x: jax.Array  # (B, n) iterate
    grad: jax.Array  # (B, n) ∇obj at x
    grad_old: jax.Array  # (B, n) gradient at the previous iterate
    d: jax.Array  # (B, n) previous search direction
    m_prev: jax.Array  # (B,) previous d·g (0 = never stepped)
    t_prev: jax.Array  # (B,) previous accepted effective step α·t
    fun: jax.Array  # (B,) objective at x
    k: jax.Array  # (B,) int32 lifetime iterations
    status: jax.Array  # (B,) int32 Status
    n_fev: jax.Array  # (B,) int32
    n_gev: jax.Array  # (B,) int32
    n_resets: jax.Array  # (B,) int32 steepest restarts (incl. Powell)
    stall: jax.Array  # (B,) int32 consecutive non-improving iterations


class CGResult(NamedTuple):
    """Nonlinear-CG result — the library-wide in-band contract: ``fun`` is
    the maximized logdensity on convergence and NaN on ANY failure path;
    ``last_value`` is the final value regardless of status."""

    x: jax.Array
    fun: jax.Array
    grad: jax.Array
    status: jax.Array
    iterations: jax.Array
    n_fev: jax.Array
    n_gev: jax.Array
    n_resets: jax.Array
    last_value: jax.Array
    state: CGState

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


class _CGCarry(NamedTuple):
    X: jax.Array  # (n, batch)
    G: jax.Array  # (n, batch) gradient at X (the fold invariant)
    G_old: jax.Array  # (n, batch)
    D: jax.Array  # (n, batch)
    m_prev: jax.Array  # (batch,)
    t_prev: jax.Array  # (batch,)
    fun: jax.Array  # (batch,) objective at X (the fold invariant)
    fprev: jax.Array  # (batch,) previous iteration's objective (stall)
    k: jax.Array  # ()
    status: jax.Array  # (batch,) int32
    iterations: jax.Array
    n_fev: jax.Array
    n_gev: jax.Array
    n_resets: jax.Array
    stall: jax.Array


def _cg_beta(method: str, g, G_old, D, restart_nu: float, P=None):
    """(β, forced-restart mask) for the configured formula — all reductions
    are (batch,)-shaped axis-0 sums over the lane-minor (n, batch) layout.
    Division guards are by construction: a zero/NaN denominator produces a
    non-finite β, the resulting direction fails the ascent test, and the
    in-band steepest reset catches it — no special-casing in the body.

    ``P`` (optional, (n, batch) positive) is the diagonal PRECONDITIONER
    applied to gradients (P ≈ 1/|diag H|). Preconditioned CG is plain CG
    on the rescaled variables x̃ = P^{-1/2}x, so each formula below is the
    textbook one with the x̃-space inner products substituted: gradient
    products pick up a P (g̃·g̃ = g·Pg), the direction-gradient and
    direction-y products are INVARIANT (d̃·g̃ = d·g, d̃·ỹ = d·y), and
    HZ's ‖d̃‖ = √(d·d/P)."""
    if P is None:
        gg = jnp.sum(g * g, axis=0)
        gg_old = jnp.sum(G_old * G_old, axis=0)
        gdotgold = jnp.sum(g * G_old, axis=0)
    else:
        gg = jnp.sum(g * P * g, axis=0)
        gg_old = jnp.sum(G_old * P * G_old, axis=0)
        gdotgold = jnp.sum(g * P * G_old, axis=0)
    if method == "fr":
        beta = gg / gg_old
    elif method == "pr":
        beta = jnp.maximum(0.0, (gg - gdotgold) / gg_old)
    elif method == "dy":
        y = G_old - g
        beta = gg / jnp.sum(D * y, axis=0)
    elif method == "hz":
        y = G_old - g
        dy = jnp.sum(D * y, axis=0)
        dg = jnp.sum(D * g, axis=0)
        if P is None:
            yy = jnp.sum(y * y, axis=0)
            yg = jnp.sum(y * g, axis=0)
            dnorm = jnp.sqrt(jnp.sum(D * D, axis=0))
        else:
            yy = jnp.sum(y * P * y, axis=0)
            yg = jnp.sum(y * P * g, axis=0)
            dnorm = jnp.sqrt(jnp.sum(D * D / P, axis=0))
        beta = (2.0 * dg * yy / dy - yg) / dy
        eta_k = -1.0 / (dnorm * jnp.minimum(0.01, jnp.sqrt(gg_old)))
        beta = jnp.maximum(beta, eta_k)
    else:  # pragma: no cover - validated at the public entry
        raise ValueError(f"unknown CG method {method!r}")
    if method in ("fr", "pr"):
        # Powell restart: successive gradients far from orthogonal means
        # the conjugacy assumption behind β has broken down
        powell = jnp.abs(gdotgold) > restart_nu * gg
    else:
        # HZ's lower truncation / DY's self-restart property play that role
        powell = jnp.zeros(gg.shape, bool)
    return beta, powell, gg


_HUTCHINSON_SEED_CG = 0x7453  # distinct from TR's stream


def _jacobi_precond_cg(hvp_b, X, k, probes):
    """(n, batch) positive diagonal preconditioner P ≈ 1/|diag H| at X —
    the shared Hutchinson estimator (`ops.hutchinson.hutchinson_abs_diag`,
    lane-minor form) inverted. The guard makes the inversion flush-safe:
    a fully-degenerate lane estimates the identity scaling (P = 1)
    instead of dividing by a flushed-to-zero tiny constant."""
    from .ops.hutchinson import hutchinson_abs_diag

    return 1.0 / hutchinson_abs_diag(
        hvp_b, X, k, probes, _HUTCHINSON_SEED_CG, param_axis=0
    )


def _cg_loop_batched(
    vag_b, f_b, carry0: _CGCarry, method: str, ls, tol,
    max_iterations: int, stall_limit: int, restart_nu: float,
    fold_eval: bool = False, precond_mode: str = "none",
    precond_P=None, hvp_b=None, precond_probes: int = 2,
) -> _CGCarry:
    dtype = carry0.X.dtype
    tol = jnp.asarray(tol, dtype)
    use_wolfe = isinstance(ls, Wolfe)
    # fold needs the trial gradients only the Wolfe search evaluates
    fold = use_wolfe and fold_eval

    def cond(c: _CGCarry):
        return jnp.logical_and(
            c.k < max_iterations, jnp.any(c.status == Status.RUNNING)
        )

    def body(c: _CGCarry):
        if fold:
            # fold_eval (Wolfe path only): every Wolfe trial
            # is a value_and_grad anyway, so the ACCEPTED trial's
            # (value, gradient) seed this iteration — no top-of-iteration
            # evaluation. For CG this is a real win, not the L-BFGS
            # engine's wall-neutral nicety: the objective eval is the
            # dominant per-iteration cost when there is no curvature
            # state to update.
            # Invariant: (c.fun, c.G) are the evaluation at c.X.
            f0, g = c.fun, c.G
        else:
            f0, g = vag_b(c.X)
        was_active = c.status == Status.RUNNING
        nonfinite = ~jnp.isfinite(f0)
        converged = jnp.max(jnp.abs(g), axis=0) < tol
        improved = jnp.where(jnp.isnan(c.fprev), True, f0 > c.fprev)
        stall = jnp.where(
            was_active & ~improved, c.stall + 1, jnp.zeros_like(c.stall)
        )
        stall = jnp.where(was_active, stall, c.stall)
        stalled = (
            stall >= stall_limit if stall_limit else jnp.zeros_like(was_active)
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
        active = (status_pre == Status.RUNNING) & was_active

        if precond_mode == "none":
            P = None
            Pg = g
            probe_gev = 0
        elif precond_mode == "fixed":
            P = precond_P
            Pg = P * g
            probe_gev = 0
        else:  # jacobi: re-estimate at the current fleet iterate; the
            # probe key folds the fleet's max LIFETIME iteration count
            # (not the leg-local c.k) so chunked resume replays the
            # exact probe stream of an uninterrupted run (TR's scheme)
            P = _jacobi_precond_cg(
                hvp_b, c.X, jnp.max(c.iterations), precond_probes
            )
            Pg = P * g
            probe_gev = precond_probes
        beta, powell, gg = _cg_beta(method, g, c.G_old, c.D, restart_nu, P)
        fresh = c.m_prev == 0.0  # never stepped (init or resume of same)
        # preconditioned direction: d = Pg + β d_prev (x̃-space steepest
        # ascent is P·g back in x space); gg is the x̃-space ‖g̃‖² from
        # _cg_beta, which is exactly (Pg)·g — the reset-direction slope
        d = Pg + beta[None, :] * c.D
        m = jnp.sum(d * g, axis=0)
        # in-band steepest reset: non-ascent (covers NaN β/m via the
        # ~finite test — NaN comparisons are False so test explicitly),
        # first iteration, lost conjugacy
        reset = (~jnp.isfinite(m)) | (m <= 0.0) | fresh | powell
        d = jnp.where(active[None, :], jnp.where(reset[None, :], Pg, d), 0.0)
        m = jnp.where(active, jnp.where(reset, gg, m), jnp.ones_like(m))

        # warm-start scale (first-order match with the previous step);
        # fresh/restarted-from-garbage lanes fall back to 1/max(1, ‖g‖)
        t0 = 1.0 / jnp.maximum(1.0, jnp.sqrt(gg))
        t = c.t_prev * c.m_prev / m
        t_ok = jnp.isfinite(t) & (t > 0.0)
        t = jnp.where(fresh | ~t_ok, t0, t)
        t = jnp.clip(t, 1e-12, 1e12)
        d_ls = t[None, :] * d
        m_ls = t * m

        if use_wolfe:

            def phi_vag(alpha):
                fv, gv = vag_b(c.X + alpha[None, :] * d_ls)
                return fv, jnp.sum(gv * d_ls, axis=0), gv

            alpha, ls_fev, _it, ls_failed, f_acc, G_acc = _batched_wolfe(
                phi_vag, f0, m_ls, active, ls, dtype, with_grad=fold
            )
            ls_gev = ls_fev
        else:

            def phi(alpha):
                return f_b(c.X + alpha[None, :] * d_ls)

            alpha, ls_fev, _it, ls_failed = _batched_linesearch(
                phi, f0, m_ls, active, ls, dtype
            )
            ls_gev = jnp.zeros_like(ls_fev)

        take = active & ~ls_failed
        # step along the SCALED direction, bitwise the accepted trial's
        # point — the fold invariant needs X_new == the point (f_acc,
        # G_acc) were evaluated at, so alpha * d_ls, not (alpha*t) * d
        step = jnp.where(take[None, :], alpha[None, :] * d_ls, 0.0)
        new_status = jnp.where(
            active & ls_failed,
            jnp.int32(Status.LINESEARCH_FAILURE),
            status_pre,
        )
        wmask = was_active[None, :]
        amask = active[None, :]
        tmask = take[None, :]
        if fold:
            # fold: (fun, G) move to the accepted trial's evaluation
            fun_new = jnp.where(take, f_acc, jnp.where(was_active, f0, c.fun))
            G_new = jnp.where(tmask, G_acc, jnp.where(wmask, g, c.G))
        else:
            fun_new = jnp.where(was_active, f0, c.fun)
            G_new = jnp.where(wmask, g, c.G)
        return _CGCarry(
            X=c.X + step,
            G=G_new,
            G_old=jnp.where(amask, g, c.G_old),
            D=jnp.where(amask, d, c.D),
            m_prev=jnp.where(take, m, c.m_prev),
            t_prev=jnp.where(take, alpha * t, c.t_prev),
            fun=fun_new,
            fprev=jnp.where(was_active, f0, c.fprev),
            k=c.k + 1,
            status=new_status,
            iterations=c.iterations + active.astype(jnp.int32),
            # fold: no top-of-iteration evaluation — only the trials count
            n_fev=c.n_fev + ls_fev + (
                jnp.zeros_like(ls_fev) if fold
                else was_active.astype(jnp.int32)
            ),
            n_gev=c.n_gev + ls_gev + (
                jnp.zeros_like(ls_fev) if fold
                else was_active.astype(jnp.int32)
            ) + probe_gev * active.astype(jnp.int32),
            n_resets=c.n_resets + (reset & active).astype(jnp.int32),
            stall=stall,
        )

    final = lax.while_loop(cond, body, carry0)
    return final._replace(
        status=jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            final.status,
        )
    )


def _result_from_cg_carry(fc: _CGCarry, squeeze: bool) -> CGResult:
    dtype = fc.X.dtype
    state = CGState(
        x=fc.X.T,
        grad=fc.G.T,
        grad_old=fc.G_old.T,
        d=fc.D.T,
        m_prev=fc.m_prev,
        t_prev=fc.t_prev,
        fun=fc.fun,
        k=fc.iterations,
        status=fc.status,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        stall=fc.stall,
    )
    nan = jnp.asarray(jnp.nan, dtype)
    res = CGResult(
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
    if squeeze:
        res = jax.tree_util.tree_map(lambda a: a[0], res)
    return res


def _fresh_cg_carry(X, status0):
    """Fresh CG fleet carry for a (n, batch) lane-minor fleet (single
    source of the carry layout — engine jit and the constrained fleet's
    inner solves both build here; review finding, round 5). The fold
    path overrides (fun, G, n_fev/n_gev) via _replace after seeding."""
    n, batch = X.shape
    dtype = X.dtype
    zero_v = jnp.zeros((n, batch), dtype)
    zero_b = jnp.zeros((batch,), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)
    return _CGCarry(
        X=X,
        G=zero_v,
        G_old=zero_v,
        D=zero_v,
        m_prev=zero_b,  # 0 = fresh -> steepest first step
        t_prev=zero_b,
        fun=jnp.full((batch,), jnp.nan, dtype),
        fprev=jnp.full((batch,), jnp.nan, dtype),
        k=jnp.zeros((), jnp.int32),
        status=status0,
        iterations=zero_i,
        n_fev=zero_i,
        n_gev=zero_i,
        n_resets=zero_i,
        stall=zero_i,
    )


def _cg_precond_pieces(vag, precond_mode, precond_diag, n, batch, dtype):
    """(hvp_b, P) for the configured preconditioning mode. 'fixed' turns
    the user's Hessian-diagonal estimate into the lane-minor inverse
    P = 1/diag; 'jacobi' builds the fleet HVP (one jvp through the
    gradient per probe — works through analytic value_and_grad_fn too,
    same requirement as the TR engine: it must be jax-traceable)."""
    hvp_b = None
    P = None
    if precond_mode == "jacobi":

        def grad_one(x):
            return vag(x)[1]

        def hvp_one(x, v):
            return jax.jvp(grad_one, (x,), (v,))[1]

        hvp_b = jax.vmap(hvp_one, in_axes=(1, 1), out_axes=1)
    elif precond_mode == "fixed":
        diag = jnp.broadcast_to(
            jnp.asarray(precond_diag, dtype), (batch, n)
        )
        P = (1.0 / diag).T
    return hvp_b, P


@partial(
    jax.jit,
    static_argnames=(
        "obj", "method", "ls", "max_iterations", "value_and_grad_fn",
        "stall_limit", "restart_nu", "fold_eval", "_squeeze",
        "precond_mode", "precond_probes",
    ),
)
def _optimize_cg_jit(
    obj, x0s, method, ls, tol, max_iterations, value_and_grad_fn,
    stall_limit, restart_nu, fold_eval, _squeeze,
    precond_mode="none", precond_diag=None, precond_probes=2,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)

    batch, n = x0s.shape
    dtype = x0s.dtype
    X0 = x0s.T
    carry0 = _fresh_cg_carry(
        X0, jnp.full((batch,), Status.RUNNING, jnp.int32)
    )
    if isinstance(ls, Wolfe) and fold_eval:
        # seed the fold invariant: (fun, G) = the evaluation at X
        fun0, G0 = vag_b(X0)
        nfev0 = jnp.ones((batch,), jnp.int32)
        carry0 = carry0._replace(fun=fun0, G=G0, n_fev=nfev0, n_gev=nfev0)
    hvp_b, P = _cg_precond_pieces(
        vag, precond_mode, precond_diag, n, batch, dtype
    )
    fc = _cg_loop_batched(
        vag_b, f_b, carry0, method, ls, tol, max_iterations,
        stall_limit, restart_nu, fold_eval,
        precond_mode, P, hvp_b, precond_probes,
    )
    return _result_from_cg_carry(fc, _squeeze)


def optimize_cg(
    obj,
    x0: jax.Array,
    *,
    method: str = "hz",
    ls: Union[Wolfe, BackTracking] = Wolfe(approx=True),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    restart_nu: float = 0.2,
    fold_eval: bool = False,
    precondition=None,
    precond_probes: int = 2,
) -> CGResult:
    """Maximize a logdensity by nonlinear conjugate gradients.

    The O(n)-state member of the engine family — no inverse Hessian, no
    pair ring: per iteration one gradient, a β-weighted direction update,
    and a line search. Use it when n is large enough that even the L-BFGS
    ring's HBM traffic binds, or when the objective is cheap and fleet
    memory is the constraint; prefer BFGS/L-BFGS when curvature memory
    pays (fewer iterations), and the TR engine on stiff/indefinite
    surfaces.

    A rank-1 ``x0`` runs a single solve; a rank-2 (batch, n) ``x0`` runs
    the masked-lockstep fleet (same pattern as every engine here).

    ``method``: 'hz' (Hager–Zhang, default), 'pr' (Polak–Ribière+),
    'fr' (Fletcher–Reeves), 'dy' (Dai–Yuan). ``ls``: a `Wolfe` (default —
    CG's β quality needs the curvature condition) or a `BackTracking`
    (value-only trials; safe with every method via the in-band steepest
    reset, but expect more restarts). ``restart_nu``: Powell-restart
    threshold for 'fr'/'pr' (|g·g_old| > ν g·g → steepest reset).
    ``fold_eval`` (Wolfe path only, default OFF): seed each iteration
    with the accepted trial's (value, gradient) instead of a
    top-of-iteration evaluation — ~40% fewer objective evals, but the
    (n, batch) gradient carried through the Wolfe while-loop can cost
    more than the saved eval. Turn it on only when one
    value_and_grad is a large fraction of the iteration wall (very
    large datasets). Trajectories agree at certificate resolution, not
    bitwise.

    Preconditioning (``precondition``, default None = plain CG): CG's
    known weakness is conditioning — it pays O(√cond) iterations where
    curvature-carrying engines pay O(1) extra memory. 'jacobi' runs the
    PRECONDITIONED iteration with a per-iteration Hutchinson estimate of
    1/|diag(H)| (``precond_probes`` HVPs per outer iteration, counted in
    ``n_gev``; one jvp through the gradient each — analytic
    ``value_and_grad_fn`` must be jax-traceable); a positive array
    (broadcastable to (n,) or the fleet's (batch, n)) uses that FIXED
    Hessian-diagonal estimate at zero probe cost. Mathematically this is
    plain CG on the rescaled variables x̃ = diag^{1/2}x — the analog of
    the BFGS engine's H0/BB scaling and the TR engine's Jacobi-CG knob.

    Same contracts as every engine: convergence certificate
    max|∇obj| < ``tol``; ``fun`` NaN unless converged; α = 0 line-search
    sentinel → Status.LINESEARCH_FAILURE with the iterate at the last
    good point; ``stall_limit`` consecutive non-improving iterations
    fail in-band; resumable via `optimize_cg_from_state` (pass the same
    ``precondition``). f32 guidance: tol >= ~1e-3, as usual.
    """
    X0 = jnp.asarray(x0)
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {X0.shape}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
    if method not in _CG_METHODS:
        raise ValueError(f"method must be one of {_CG_METHODS}, got {method!r}")
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if not 0.0 < restart_nu:
        raise ValueError(f"restart_nu must be > 0, got {restart_nu}")
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    from .trust_region import _resolve_precondition

    precond_mode, precond_diag = _resolve_precondition(
        precondition, X0.shape[-1]
    )
    return _optimize_cg_jit(
        obj, X0, method, ls, tol, max_iterations, value_and_grad_fn,
        stall_limit, float(restart_nu), bool(fold_eval), squeeze,
        precond_mode=precond_mode, precond_diag=precond_diag,
        precond_probes=int(precond_probes),
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "method", "ls", "max_iterations", "value_and_grad_fn",
        "stall_limit", "restart_nu", "fold_eval", "_squeeze",
        "precond_mode", "precond_probes",
    ),
)
def _optimize_cg_resume_jit(
    obj, state, method, ls, tol, max_iterations, value_and_grad_fn,
    stall_limit, restart_nu, fold_eval, _squeeze,
    precond_mode="none", precond_diag=None, precond_probes=2,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)
    carry0 = _CGCarry(
        X=state.x.T,
        # the fold invariant at resume: a Wolfe-run state carries (fun,
        # grad) AT x (part of the pass-the-same-ls resume contract); the
        # backtracking body re-evaluates at the top regardless
        G=state.grad.T,
        G_old=state.grad_old.T,
        D=state.d.T,
        m_prev=state.m_prev,
        t_prev=state.t_prev,
        fun=state.fun,
        # fresh stall comparison base per leg (matches the fresh stall
        # budget below)
        fprev=jnp.full(state.fun.shape, jnp.nan, state.fun.dtype),
        k=jnp.zeros((), jnp.int32),
        status=jnp.full(state.fun.shape, Status.RUNNING, jnp.int32),
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        # fresh stall budget per leg (same rationale as the other fleets)
        stall=jnp.zeros_like(state.stall),
    )
    batch_r, n_r = state.x.shape
    hvp_b, P = _cg_precond_pieces(
        vag, precond_mode, precond_diag, n_r, batch_r, state.x.dtype
    )
    fc = _cg_loop_batched(
        vag_b, f_b, carry0, method, ls, tol, max_iterations,
        stall_limit, restart_nu, fold_eval,
        precond_mode, P, hvp_b, precond_probes,
    )
    return _result_from_cg_carry(fc, _squeeze)


def optimize_cg_from_state(
    obj,
    state: CGState,
    *,
    method: str = "hz",
    ls: Union[Wolfe, BackTracking] = Wolfe(approx=True),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    restart_nu: float = 0.2,
    fold_eval: bool = False,
    precondition=None,
    precond_probes: int = 2,
) -> CGResult:
    """Resume a nonlinear-CG solve/fleet from a (checkpointed) CGState.

    All lanes re-arm to RUNNING (converged lanes can be re-solved under a
    tighter tol); counters continue from the saved values and
    ``max_iterations`` bounds this leg. A resumed lane CONTINUES its CG
    trajectory: the saved (grad_old, d, m_prev, t_prev) drive the first
    β and warm start exactly as the uninterrupted run would (chunked ==
    one long run, regression-tested); lanes that never stepped
    (m_prev == 0) take the steepest first step naturally. Pass the SAME
    ``method``/``ls``/``restart_nu``/``fold_eval``/``precondition`` as
    the original run for trajectory continuation (the fold invariant
    trusts the saved (fun, grad) to be the evaluation at x; the jacobi
    probe stream is keyed off the saved lifetime iteration count, so a
    resumed leg replays the exact probes of an uninterrupted run)."""
    if method not in _CG_METHODS:
        raise ValueError(f"method must be one of {_CG_METHODS}, got {method!r}")
    # a rank-1 (single-solve) result's state was squeezed: re-batch it
    # (the same re-batching optimize_tr_from_state does)
    squeeze = state.x.ndim == 1
    if squeeze:
        state = jax.tree_util.tree_map(
            lambda l: jnp.asarray(l)[None], state
        )
    if state.x.ndim != 2:
        raise ValueError(
            f"expected a rank-1 or rank-2 CGState, got x shape {state.x.shape}"
        )
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    from .trust_region import _resolve_precondition

    precond_mode, precond_diag = _resolve_precondition(
        precondition, state.x.shape[-1]
    )
    return _optimize_cg_resume_jit(
        obj, state, method, ls, tol, max_iterations, value_and_grad_fn,
        stall_limit, float(restart_nu), bool(fold_eval), squeeze,
        precond_mode=precond_mode, precond_diag=precond_diag,
        precond_probes=int(precond_probes),
    )
