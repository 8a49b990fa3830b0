"""Trust-region Newton–Krylov (Steihaug-CG) fleet engine.

The exact-curvature member of the optimizer family: where the BFGS/L-BFGS
drivers build secant curvature (reference src/QuasiNewtonMethods.jl:34-69)
and `least_squares` uses Gauss–Newton structure, this engine solves the
trust-region Newton model

    min_p  g·p + ½ pᵀHp   s.t. ‖p‖ ≤ Δ

per iteration with MATRIX-FREE conjugate gradients — H is touched only
through Hessian-vector products (one `jax.jvp` through the gradient, so a
fleet of HVPs is one batched forward-over-reverse sweep; no
(n, n) matrix ever materializes, unlike `polish_newton`'s dense factor).
Steihaug's rules make CG trust-region-safe: stop at the boundary, and a
negative-curvature direction (the case that breaks line-search Newton and
poisons secant updates) is RIDDEN to the boundary instead of feared —
which is exactly why this is the robust engine for stiff/indefinite MAP
surfaces where quasi-Newton stalls.

accelerator-first shape, same as every engine here (SURVEY.md §3): one
masked-lockstep `lax.while_loop` fleet for the outer iteration and one
for the inner CG (the round-2 lesson — nested data-dependent loops are
hand-masked, never vmapped), elementwise accept/reject/Δ-control, static
shapes throughout. Library-wide contracts hold: maximization convention
(``obj`` is a logdensity; minimization runs on −obj internally), Status
codes, ``fun`` NaN on ANY failure with the iterate frozen at the last
good point, Δ-collapse ↔ LINESEARCH_FAILURE (the in-band analog of a
failed line search), chunked resume == one long run, checkpointable
state.

Inexact-Newton forcing: CG stops at ‖r‖ ≤ η‖g‖ with the Eisenstat–Walker
choice η = min(0.5, √‖g‖) (scaled by ``cg_tol``), so early iterations do
cheap loose solves and late iterations sharpen toward quadratic local
convergence.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad
from .least_squares import _check_bounds, _kkt_criticality
from .state import Status

TR_MAX_ITERATIONS_DEFAULT = 500
TR_STALL_LIMIT = 30  # consecutive rejected trials before Δ-collapse failure


class TRState(NamedTuple):
    """Trust-region fleet state (carry of the outer while-loop).

    Every leaf has a leading (batch,) axis. (fun, g) always hold the
    MINIMIZATION objective's evaluation at ``x`` — the same "evaluation
    lives at the iterate" invariant as the rotated BFGS driver loop and
    the LM engine, which keeps the body free of re-evaluation conds.
    """

    x: jax.Array  # (B, n) iterate
    fun: jax.Array  # (B,) −obj(x), the minimized value
    g: jax.Array  # (B, n) ∇(−obj) at x
    delta: jax.Array  # (B,) trust radius
    k: jax.Array  # (B,) int32 iterations executed
    status: jax.Array  # (B,) int32 Status
    n_fev: jax.Array  # (B,) int32 objective evaluations
    n_hev: jax.Array  # (B,) int32 Hessian-vector products
    stall: jax.Array  # (B,) int32 consecutive rejected trials


class TRResult(NamedTuple):
    """Trust-region solve result — the library-wide in-band contract:
    ``fun`` is the MAXIMIZED logdensity on convergence and NaN on ANY
    failure path; ``last_value`` is the final value regardless of status."""

    x: jax.Array
    fun: jax.Array
    grad: jax.Array  # ∇obj at x (maximization orientation)
    status: jax.Array
    iterations: jax.Array
    n_fev: jax.Array
    n_hev: jax.Array  # Hessian-vector products (the engine's unit of work)
    delta: jax.Array  # final trust radius (diagnostic)
    last_value: jax.Array
    state: TRState  # resumable via optimize_tr_from_state

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


def _make_fleet_fns(obj, value_and_grad_fn):
    """(vag, hvp) on the MINIMIZATION objective, batched over lanes.

    hvp(x, v) = ∇²(−obj)(x)·v via one jvp through the gradient —
    forward-over-reverse, the cheap direction for a single vector.
    """
    vag_max = as_value_and_grad(obj, value_and_grad_fn)

    def vag_min_one(x):
        f, g = vag_max(x)
        return -f, -g

    def grad_min_one(x):
        return vag_min_one(x)[1]

    def hvp_one(x, v):
        return jax.jvp(grad_min_one, (x,), (v,))[1]

    return jax.vmap(vag_min_one), jax.vmap(hvp_one)


def _steihaug_cg(hvp_fleet, x, g, delta, active, max_cg, cg_tol,
                 free=None, want_hp=True, Mdiag=None):
    """Batched Steihaug-Toint truncated CG (optionally preconditioned).

    Returns (p, Hp, iters_used, hit_boundary). Frozen/converged lanes
    idle behind the ``active`` mask (their p stays 0). Hp comes from one
    extra batched HVP at the end — exact for every exit path (interior,
    boundary, negative curvature), where the CG residual invariant only
    covers interior exits.

    ``free`` (bool, same shape as x; bounded path only) restricts the
    solve to the free subspace: the initial residual is the masked
    gradient and every H·d is re-masked, so all CG vectors stay
    supported on free coordinates and blocked coordinates get an
    exactly-zero step (the projected-TR analog of the LM engine's
    masked normal equations).

    ``Mdiag`` (positive, (B, n)) turns this into PRECONDITIONED
    Steihaug-CG (Conn–Gould–Toint Alg. 7.5.1 shape): z = M⁻¹r drives
    the search directions and the trust region lives in the M-norm
    ‖p‖_M = √(pᵀMp) — equivalent to plain Steihaug on the
    diagonally-rescaled variables M^{1/2}x, so a good diagonal collapses
    the inner iteration count on stiff (badly row-scaled) Hessians.
    The CG STOP test stays on the true residual ‖r‖₂ ≤ η‖g‖₂ (the
    Eisenstat–Walker forcing must measure the actual Newton residual,
    not the preconditioned one). ``Mdiag=None`` is bitwise the
    unpreconditioned path.
    """
    dtype = x.dtype
    B, n = x.shape
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    if free is not None:
        fm = free.astype(dtype)
        g = g * fm
        hvp_inner = hvp_fleet
        hvp_fleet = lambda xx, vv: hvp_inner(xx, vv) * fm

    if Mdiag is None:
        apply_minv = lambda r: r
        wdot = lambda a, b: jnp.sum(a * b, axis=-1)
    else:
        apply_minv = lambda r: r / Mdiag
        wdot = lambda a, b: jnp.sum(Mdiag * a * b, axis=-1)

    gnorm = jnp.linalg.norm(g, axis=-1)
    # Eisenstat–Walker forcing: loose early, sharp near the solution
    eta = cg_tol * jnp.minimum(0.5, jnp.sqrt(jnp.maximum(gnorm, tiny)))
    r_stop = eta * gnorm

    def boundary_tau(p, d, pp, dd):
        # positive root of ‖p + τd‖_M² = Δ² (dd > 0 whenever called with
        # an active direction; tiny-guarded for masked lanes)
        pd = wdot(p, d)
        disc = pd * pd + jnp.maximum(dd, tiny) * (delta * delta - pp)
        return (-pd + jnp.sqrt(jnp.maximum(disc, 0.0))) / jnp.maximum(dd, tiny)

    def cond(c):
        p, r, d, rz, cg_act, j = c
        return (j < max_cg) & jnp.any(cg_act)

    def body(c):
        p, r, d, rz, cg_act, j = c
        Hd = hvp_fleet(x, d)
        dHd = jnp.sum(d * Hd, axis=-1)
        pp = wdot(p, p)

        neg_curv = dHd <= 0.0
        alpha = rz / jnp.where(neg_curv, 1.0, jnp.maximum(dHd, tiny))
        p_int = p + alpha[:, None] * d
        leaves = wdot(p_int, p_int) > delta * delta

        tau = boundary_tau(p, d, pp, wdot(d, d))
        p_bnd = p + tau[:, None] * d

        to_boundary = cg_act & (neg_curv | leaves)
        step_in = cg_act & ~to_boundary

        p_new = jnp.where(to_boundary[:, None], p_bnd,
                          jnp.where(step_in[:, None], p_int, p))
        r_new = jnp.where(step_in[:, None], r + alpha[:, None] * Hd, r)
        z_new = apply_minv(r_new)
        rz_new = jnp.where(step_in, jnp.sum(r_new * z_new, axis=-1), rz)

        small = jnp.sqrt(jnp.sum(r_new * r_new, axis=-1)) <= r_stop
        cg_act_new = cg_act & ~to_boundary & ~small
        beta = rz_new / jnp.maximum(rz, tiny)
        d_new = jnp.where(cg_act_new[:, None], -z_new + beta[:, None] * d, d)
        return p_new, r_new, d_new, rz_new, cg_act_new, j + 1

    p0 = jnp.zeros_like(x)
    r0 = g
    z0 = apply_minv(r0)
    rz0 = jnp.sum(r0 * z0, axis=-1)
    # lanes already within tolerance at p=0 never enter CG
    cg_act0 = active & (jnp.sqrt(jnp.sum(r0 * r0, axis=-1)) > r_stop)
    init = (p0, r0, -z0, rz0, cg_act0, jnp.zeros((), jnp.int32))
    p, r, d, rz, cg_act, j = lax.while_loop(cond, body, init)

    # want_hp=False lets the bounded caller skip this sweep: it clips the
    # step and needs H·(clipped p) instead, so this Hp would be discarded
    Hp = hvp_fleet(x, p) if want_hp else None
    hit_boundary = wdot(p, p) >= (1.0 - 1e-6) * delta * delta
    return p, Hp, j, hit_boundary


_HUTCHINSON_SEED = 0x7452  # arbitrary fixed stream, folded with max(k)


def _jacobi_diag(hvp_fleet, x, k, probes):
    """Hutchinson diagonal estimate of the (minimization) Hessian at x,
    guarded into a positive Jacobi preconditioner — the shared estimator
    (`ops.hutchinson.hutchinson_abs_diag`, batch-major form): (n,)
    probes broadcast across lanes for fleet-vs-solo parity, key folded
    with the fleet's max lifetime iteration count for chunked-resume
    replay, and the flush-safe positivity guard (relative floor; a
    fully-degenerate lane takes the identity scaling — never a
    tiny-constant denominator, which a flushing backend turns into 0).
    """
    from .ops.hutchinson import hutchinson_abs_diag

    return hutchinson_abs_diag(
        hvp_fleet, x, jnp.max(k), probes, _HUTCHINSON_SEED, param_axis=-1
    )


def _tr_cond(max_iterations):
    def cond(s: TRState):
        return jnp.any((s.status == Status.RUNNING) & (s.k < max_iterations))

    return cond


def _tr_body(
    vag_fleet,
    hvp_fleet,
    bounds,
    tol,
    max_iterations,
    max_cg,
    cg_tol,
    delta_max,
    eta_accept,
    precond_mode,
    precond_probes,
    precond_diag,
    s: TRState,
) -> TRState:
    dtype = s.x.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    active = s.status == Status.RUNNING

    # diagonal preconditioner for this iteration (None = plain CG);
    # 'jacobi' re-estimates at the current iterate so the scaling tracks
    # the local Hessian (probes are extra HVPs, counted in n_hev)
    if precond_mode == "none":
        Mdiag = None
        probe_hev = 0
    elif precond_mode == "fixed":
        Mdiag = jnp.broadcast_to(
            jnp.asarray(precond_diag, dtype), s.x.shape
        )
        probe_hev = 0
    else:  # jacobi
        Mdiag = _jacobi_diag(hvp_fleet, s.x, s.k, precond_probes)
        probe_hev = precond_probes

    if bounds is None:
        p, Hp, cg_iters, hit_bnd = _steihaug_cg(
            hvp_fleet, s.x, s.g, s.delta, active, max_cg, cg_tol,
            Mdiag=Mdiag,
        )
        x_t = s.x + p
        # predicted decrease of the quadratic model: −(g·p + ½ pᵀHp) ≥ 0
        # for every Steihaug exit
        pred = -(jnp.sum(s.g * p, axis=-1)
                 + 0.5 * jnp.sum(p * Hp, axis=-1))
        extra_hev = 1
    else:
        lo, hi = bounds
        # blocked = at a face with the (minimization) gradient pushing
        # outward; clipping lands iterates EXACTLY on the face, so ==
        # comparisons fire (same active-set rule as the LM engine)
        blocked = ((s.x <= lo) & (s.g > 0)) | ((s.x >= hi) & (s.g < 0))
        p, _, cg_iters, hit_bnd = _steihaug_cg(
            hvp_fleet, s.x, s.g, s.delta, active, max_cg, cg_tol,
            free=~blocked, want_hp=False, Mdiag=Mdiag,
        )
        # free coordinates may legitimately hit a face mid-step: clip,
        # then score the quadratic model along the step ACTUALLY taken
        # (one HVP on the clipped step — exact)
        x_t = jnp.clip(s.x + p, lo, hi)
        p = x_t - s.x
        Hp = hvp_fleet(s.x, p)
        pred = -(jnp.sum(s.g * p, axis=-1)
                 + 0.5 * jnp.sum(p * Hp, axis=-1))
        extra_hev = 1
    # the radius lives in the trust-region norm: M-norm when
    # preconditioned (the rescaled-variable Euclidean norm), ‖·‖₂ plain
    if Mdiag is None:
        pnorm = jnp.linalg.norm(p, axis=-1)
    else:
        pnorm = jnp.sqrt(jnp.sum(Mdiag * p * p, axis=-1))

    f_t, g_t = vag_fleet(x_t)
    trial_ok = jnp.isfinite(f_t) & jnp.all(jnp.isfinite(g_t), axis=-1)
    rho = (s.fun - f_t) / jnp.maximum(pred, tiny)

    accept = active & trial_ok & (pred > 0.0) & (rho > eta_accept)
    # TR endgame: once the iterate is close enough that the predicted
    # reduction falls below f64's resolution of f (pred < eps·|f*| for
    # |f*| > 0), rho is noise and every trial would be rejected — even a
    # Newton step whose own gradient already CERTIFIES convergence. The
    # certificate is the goal: accept a finite trial that satisfies it,
    # GATED on non-ascent up to rounding slack (without the gate, a
    # grown-radius trial landing in a distant flat/plateau region with
    # small gradient would be accepted despite f_t >> fun — a
    # non-monotone jump no engine in this library is allowed to make).
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    slack = 32.0 * eps * jnp.maximum(jnp.abs(s.fun), 1.0)
    trial_certifies = (
        trial_ok
        & (_kkt_criticality(x_t, g_t, bounds) < tol)
        & (f_t <= s.fun + slack)
    )
    accept = accept | (active & trial_certifies)

    # standard radius control: poor model fit shrinks RELATIVE TO THE STEP
    # (‖p‖/4 — shrinking Δ alone can leave Δ ≫ ‖p‖ and change nothing);
    # a good fit that pressed the boundary doubles Δ
    shrink = ~trial_ok | (rho < 0.25)
    grow = trial_ok & (rho > 0.75) & hit_bnd
    delta_new = jnp.where(
        shrink,
        0.25 * jnp.maximum(pnorm, tiny),
        jnp.where(grow, jnp.minimum(2.0 * s.delta, delta_max), s.delta),
    )

    x_new = jnp.where(accept[:, None], x_t, s.x)
    fun_new = jnp.where(accept, f_t, s.fun)
    g_new = jnp.where(accept[:, None], g_t, s.g)
    stall_new = jnp.where(accept, 0, s.stall + 1)

    k_new = jnp.where(active, s.k + 1, s.k)
    # unbounded: max|g| < tol; bounded: the KKT projected-gradient
    # residual (identical helper to the LM engine's certificate)
    converged = _kkt_criticality(x_new, g_new, bounds) < tol
    # Δ-collapse: the float eps floor — further shrinks cannot change x_t
    collapsed = (stall_new >= TR_STALL_LIMIT) | (
        delta_new <= eps * jnp.maximum(jnp.linalg.norm(x_new, axis=-1), 1.0)
    )
    status_new = jnp.where(
        active,
        jnp.where(
            converged,
            Status.CONVERGED,
            jnp.where(
                collapsed,
                Status.LINESEARCH_FAILURE,  # Δ-collapse / trial exhaustion
                jnp.where(
                    k_new >= max_iterations,
                    Status.MAX_ITERATIONS,
                    Status.RUNNING,
                ),
            ),
        ),
        s.status,
    ).astype(jnp.int32)

    return TRState(
        x=x_new,
        fun=fun_new,
        g=g_new,
        delta=jnp.where(active, delta_new, s.delta).astype(dtype),
        k=k_new,
        status=status_new,
        n_fev=jnp.where(active, s.n_fev + 1, s.n_fev),
        n_hev=jnp.where(
            active, s.n_hev + cg_iters + extra_hev + probe_hev, s.n_hev
        ),
        stall=jnp.where(active, stall_new, s.stall),
    )


def _init_tr_state(vag_fleet, X0, delta0) -> TRState:
    B = X0.shape[0]
    dtype = X0.dtype
    f0, g0 = vag_fleet(X0)
    bad = ~(jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0), axis=-1))
    status0 = jnp.where(
        bad, Status.NONFINITE_VALUE, Status.RUNNING
    ).astype(jnp.int32)
    return TRState(
        x=X0,
        fun=f0,
        g=g0,
        delta=jnp.full((B,), delta0, dtype),
        k=jnp.zeros((B,), jnp.int32),
        status=status0,
        n_fev=jnp.ones((B,), jnp.int32),
        n_hev=jnp.zeros((B,), jnp.int32),
        stall=jnp.zeros((B,), jnp.int32),
    )


def _result_from_state(s: TRState, squeeze: bool) -> TRResult:
    ok = s.status == Status.CONVERGED
    nan = jnp.asarray(jnp.nan, s.fun.dtype)
    # back to the library's maximization orientation
    fun_max = -s.fun
    grad_max = -s.g
    r = TRResult(
        x=s.x,
        fun=jnp.where(ok, fun_max, nan),
        grad=grad_max,
        status=s.status,
        iterations=s.k,
        n_fev=s.n_fev,
        n_hev=s.n_hev,
        delta=s.delta,
        last_value=fun_max,
        state=s,
    )
    if squeeze:
        r = jax.tree_util.tree_map(lambda l: l[0], r)
    return r


def _resolve_precondition(precondition, n):
    """(mode, diag) from the public ``precondition=`` knob.

    None → plain CG; 'jacobi' → per-iteration Hutchinson diagonal;
    an array → a FIXED positive diagonal scaling (shape broadcastable
    to (n,) or the fleet's (B, n)), validated eagerly.
    """
    if precondition is None:
        return "none", None
    if isinstance(precondition, str):
        if precondition != "jacobi":
            raise ValueError(
                "precondition must be None, 'jacobi', or a positive "
                f"diagonal array, got {precondition!r}"
            )
        return "jacobi", None
    diag = jnp.asarray(precondition)
    if diag.shape[-1] != n:
        raise ValueError(
            f"precondition diagonal last axis must be n={n}, "
            f"got shape {diag.shape}"
        )
    # validate only when concrete — the public entries must stay
    # wrappable in an outer jax.jit with a traced diagonal (the same
    # rule as optimize_auglag's mu0 check; review finding, round 5)
    try:
        positive = bool(jnp.all(jnp.isfinite(diag) & (diag > 0)))
    except jax.errors.TracerBoolConversionError:
        positive = True
    if not positive:
        raise ValueError("precondition diagonal must be finite and > 0")
    return "fixed", diag


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "value_and_grad_fn",
        "tol",
        "max_iterations",
        "max_cg",
        "cg_tol",
        "delta0",
        "delta_max",
        "eta_accept",
        "precond_mode",
        "precond_probes",
        "_squeeze",
    ),
)
def _optimize_tr_impl(
    obj,
    X0,
    bounds,
    precond_diag,
    value_and_grad_fn,
    tol,
    max_iterations,
    max_cg,
    cg_tol,
    delta0,
    delta_max,
    eta_accept,
    precond_mode,
    precond_probes,
    _squeeze,
):
    vag_fleet, hvp_fleet = _make_fleet_fns(obj, value_and_grad_fn)
    if bounds is not None:
        X0 = jnp.clip(X0, bounds[0], bounds[1])
    s0 = _init_tr_state(vag_fleet, X0, delta0)
    # lanes already at a critical (KKT) point converge without entering
    # the loop
    conv0 = (s0.status == Status.RUNNING) & (
        _kkt_criticality(s0.x, s0.g, bounds) < tol
    )
    s0 = s0._replace(
        status=jnp.where(conv0, Status.CONVERGED, s0.status).astype(jnp.int32)
    )
    body = partial(
        _tr_body, vag_fleet, hvp_fleet, bounds, tol, max_iterations,
        max_cg, cg_tol, delta_max, eta_accept,
        precond_mode, precond_probes, precond_diag,
    )
    s = lax.while_loop(_tr_cond(max_iterations), body, s0)
    return _result_from_state(s, _squeeze)


def optimize_tr(
    obj,
    x0: jax.Array,
    *,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = TR_MAX_ITERATIONS_DEFAULT,
    max_cg: Optional[int] = None,
    cg_tol: float = 1.0,
    delta0: float = 1.0,
    delta_max: float = 1e6,
    eta_accept: float = 1e-4,
    precondition: Optional[Any] = None,
    precond_probes: int = 2,
    value_and_grad_fn: Optional[Callable] = None,
) -> TRResult:
    """Maximize a logdensity by trust-region Newton–Krylov (Steihaug-CG).

    The exact-curvature engine: per iteration one batched
    gradient evaluation plus `max_cg`-bounded Hessian-vector products
    (matrix-free `jax.jvp` — no (n, n) matrix, so it scales to large n
    like L-BFGS while converging locally like Newton). Negative
    curvature is handled by construction (Steihaug rides it to the
    trust boundary), which makes this the robust choice for stiff or
    locally indefinite MAP surfaces where secant methods stall.

    A rank-1 ``x0`` runs a single solve; a rank-2 (batch, n) ``x0`` runs
    the masked-lockstep fleet (shared objective, many starts — the
    HMC-chain-init pattern, same as `optimize_batched`).

    Same contracts as every engine here: convergence certificate
    max|∇obj| < ``tol``; ``fun`` is NaN unless converged (in-band
    failure); trust-radius collapse or ``TR_STALL_LIMIT`` consecutive
    rejected trials report Status.LINESEARCH_FAILURE; non-finite value
    at x0 reports Status.NONFINITE_VALUE; the iterate never leaves the
    last accepted point. f32 guidance: tol >= ~1e-3, as usual.

    ``max_cg`` defaults to min(n, 64); ``cg_tol`` scales the
    Eisenstat–Walker forcing η = min(0.5, √‖g‖) (smaller = sharper inner
    solves); ``value_and_grad_fn`` supplies an analytic gradient — HVPs
    then come from one jvp THROUGH it, so it must be jax-traceable.

    Box constraints: ``bounds=(lo, hi)`` (broadcastable to x0's shape;
    ±inf = one-sided/free; per-lane boxes carry the batch axis) runs
    projected trust-region Newton with an elementwise active set — the
    same dogbox strategy as `least_squares`: coordinates sitting on a
    face with the gradient pushing outward are masked out of the CG
    solve (all CG vectors stay supported on the free subspace), the
    trial point is clipped onto the box, and the model is scored along
    the step actually taken. The convergence certificate becomes the
    KKT projected-gradient residual; x0 is clipped in. The bounded
    certificate floor documented for `least_squares` (f64 resolves
    decreases only to free-gradient ~sqrt(eps·|f*|) when the bounded
    optimum has |f*| > 0) applies here identically.

    Preconditioning: ``precondition='jacobi'`` runs PRECONDITIONED
    Steihaug-CG with a per-iteration Hutchinson estimate of |diag(H)|
    (``precond_probes`` extra HVPs per outer iteration, counted in
    ``n_hev``; exact when H is diagonal) — the right knob for stiff /
    badly row-scaled problems, where plain CG needs ~√cond inner
    iterations and Jacobi collapses that to O(1). Passing a positive
    array (broadcastable to (n,) or the fleet's (B, n)) uses that FIXED
    diagonal instead (zero probe cost — e.g. a known Hessian diagonal
    or an L-BFGS diag estimate). The trust region then lives in the
    M-norm (equivalently: plain TR on the rescaled variables
    M^{1/2}x), so ``delta0``/``delta_max`` are in rescaled units.
    Probes are deterministic (keyed off the iteration count carried in
    TRState), so chunked resume and fleet-vs-solo parity both hold.
    """
    X0 = jnp.asarray(x0)
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {X0.shape}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    n = X0.shape[-1]
    if max_cg is None:
        max_cg = min(n, 64)
    if max_cg < 1:
        raise ValueError(f"max_cg must be >= 1, got {max_cg}")
    if not float(delta0) > 0.0:
        raise ValueError(f"delta0 must be > 0, got {delta0}")
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    precond_mode, precond_diag = _resolve_precondition(precondition, n)
    return _optimize_tr_impl(
        obj,
        X0,
        _check_bounds(bounds, X0),
        precond_diag,
        value_and_grad_fn=value_and_grad_fn,
        tol=float(tol),
        max_iterations=int(max_iterations),
        max_cg=int(max_cg),
        cg_tol=float(cg_tol),
        delta0=float(delta0),
        delta_max=float(delta_max),
        eta_accept=float(eta_accept),
        precond_mode=precond_mode,
        precond_probes=int(precond_probes),
        _squeeze=squeeze,
    )


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "value_and_grad_fn",
        "tol",
        "max_iterations",
        "max_cg",
        "cg_tol",
        "delta_max",
        "eta_accept",
        "precond_mode",
        "precond_probes",
        "_squeeze",
    ),
)
def _optimize_tr_resume_impl(
    obj,
    state,
    bounds,
    precond_diag,
    value_and_grad_fn,
    tol,
    max_iterations,
    max_cg,
    cg_tol,
    delta_max,
    eta_accept,
    precond_mode,
    precond_probes,
    _squeeze,
):
    vag_fleet, hvp_fleet = _make_fleet_fns(obj, value_and_grad_fn)
    # re-arm MAX_ITERATIONS lanes against the NEW budget (k keeps its
    # lifetime count — the same resume semantics as every other engine)
    rearm = (state.status == Status.MAX_ITERATIONS) & (
        state.k < max_iterations
    )
    state = state._replace(
        status=jnp.where(rearm, Status.RUNNING, state.status).astype(
            jnp.int32
        )
    )
    body = partial(
        _tr_body, vag_fleet, hvp_fleet, bounds, tol, max_iterations,
        max_cg, cg_tol, delta_max, eta_accept,
        precond_mode, precond_probes, precond_diag,
    )
    s = lax.while_loop(_tr_cond(max_iterations), body, state)
    return _result_from_state(s, _squeeze)


def optimize_tr_from_state(
    obj,
    state: TRState,
    *,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = TR_MAX_ITERATIONS_DEFAULT,
    max_cg: Optional[int] = None,
    cg_tol: float = 1.0,
    delta_max: float = 1e6,
    eta_accept: float = 1e-4,
    precondition: Optional[Any] = None,
    precond_probes: int = 2,
    value_and_grad_fn: Optional[Callable] = None,
) -> TRResult:
    """Resume a trust-region solve from a checkpointed `TRState`.

    ``max_iterations`` is the LIFETIME cap (state.k counts across legs);
    chunked resume reproduces the long run exactly — the carried
    (fun, g, Δ, stall) make the first resumed iteration bitwise the one
    the uninterrupted run would have taken (for ``precondition='jacobi'``
    the Hutchinson probes replay too: they are keyed off the carried
    iteration count). Solver geometry knobs (max_cg, cg_tol, bounds, AND
    precondition) must match the original call (same must-match contract
    as `least_squares_from_state`'s loss/f_scale/bounds).
    """
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    # a rank-1 (single-solve) result's state was squeezed: re-batch it
    # (the same re-batching least_squares_from_state does)
    squeeze = state.x.ndim == 1
    if squeeze:
        state = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], state)
    n = state.x.shape[-1]
    if max_cg is None:
        max_cg = min(n, 64)
    precond_mode, precond_diag = _resolve_precondition(precondition, n)
    return _optimize_tr_resume_impl(
        obj,
        state,
        _check_bounds(bounds, state.x),
        precond_diag,
        value_and_grad_fn=value_and_grad_fn,
        tol=float(tol),
        max_iterations=int(max_iterations),
        max_cg=int(max_cg),
        cg_tol=float(cg_tol),
        delta_max=float(delta_max),
        eta_accept=float(eta_accept),
        precond_mode=precond_mode,
        precond_probes=int(precond_probes),
        _squeeze=squeeze,
    )
