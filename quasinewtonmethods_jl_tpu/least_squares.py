"""Levenberg–Marquardt nonlinear least squares — batched, accelerator-first.

Family extension beyond the reference: the reference is the quasi-Newton
(secant) branch of smooth optimization (BFGS/DFP/SR1 + L-BFGS, reference
src/QuasiNewtonMethods.jl:34-69); nonlinear least squares is the sibling
branch where the objective has the special form f(x) = ½‖r(x)‖² and the
Gauss–Newton matrix JᵀJ replaces the secant Hessian — no curvature pairs,
no line search, a damped Newton step with a trust-region-style damping
control instead. It is the workhorse for curve fitting and nonlinear
regression — exactly the "fleet of small independent problems" shape this
framework's batched engines are built for.

accelerator-native design decisions:

  * **One masked-lockstep fleet engine** (the round-2 lesson: under vmap,
    nested data-dependent loops poison every lane — so, as in
    `batched_solve.py` / `lbfgs_batched_solve.py`, the fleet is a single
    `lax.while_loop` over (batch, ...) state with explicit `active`
    masks; a single solve is a batch of one).
  * **The per-iteration hot path is batched matmul work**: J via one vmapped
    jacfwd/jacrev (n or m fused AD passes), JᵀJ as a (batch, n, m)@(m, n)
    einsum, the damped normal equations via batched Cholesky + two
    triangular solves. No scalar loops, no gathers.
  * **LM needs no line search**: each iteration is jacobian → solve →
    ONE trial evaluation → accept/damp (Madsen–Nielsen gain-ratio
    control). Rejected lanes pay the same lockstep iteration but touch
    no state — masking is trivial compared to the Armijo loops.
  * **In-band failure, same contract as every engine here**: Status
    codes; `fun` is NaN unless CONVERGED; damping exhaustion
    (lam > lam_max, the LM analog of a failed line search) maps to
    Status.LINESEARCH_FAILURE; non-finite residuals/jacobians map to
    Status.NONFINITE_VALUE. The iterate never moves on a rejected or
    non-finite trial.

Convention note: this module MINIMIZES ½‖r‖² (the universal least-squares
convention), while the library's log-density engines MAXIMIZE. The two
meet where they should: a Gaussian log-likelihood is −½‖r‖² + const, so
`result.JTJ` (the Gauss–Newton curvature at the solution) is exactly the
negative-Hessian approximation the samplers want as a dense metric —
i.e. the same handoff `map_then_sample` performs from the BFGS fleet's B.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import _pin_matmul_precision
from .state import Status

__all__ = [
    "LMState",
    "LeastSquaresResult",
    "least_squares",
    "least_squares_from_state",
]

_HIGHEST = lax.Precision.HIGHEST

# LM converges quadratically near the solution and each iteration carries a
# full jacobian — a far smaller cap than the reference driver's 10_000
# outer iterations (src/QuasiNewtonMethods.jl:250) is the right default.
LM_MAX_ITERATIONS_DEFAULT = 200


class LMState(NamedTuple):
    """Levenberg–Marquardt fleet state (carry of the solve while-loop).

    Every leaf has a leading (batch,) axis; a scalar solve is batch == 1.
    The carried (g, JTJ) always hold the jacobian products at ``x`` —
    the same "evaluation lives at the iterate" invariant as the rotated
    BFGS driver loop (solve.py), which keeps the loop body free of
    per-iteration re-evaluation conds.
    """

    x: jax.Array  # (B, n) iterate
    fun: jax.Array  # (B,) ½‖r(x)‖²
    g: jax.Array  # (B, n) gradient Jᵀr at x
    JTJ: jax.Array  # (B, n, n) Gauss–Newton matrix at x
    lam: jax.Array  # (B,) Marquardt damping
    nu: jax.Array  # (B,) damping growth factor (Madsen–Nielsen)
    k: jax.Array  # (B,) int32 iterations executed
    status: jax.Array  # (B,) int32 Status
    n_fev: jax.Array  # (B,) int32 residual evaluations
    n_jev: jax.Array  # (B,) int32 jacobian evaluations
    stall: jax.Array  # (B,) int32 consecutive rejected trials


class LeastSquaresResult(NamedTuple):
    """Least-squares solve result — the library-wide in-band contract:
    ``fun`` is the minimized ½‖r‖² on convergence and NaN on ANY failure
    path; ``last_value`` is the final value regardless of status."""

    x: jax.Array
    fun: jax.Array
    grad: jax.Array  # Jᵀr at x (the gradient of ½‖r‖²)
    JTJ: jax.Array  # Gauss–Newton curvature at x (dense-mass handoff)
    status: jax.Array
    iterations: jax.Array
    n_fev: jax.Array
    n_jev: jax.Array
    lam: jax.Array  # final damping (diagnostic)
    last_value: jax.Array
    state: LMState  # resumable via least_squares_from_state

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED


def _resolve_jac_mode(jac_mode: str, n: int, m: int) -> str:
    if jac_mode == "auto":
        # jacfwd costs n JVP passes, jacrev m VJP passes — pick the smaller
        # axis (curve fitting is almost always m >= n -> forward mode).
        return "fwd" if n <= m else "rev"
    if jac_mode not in ("fwd", "rev"):
        raise ValueError(f"jac_mode must be 'auto'|'fwd'|'rev', got {jac_mode!r}")
    return jac_mode


class _Lane2:
    """Hashable (x, data) adapter over a 1-arg residual_fn — a fresh
    lambda per call would defeat the jit cache (same device as
    minimize._Negated)."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x, _d):
        return self.fn(x)

    def __hash__(self):
        return hash((_Lane2, self.fn))

    def __eq__(self, other):
        return type(other) is _Lane2 and other.fn == self.fn


def _make_jac_fleet(residual_fn: Callable, has_data: bool, jac_mode: str):
    """Batched residual+jacobian evaluator:
    ``jac_fleet(X, data) -> (B, m), (B, m, n)``. LM never needs a
    residual-only evaluation — every trial's (r, J) feed the accept path
    — so one evaluator suffices. ``data`` is a pytree whose leaves carry
    the batch axis (ignored when has_data is False)."""
    res1 = _pin_matmul_precision(residual_fn if has_data else _Lane2(residual_fn))

    jac1 = jax.jacfwd(res1, argnums=0) if jac_mode == "fwd" else jax.jacrev(
        res1, argnums=0
    )

    def resjac1(x, d):
        return res1(x, d), jac1(x, d)

    return jax.vmap(resjac1)


def _grad_and_gn(r, J):
    """g = Jᵀr and JTJ = JᵀJ, batched, at f32-accurate precision (the
    reduced-precision matmul trap applies to these contractions just
    as it does to user objectives — api._pin_matmul_precision)."""
    g = jnp.einsum("bmn,bm->bn", J, r, precision=_HIGHEST)
    JTJ = jnp.einsum("bmn,bmk->bnk", J, J, precision=_HIGHEST)
    return g, JTJ


# --- robust losses (M-estimation) -------------------------------------------
#
# The robust objective is F(x) = ½ C² Σᵢ ρ(zᵢ), zᵢ = rᵢ²/C² with C = f_scale
# (scipy.optimize.least_squares' convention, so `loss=`/`f_scale=` fixtures
# transfer verbatim). ρ grows sub-quadratically, so large residuals
# (outliers) stop dominating the fit. Everything stays batched elementwise
# elementwise work: per-residual weights, no sorting, no data-dependent shapes.

LM_LOSSES = ("linear", "huber", "soft_l1", "cauchy", "arctan")


def _rho_derivs(z, loss: str):
    """ρ(z), ρ'(z), ρ''(z) elementwise. Each is an exact closed form; the
    z >= 0 domain keeps all of them finite."""
    if loss == "huber":
        big = z > 1.0
        sq = jnp.sqrt(jnp.maximum(z, 1.0))  # guarded: used only where big
        rho = jnp.where(big, 2.0 * sq - 1.0, z)
        d1 = jnp.where(big, 1.0 / sq, jnp.ones_like(z))
        d2 = jnp.where(big, -0.5 / (sq * jnp.maximum(z, 1.0)), jnp.zeros_like(z))
        return rho, d1, d2
    if loss == "soft_l1":
        t = 1.0 + z
        sq = jnp.sqrt(t)
        return 2.0 * (sq - 1.0), 1.0 / sq, -0.5 / (t * sq)
    if loss == "cauchy":
        t = 1.0 + z
        return jnp.log1p(z), 1.0 / t, -1.0 / (t * t)
    if loss == "arctan":
        t = 1.0 + z * z
        return jnp.arctan(z), 1.0 / t, -2.0 * z / (t * t)
    raise ValueError(f"loss must be one of {LM_LOSSES}, got {loss!r}")


def _make_fun_grad_gn(loss: str, f_scale: float):
    """(r, J) -> (fun, g, JTJ) under the robust loss.

    g = Σ ρ'(zᵢ)·rᵢ·Jᵢ is the EXACT gradient of F (no clamping — the
    convergence certificate max|g| < tol stays honest). JTJ uses the
    Gauss–Newton-with-Triggs-correction weights wᵢ = ρ' + 2ρ''·zᵢ, floored
    at eps: for cauchy/arctan w goes negative at large zᵢ (the robust
    objective is locally concave in those residuals) and an indefinite
    model matrix would poison the whole fleet's Cholesky — the floor keeps
    the step a descent direction, the gain ratio does the rest.
    """
    if loss == "linear":

        def fun_grad_gn(r, J):
            fun = 0.5 * jnp.sum(r * r, axis=-1)
            g, JTJ = _grad_and_gn(r, J)
            return fun, g, JTJ

        return fun_grad_gn

    def fun_grad_gn(r, J):
        dtype = r.dtype
        C2 = jnp.asarray(f_scale * f_scale, dtype)
        z = (r * r) / C2
        rho, d1, d2 = _rho_derivs(z, loss)
        fun = 0.5 * C2 * jnp.sum(rho, axis=-1)
        g = jnp.einsum("bmn,bm->bn", J, d1 * r, precision=_HIGHEST)
        w = jnp.maximum(d1 + 2.0 * d2 * z, jnp.finfo(dtype).eps)
        JTJ = jnp.einsum("bmn,bm,bmk->bnk", J, w, J, precision=_HIGHEST)
        return fun, g, JTJ

    return fun_grad_gn


# --- box constraints ---------------------------------------------------------
#
# Projected Levenberg–Marquardt with an elementwise active set (the
# dogbox strategy, accelerator-shaped). Naive clip-LM (solve the full damped
# system, clip the step) CRAWLS when a bound is active: the Newton solve
# couples coordinates, so a free coordinate's component is computed
# assuming the blocked coordinate moves — it doesn't, the gain ratio
# sours, and the damping control stalls at O(1) lam (measured: 200
# iterations without certifying a 2-parameter fit). Instead, each
# iteration masks bound-blocked coordinates (at a face with the gradient
# pushing outward) OUT of the normal equations — zero their rows/columns
# and right-hand side, keep their Marquardt diagonal so the batched
# Cholesky stays SPD — which makes the damped solve exact on the free
# subspace (blocked coordinates get an exactly-zero step). The trial
# point is then clipped (free coordinates may legitimately hit a face
# mid-step; the gain ratio against the quadratic model along the
# ACTUALLY-TAKEN step scores that correctly, and the coordinate joins the
# active set next iteration). Everything is elementwise masking on the
# existing batched tensors: no shape changes, no per-lane control flow,
# the fleet stays one lockstep program.


def _kkt_criticality(x, g, bounds):
    """Per-lane optimality measure. Unbounded: max|g| (the library's
    gradient certificate). Bounded: the projected-gradient residual
    max|x − clip(x − g, lo, hi)| — zero exactly at KKT points of the box
    (interior ⇒ g = 0; at lo ⇒ g ≥ 0; at hi ⇒ g ≤ 0), and it reduces to
    max|g| for interior iterates with small g."""
    if bounds is None:
        return jnp.max(jnp.abs(g), axis=-1)
    lo, hi = bounds
    return jnp.max(jnp.abs(x - jnp.clip(x - g, lo, hi)), axis=-1)


def _damped_step(JTJ, g, lam, diag_floor, free=None):
    """Solve (JTJ + lam·D) δ = −g per lane via batched Cholesky.

    D = diag(JTJ) floored at ``diag_floor`` (Marquardt scaling — the step
    is invariant to per-coordinate rescaling of x, unlike lam·I). A
    non-SPD system (degenerate JTJ at lam ≈ 0) yields NaNs from the
    Cholesky, the trial evaluates non-finite, the gain ratio rejects, and
    the damping doubles — the failure heals itself in-band, no conds.

    ``free`` (bool, same shape as g; bounded path only) restricts the
    solve to the free subspace: blocked coordinates' rows/columns and
    rhs are zeroed, their diagonal keeps (1+lam)·D so the system stays
    SPD and their step is exactly zero. The masked JTJ is a congruence
    of a PSD matrix by diag(free), so positivity is preserved.
    """
    d = jnp.diagonal(JTJ, axis1=-2, axis2=-1)
    d = jnp.maximum(d, diag_floor)
    n = d.shape[-1]
    diag_add = lam[:, None] * d
    if free is not None:
        fm = free.astype(JTJ.dtype)
        JTJ = JTJ * fm[:, :, None] * fm[:, None, :]
        diag_add = diag_add + (1.0 - fm) * d
        g = g * fm
    # eye[i,j] * v[..., i] embeds v on the diagonal — no scatter, no loop
    A = JTJ + jnp.eye(n, dtype=JTJ.dtype) * diag_add[..., None]
    L = jnp.linalg.cholesky(A)
    rhs = -g[..., None]
    w = lax.linalg.triangular_solve(L, rhs, left_side=True, lower=True)
    delta = lax.linalg.triangular_solve(
        L, w, left_side=True, lower=True, transpose_a=True
    )
    dvec = d  # Marquardt scale actually applied (for the gain-ratio model)
    return delta[..., 0], dvec


def _lm_cond(max_iterations):
    def cond(s: LMState):
        return jnp.any((s.status == Status.RUNNING) & (s.k < max_iterations))

    return cond


def _lm_body(
    jac_fleet,
    fun_grad_gn,
    data,
    bounds,
    tol,
    max_iterations,
    lam_max,
    diag_floor,
    s: LMState,
) -> LMState:
    dtype = s.x.dtype
    active = s.status == Status.RUNNING

    if bounds is None:
        delta, dvec = _damped_step(s.JTJ, s.g, s.lam, diag_floor)
        x_t = s.x + delta
    else:
        lo, hi = bounds
        # blocked = at a face with the gradient pushing outward (clipping
        # lands iterates EXACTLY on the face, so == comparisons fire)
        blocked = ((s.x <= lo) & (s.g > 0)) | ((s.x >= hi) & (s.g < 0))
        delta, dvec = _damped_step(
            s.JTJ, s.g, s.lam, diag_floor, free=~blocked
        )
        x_t = jnp.clip(s.x + delta, lo, hi)
        delta = x_t - s.x  # the step actually taken
    # one jacobian evaluation per iteration, AT THE TRIAL POINT: accepted
    # lanes need (r, J) there anyway, rejected lanes mask it away — in a
    # lockstep fleet the jacobian runs every iteration regardless, so
    # evaluating at x_t (not x) costs nothing and saves the re-evaluation
    # an accept would otherwise trigger.
    r_t, J_t = jac_fleet(x_t, data)
    f_t, g_t, JTJ_t = fun_grad_gn(r_t, J_t)

    if bounds is None:
        # Madsen–Nielsen gain ratio: predicted reduction of the damped
        # model is ½ δᵀ(lam·D·δ − g) >= 0 for the exact solve.
        pred = 0.5 * jnp.sum(
            delta * (s.lam[:, None] * dvec * delta - s.g), axis=-1
        )
    else:
        # The clipped step is no longer the damped system's exact solution,
        # so evaluate the quadratic model's decrease along it directly:
        # −(gᵀδ + ½ δᵀ(JTJ)δ). (For an unclipped δ this reduces exactly to
        # the closed form above — kept separate so the unbounded path's
        # floating-point trajectory is untouched.)
        JTJd = jnp.einsum("bij,bj->bi", s.JTJ, delta, precision=_HIGHEST)
        pred = -jnp.sum(delta * (s.g + 0.5 * JTJd), axis=-1)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    rho = (s.fun - f_t) / jnp.maximum(pred, tiny)

    trial_ok = jnp.isfinite(f_t) & jnp.all(jnp.isfinite(g_t), axis=-1)
    accept = active & trial_ok & (rho > 0.0) & (pred > 0.0)

    one = jnp.ones((), dtype)
    shrink = jnp.maximum(one / 3, one - (2 * rho - 1) ** 3)
    lam_new = jnp.where(accept, s.lam * shrink, s.lam * s.nu)
    nu_new = jnp.where(accept, jnp.full_like(s.nu, 2.0), s.nu * 2.0)

    x_new = jnp.where(accept[:, None], x_t, s.x)
    fun_new = jnp.where(accept, f_t, s.fun)
    g_new = jnp.where(accept[:, None], g_t, s.g)
    JTJ_new = jnp.where(accept[:, None, None], JTJ_t, s.JTJ)
    stall_new = jnp.where(accept, 0, s.stall + 1)

    k_new = jnp.where(active, s.k + 1, s.k)
    converged = _kkt_criticality(x_new, g_new, bounds) < tol
    status_new = jnp.where(
        active,
        jnp.where(
            converged,
            Status.CONVERGED,
            jnp.where(
                lam_new > lam_max,
                Status.LINESEARCH_FAILURE,  # damping exhaustion
                jnp.where(
                    k_new >= max_iterations,
                    Status.MAX_ITERATIONS,
                    Status.RUNNING,
                ),
            ),
        ),
        s.status,
    ).astype(jnp.int32)

    return LMState(
        x=x_new,
        fun=fun_new,
        g=g_new,
        JTJ=JTJ_new,
        lam=jnp.where(active, lam_new, s.lam).astype(dtype),
        nu=jnp.where(active, nu_new, s.nu).astype(dtype),
        k=k_new,
        status=status_new,
        n_fev=jnp.where(active, s.n_fev + 1, s.n_fev),
        n_jev=jnp.where(active, s.n_jev + 1, s.n_jev),
        stall=jnp.where(active, stall_new, s.stall),
    )


def _init_lm_state(
    jac_fleet, fun_grad_gn, data, bounds, X0, tol, damping_init
) -> LMState:
    """Peeled initial evaluation: (f, g, JTJ) at x0, per-lane lam0 =
    damping_init · max(diag(JTJ)) (Madsen–Nielsen τ rule), immediate
    classification of already-converged and non-finite lanes."""
    dtype = X0.dtype
    B = X0.shape[0]
    if bounds is not None:
        X0 = jnp.clip(X0, bounds[0], bounds[1])
    r0, J0 = jac_fleet(X0, data)
    f0, g0, JTJ0 = fun_grad_gn(r0, J0)

    d0 = jnp.diagonal(JTJ0, axis1=-2, axis2=-1)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    lam0 = (damping_init * jnp.maximum(jnp.max(d0, axis=-1), eps)).astype(dtype)

    finite0 = jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0), axis=-1)
    conv0 = finite0 & (_kkt_criticality(X0, g0, bounds) < tol)
    status0 = jnp.where(
        conv0,
        Status.CONVERGED,
        jnp.where(finite0, Status.RUNNING, Status.NONFINITE_VALUE),
    ).astype(jnp.int32)

    zi = jnp.zeros((B,), jnp.int32)
    return LMState(
        x=X0,
        fun=f0,
        g=g0,
        JTJ=JTJ0,
        lam=lam0,
        nu=jnp.full((B,), 2.0, dtype),
        k=zi,
        status=status0,
        n_fev=jnp.ones((B,), jnp.int32),
        n_jev=jnp.ones((B,), jnp.int32),
        stall=zi,
    )


def _result_from_state(s: LMState, squeeze: bool) -> LeastSquaresResult:
    conv = s.status == Status.CONVERGED
    nan = jnp.asarray(jnp.nan, s.fun.dtype)
    res = LeastSquaresResult(
        x=s.x,
        fun=jnp.where(conv, s.fun, nan),
        grad=s.g,
        JTJ=s.JTJ,
        status=s.status,
        iterations=s.k,
        n_fev=s.n_fev,
        n_jev=s.n_jev,
        lam=s.lam,
        last_value=s.fun,
        state=s,
    )
    if squeeze:
        res = jax.tree_util.tree_map(lambda l: l[0], res)
    return res


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "tol",
        "max_iterations",
        "damping_init",
        "lam_max",
        "jac_mode",
        "loss",
        "f_scale",
        "_squeeze",
    ),
)
def _least_squares_impl(
    residual_fn,
    X0,
    data,
    bounds,
    *,
    tol,
    max_iterations,
    damping_init,
    lam_max,
    jac_mode,
    loss,
    f_scale,
    _squeeze,
):
    n = X0.shape[-1]
    has_data = data is not None
    # residual length from abstract evaluation (static shape requirement)
    lane_args = (
        (X0[0], jax.tree_util.tree_map(lambda l: l[0], data))
        if has_data
        else (X0[0], None)
    )
    m = jax.eval_shape(
        lambda x, d: (residual_fn(x, d) if has_data else residual_fn(x)),
        *lane_args,
    ).shape
    if len(m) != 1:
        raise ValueError(f"residual_fn must return a rank-1 array, got shape {m}")
    mode = _resolve_jac_mode(jac_mode, n, m[0])

    jac_fleet = _make_jac_fleet(residual_fn, has_data, mode)
    fun_grad_gn = _make_fun_grad_gn(loss, f_scale)
    dtype = X0.dtype
    diag_floor = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    state0 = _init_lm_state(
        jac_fleet,
        fun_grad_gn,
        data,
        bounds,
        X0,
        tol,
        jnp.asarray(damping_init, dtype),
    )
    body = partial(
        _lm_body,
        jac_fleet,
        fun_grad_gn,
        data,
        bounds,
        jnp.asarray(tol, dtype),
        max_iterations,
        jnp.asarray(lam_max, dtype),
        diag_floor,
    )
    final = lax.while_loop(_lm_cond(max_iterations), body, state0)
    return _result_from_state(final, _squeeze)


def _check_bounds(bounds, X0):
    """Validate and broadcast ``bounds=(lo, hi)`` to X0's (B, n) shape.
    Entries may be ±inf (one-sided or absent per coordinate); per-lane
    bounds come in with a leading batch axis."""
    if bounds is None:
        return None
    try:
        lo, hi = bounds
    except (TypeError, ValueError):
        raise ValueError(
            f"bounds must be a (lower, upper) pair, got {bounds!r}"
        ) from None
    lo = jnp.broadcast_to(jnp.asarray(lo, X0.dtype), X0.shape)
    hi = jnp.broadcast_to(jnp.asarray(hi, X0.dtype), X0.shape)
    import numpy as _np

    if not bool(_np.all(_np.asarray(lo < hi))):
        raise ValueError("bounds require lower < upper in every coordinate")
    return lo, hi


def least_squares(
    residual_fn: Callable,
    x0: jax.Array,
    *,
    data: Optional[Any] = None,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = LM_MAX_ITERATIONS_DEFAULT,
    damping_init: float = 1e-3,
    lam_max: float = 1e32,
    jac_mode: str = "auto",
    loss: str = "linear",
    f_scale: float = 1.0,
) -> LeastSquaresResult:
    """Minimize ½‖r(x)‖² by Levenberg–Marquardt, batched.

    ``residual_fn(x) -> (m,)`` (or ``residual_fn(x, data_lane)`` when
    ``data`` is given) must be pure and traceable; the jacobian comes from
    forward- or reverse-mode AD (``jac_mode='auto'`` picks forward when
    n <= m). A rank-1 ``x0`` runs a single solve; a rank-2 (batch, n)
    ``x0`` runs the masked-lockstep fleet engine — with ``data`` a pytree
    whose leaves carry the batch axis on front, this is the
    "fit 4096 curves in one launch" entry point (per-lane datasets, one
    compiled program, batched jacobians/Cholesky throughout).

    Convergence certificate: max|Jᵀr| < ``tol`` (the gradient of ½‖r‖² —
    the same gradient-norm contract as the reference driver,
    src/QuasiNewtonMethods.jl:257-262). Failure is in-band: ``fun`` is
    NaN unless converged; damping exhaustion (lam > ``lam_max``, ~15
    consecutive rejected trials) reports Status.LINESEARCH_FAILURE —
    the LM analog of a failed line search; non-finite residuals at x0
    report Status.NONFINITE_VALUE.

    ``result.JTJ`` is the Gauss–Newton curvature at the solution — for a
    Gaussian likelihood it is the observed-information approximation, in
    the same orientation the samplers take a dense metric (a drop-in for
    the MAP→mass handoff of `map_then_sample`).

    Robust fitting: ``loss`` in ``('linear', 'huber', 'soft_l1', 'cauchy',
    'arctan')`` minimizes ½·f_scale²·Σρ(rᵢ²/f_scale²) instead (M-estimation
    — scipy.optimize.least_squares' exact convention, so `loss=`/`f_scale=`
    choices transfer verbatim). Residuals beyond ~``f_scale`` are
    down-weighted, so outliers stop dominating the fit. The gradient (and
    the tol certificate) is exact for the robust objective; the model
    matrix uses the Triggs-corrected Gauss–Newton weights floored at eps
    (cauchy/arctan go locally concave in large residuals — the floor keeps
    the damped system SPD). All losses are elementwise per-residual
    weights: the fleet stays one lockstep batched program.

    Box constraints: ``bounds=(lo, hi)`` (each broadcastable to x0's
    shape; ±inf entries make a coordinate one-sided or free; per-lane
    bounds carry the batch axis) runs projected LM with an elementwise
    active set (the dogbox strategy): coordinates sitting on a face with
    the gradient pushing outward are masked out of the damped normal
    equations (exact free-subspace solve, zero step for blocked
    coordinates), the trial point is clipped onto the box, and the gain
    ratio scores the quadratic model along the step actually taken. The
    convergence certificate becomes the KKT projected-gradient residual
    max|x − clip(x − g, lo, hi)| < ``tol`` (equal to max|g| for interior
    solutions). x0 is clipped into the box. Everything is elementwise
    masking: the fleet program shape is unchanged.

    Certificate floor with active bounds: when the residual at a bounded
    solution is nonzero (f* > 0), accepted decreases in the free
    subspace fall below f64 resolution once the free gradient reaches
    ~sqrt(eps·f*); a ``tol`` below that floor ends in-band as damping
    exhaustion (LINESEARCH_FAILURE) with the iterate parked at the
    solution — same contract as an overtight tol anywhere else in the
    library. tol >= 1e-7 is safe for f* = O(1) at f64.

    f32 guidance: as with every engine here, tol >= ~1e-3 at f32;
    f64-on-CPU is the high-accuracy mode.
    """
    X0 = jnp.asarray(x0)
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {X0.shape}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
        if data is not None:
            data = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], data)
    if data is not None:
        data = jax.tree_util.tree_map(jnp.asarray, data)
        B = X0.shape[0]
        for leaf in jax.tree_util.tree_leaves(data):
            if leaf.ndim < 1 or leaf.shape[0] != B:
                raise ValueError(
                    "every data leaf must carry the fleet batch axis "
                    f"(expected leading {B}, got shape {leaf.shape})"
                )
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if loss not in LM_LOSSES:
        raise ValueError(f"loss must be one of {LM_LOSSES}, got {loss!r}")
    if not float(f_scale) > 0.0:
        raise ValueError(f"f_scale must be > 0, got {f_scale}")
    return _least_squares_impl(
        residual_fn,
        X0,
        data,
        _check_bounds(bounds, X0),
        tol=float(tol),
        max_iterations=int(max_iterations),
        damping_init=float(damping_init),
        lam_max=float(lam_max),
        jac_mode=jac_mode,
        loss=loss,
        f_scale=float(f_scale),
        _squeeze=squeeze,
    )


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "tol",
        "max_iterations",
        "lam_max",
        "jac_mode",
        "loss",
        "f_scale",
        "_squeeze",
    ),
)
def _least_squares_resume_impl(
    residual_fn,
    state,
    data,
    bounds,
    *,
    tol,
    max_iterations,
    lam_max,
    jac_mode,
    loss,
    f_scale,
    _squeeze,
):
    n = state.x.shape[-1]
    has_data = data is not None
    lane_args = (
        (state.x[0], jax.tree_util.tree_map(lambda l: l[0], data))
        if has_data
        else (state.x[0], None)
    )
    m = jax.eval_shape(
        lambda x, d: (residual_fn(x, d) if has_data else residual_fn(x)),
        *lane_args,
    ).shape[0]
    mode = _resolve_jac_mode(jac_mode, n, m)
    jac_fleet = _make_jac_fleet(residual_fn, has_data, mode)
    fun_grad_gn = _make_fun_grad_gn(loss, f_scale)
    dtype = state.x.dtype
    # lanes parked at MAX_ITERATIONS resume running under the new budget
    # (k keeps counting from where it stopped — the same resume semantics
    # as optimize_from_state)
    status = jnp.where(
        (state.status == Status.MAX_ITERATIONS)
        & (state.k < max_iterations),
        Status.RUNNING,
        state.status,
    ).astype(jnp.int32)
    state = state._replace(status=status)
    body = partial(
        _lm_body,
        jac_fleet,
        fun_grad_gn,
        data,
        bounds,
        jnp.asarray(tol, dtype),
        max_iterations,
        jnp.asarray(lam_max, dtype),
        jnp.asarray(jnp.finfo(dtype).eps, dtype),
    )
    final = lax.while_loop(_lm_cond(max_iterations), body, state)
    return _result_from_state(final, _squeeze)


def least_squares_from_state(
    residual_fn: Callable,
    state: LMState,
    *,
    data: Optional[Any] = None,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = LM_MAX_ITERATIONS_DEFAULT,
    lam_max: float = 1e32,
    jac_mode: str = "auto",
    loss: str = "linear",
    f_scale: float = 1.0,
) -> LeastSquaresResult:
    """Resume a least-squares solve from a saved `LMState` (chunked runs
    reproduce one long run exactly — the carried (g, JTJ, lam, nu) are the
    full algorithm memory). Lanes that stopped at MAX_ITERATIONS continue
    under the new budget; converged/failed lanes stay frozen.

    ``loss``/``f_scale`` must match the original run (the carried
    (fun, g, JTJ) are quantities OF that robust objective — resuming under
    a different loss silently mixes two objectives). The same must-match
    contract applies to ``bounds``: the carried (g, JTJ, lam) describe the
    projected trajectory, and the KKT certificate is evaluated against the
    box you pass here."""
    squeeze = state.x.ndim == 1
    if squeeze:
        state = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], state)
    if data is not None:
        data = jax.tree_util.tree_map(jnp.asarray, data)
        if squeeze:
            data = jax.tree_util.tree_map(lambda l: l[None], data)
    if loss not in LM_LOSSES:
        raise ValueError(f"loss must be one of {LM_LOSSES}, got {loss!r}")
    if not float(f_scale) > 0.0:
        raise ValueError(f"f_scale must be > 0, got {f_scale}")
    return _least_squares_resume_impl(
        residual_fn,
        state,
        data,
        _check_bounds(bounds, state.x),
        tol=float(tol),
        max_iterations=int(max_iterations),
        lam_max=float(lam_max),
        jac_mode=jac_mode,
        loss=loss,
        f_scale=float(f_scale),
        _squeeze=squeeze,
    )
