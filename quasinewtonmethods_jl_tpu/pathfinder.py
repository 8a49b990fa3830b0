"""Multi-path Pathfinder: L-BFGS-trajectory variational inference.

The modern MAP→posterior bridge (Zhang, Carpenter, Gelman, Vehtari 2022,
JMLR 23(306) — the algorithm Stan ships as its default initializer): run
L-BFGS toward the mode, and at EVERY iterate build the local Gaussian
approximation implied by the quadratic model there,

    q_j = N( x_j + H_j g_j,  H_j ),

with H_j the L-BFGS inverse-Hessian estimate. Monte-Carlo-estimate the
ELBO of each q_j, keep the best one per path, pool draws from K
independent paths, and Pareto-smoothed-importance-resample the pool into
posterior draws. Compared to MAP+Laplace this handles non-normal targets
(the selected iterate is usually PRE-convergence, where the local Gaussian
covers mass instead of hugging the mode); compared to full HMC warmup it
costs one L-BFGS run.

This fills the reference ecosystem's chain-initialization role
(reference README.md:14 — QuasiNewtonMethods.jl exists to initialize
InplaceDHMC chains) with draws + a covariance metric rather than a point.

accelerator-native design decisions (not in the paper, which is sequential CPU):

* **Running-argmax scan, O(m·n) memory.** The trajectory is a
  `lax.scan` over a static iteration budget; each step evaluates its
  candidate Gaussian (closed-form spectral factorization from
  `ops.lbfgs_compact.lbfgs_lowrank_inv_hessian` — H = γ(I−QQᵀ) +
  Q diag(σ)Qᵀ, so sampling, logdet, and log-density need no Cholesky and
  no n×n matrix), estimates its ELBO with `elbo_draws` fresh normals, and
  folds a better candidate into the carry. Nothing per-iterate is stored
  — no (L, n) trajectory arrays, no ring snapshots.
* **Whole paths vmap.** K paths are a leading batch axis over the scan
  (independent keys/starts), so the fleet shares one compiled program;
  the ELBO objective evaluations batch over (paths × draws).
* **Mixture importance weights.** Pooled draws are weighted against the
  uniform mixture of the K selected Gaussians (logsumexp over per-path
  log-densities) — overlapping paths don't double-count mass — then
  Pareto-smoothed (Vehtari et al. 2024 PSIS; on-device Zhang–Stephens
  GPD fit) and resampled.

The selected metric is also exposed in the samplers' `LowRankMass` form —
`result.mass(path)` — so `pathfinder → chees/nuts` hands off both the
starting draws AND a correlation-aware preconditioner.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .ops.lbfgs import lbfgs_push
from .ops.lbfgs_compact import lbfgs_direction_compact, lbfgs_lowrank_inv_hessian
from .ops.linesearch import BackTracking, run_linesearch
from .state import Status

__all__ = ["PathfinderResult", "pathfinder", "psis_smooth", "gpd_fit_khat"]


# ---------------------------------------------------------------------------
# closed-form Gaussian ops in the spectral low-rank basis
#   H = gamma * (I - Q Q^T) + Q diag(sig) Q^T,  Q (n, r) orthonormal


def _apply_sqrt_H(gamma, Q, sig, xi):
    """H^(1/2) xi for xi (..., n) — exact symmetric square root."""
    xiQ = xi @ Q  # (..., r)
    return jnp.sqrt(gamma) * (xi - xiQ @ Q.T) + (jnp.sqrt(sig) * xiQ) @ Q.T

def _apply_H(gamma, Q, sig, v):
    vQ = v @ Q
    return gamma * (v - vQ @ Q.T) + (sig * vQ) @ Q.T


def _logdet_H(gamma, sig, n):
    r = sig.shape[0]
    return (n - r) * jnp.log(gamma) + jnp.sum(jnp.log(sig))


def _log_q(gamma, Q, sig, logdet, mu, z):
    """log N(z | mu, H) for z (..., n) in the spectral form."""
    n = mu.shape[-1]
    d = z - mu
    dQ = d @ Q  # (..., r)
    quad = (jnp.sum(d * d, -1) - jnp.sum(dQ * dQ, -1)) / gamma + jnp.sum(
        dQ * dQ / sig, -1
    )
    c = jnp.asarray(n * math.log(2.0 * math.pi), z.dtype)
    return -0.5 * (c + logdet + quad)


# ---------------------------------------------------------------------------
# single-path scan


class _Best(NamedTuple):
    elbo: jax.Array  # ()
    iter: jax.Array  # () int32 — trajectory index of the winner
    mu: jax.Array  # (n,)
    gamma: jax.Array  # ()
    Q: jax.Array  # (n, 2m)
    sig: jax.Array  # (2m,)
    logdet: jax.Array  # ()


def _single_path(
    vag: Callable,
    f: Callable,
    x0: jax.Array,  # (n,)
    key: jax.Array,
    history: int,
    max_iters: int,
    elbo_draws: int,
    ls: BackTracking,
    tol,
):
    """Run one Pathfinder path; returns (_Best, diagnostics dict)."""
    n = x0.shape[0]
    dtype = x0.dtype
    tol = jnp.asarray(tol, dtype)
    z = jnp.zeros((n,), dtype)
    r = min(2 * history, n)  # lowrank factorization rank (reduced QR)

    best0 = _Best(
        elbo=jnp.asarray(-jnp.inf, dtype),
        iter=jnp.int32(-1),
        mu=z,
        gamma=jnp.ones((), dtype),
        Q=jnp.zeros((n, r), dtype),
        sig=jnp.ones((r,), dtype),
        logdet=jnp.zeros((), dtype),
    )
    carry0 = dict(
        x=x0,
        grad_old=z,
        step=z,
        fun=jnp.asarray(jnp.nan, dtype),
        S=jnp.zeros((history, n), dtype),
        Y=jnp.zeros((history, n), dtype),
        rho=jnp.zeros((history,), dtype),
        hist=jnp.int32(0),
        gamma=jnp.ones((), dtype),
        active=jnp.asarray(True),
        key=key,
        best=best0,
        n_fev=jnp.int32(0),
        n_gev=jnp.int32(0),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
    )

    def body(c, _):
        k_draw, k_next = jax.random.split(c["key"])
        f0, g = vag(c["x"])
        was_active = c["active"]
        nonfinite = ~jnp.isfinite(f0)

        # curvature pair from the previous accepted step
        y_pair = c["grad_old"] - g
        S, Y, rho, hist, gamma = lbfgs_push(
            c["S"], c["Y"], c["rho"], c["hist"], c["gamma"], c["step"], y_pair
        )

        # --- candidate Gaussian at this iterate (the pathfinder core) ---
        gam_h, Q, sig = lbfgs_lowrank_inv_hessian(S, Y, hist, gamma)
        logdet = _logdet_H(gam_h, sig, n)
        mu = c["x"] + _apply_H(gam_h, Q, sig, g)  # quadratic-model mean
        xi = jax.random.normal(k_draw, (elbo_draws, n), dtype)
        zs = mu + _apply_sqrt_H(gam_h, Q, sig, xi)
        # with z = mu + H^(1/2) xi the quadratic form is exactly |xi|^2
        logq = -0.5 * (
            jnp.asarray(n * math.log(2.0 * math.pi), dtype)
            + logdet
            + jnp.sum(xi * xi, -1)
        )
        logp = jax.vmap(f)(zs)
        elbo = jnp.mean(logp - logq)
        # one effective score: -inf unless this step was a live, finite
        # candidate — the same value feeds the running argmax AND the
        # emitted trace, so the post-scan argmax recovers the winner's
        # trajectory index exactly.
        elbo_eff = jnp.where(
            was_active & ~nonfinite & jnp.isfinite(elbo), elbo, -jnp.inf
        )
        consider = elbo_eff > c["best"].elbo
        tree_sel = lambda a, b: jnp.where(consider, a, b)
        best = _Best(
            elbo=tree_sel(elbo_eff, c["best"].elbo),
            iter=c["best"].iter,  # recovered from the trace after the scan
            mu=tree_sel(mu, c["best"].mu),
            gamma=tree_sel(gam_h, c["best"].gamma),
            Q=jnp.where(consider, Q, c["best"].Q),
            sig=tree_sel(sig, c["best"].sig),
            logdet=tree_sel(logdet, c["best"].logdet),
        )

        # --- L-BFGS advance (masked when inactive/finished) ---
        converged = jnp.max(jnp.abs(g)) < tol
        d, m = lbfgs_direction_compact(S, Y, rho, hist, gamma, g)
        reset = m <= 0.0
        d = jnp.where(reset, g, d)
        m = jnp.where(reset, jnp.dot(g, g), m)
        hist = jnp.where(reset, jnp.zeros_like(hist), hist)
        gamma = jnp.where(reset, jnp.ones_like(gamma), gamma)

        alpha, ls_failed, ls_fev, ls_gev = run_linesearch(
            ls, f, vag, c["x"], d, f0, m
        )
        advance = was_active & ~nonfinite & ~converged
        step = jnp.where(advance & ~ls_failed, alpha * d, jnp.zeros_like(d))
        still = advance & ~ls_failed

        status = jnp.where(
            nonfinite & was_active,
            jnp.int32(Status.NONFINITE_VALUE),
            jnp.where(
                converged & was_active,
                jnp.int32(Status.CONVERGED),
                jnp.where(
                    ls_failed & advance,
                    jnp.int32(Status.LINESEARCH_FAILURE),
                    c["status"],
                ),
            ),
        )
        c_new = dict(
            x=c["x"] + step,
            grad_old=g,
            step=step,
            fun=f0,
            S=S,
            Y=Y,
            rho=rho,
            hist=hist,
            gamma=gamma,
            active=still,
            key=k_next,
            best=best,
            n_fev=c["n_fev"] + jnp.where(was_active, 1 + ls_fev + elbo_draws, 0),
            n_gev=c["n_gev"] + jnp.where(was_active, 1 + ls_gev, 0),
            status=status,
        )
        return c_new, dict(elbo=elbo_eff, active=was_active)

    carry, trace = lax.scan(body, carry0, None, length=max_iters)
    # recover the winning trajectory index from the (effective) elbo trace
    best = carry["best"]._replace(
        iter=jnp.where(
            jnp.isfinite(carry["best"].elbo),
            jnp.argmax(trace["elbo"]).astype(jnp.int32),
            jnp.int32(-1),
        )
    )
    diag = dict(
        elbo_trace=trace["elbo"],
        iterations=jnp.sum(trace["active"].astype(jnp.int32)),
        status=jnp.where(
            carry["status"] == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            carry["status"],
        ),
        n_fev=carry["n_fev"],
        n_gev=carry["n_gev"],
    )
    return best, diag


# ---------------------------------------------------------------------------
# Pareto-smoothed importance sampling (Vehtari, Simpson, Gelman, Yao,
# Gabry 2024), on-device: static shapes, no python branches on data.


def gpd_fit_khat(x_sorted: jax.Array) -> tuple:
    """Zhang–Stephens (2009) profile-likelihood fit of a generalized Pareto
    to (ascending-sorted, nonnegative) exceedances. Returns (khat, sigma).
    Includes the weak prior regularization arviz/loo apply
    (khat <- (M*khat + 5*0.5) / (M + 10))."""
    x = x_sorted
    M = x.shape[0]
    dtype = x.dtype
    m_grid = 30 + int(math.floor(math.sqrt(M)))
    jj = jnp.arange(1, m_grid + 1, dtype=dtype)
    x_star = x[max(int(M / 4.0 + 0.5) - 1, 0)]
    x_max = x[-1]
    b = 1.0 / x_max + (1.0 - jnp.sqrt(m_grid / (jj - 0.5))) / (3.0 * x_star)
    # Zhang–Stephens internal shape k_zs(b) = -mean log(1 - b x);
    # b < 1/x_max by construction. NOTE the sign convention: their k is
    # the NEGATIVE of the Coles/Vehtari xi used by the PSIS quantiles.
    k_b = -jnp.mean(jnp.log1p(-b[:, None] * x[None, :]), axis=1)
    l_b = M * (jnp.log(b / k_b) + k_b - 1.0)
    w = jax.nn.softmax(l_b)
    b_hat = jnp.sum(w * b)
    k_zs = -jnp.mean(jnp.log1p(-b_hat * x))
    khat = -k_zs  # Coles shape xi
    sigma = k_zs / b_hat
    khat_reg = (M * khat + 10.0 * 0.5) / (M + 10.0)
    return khat_reg, sigma


def psis_smooth(logw: jax.Array) -> tuple:
    """Pareto-smooth a vector of log importance weights.

    Fits a GPD to the largest ``M = ceil(min(0.2 S, 3 sqrt(S)))`` weights
    (on the raw-ratio scale, threshold = the (S-M)-th order statistic),
    replaces them with the fitted quantiles, truncates at the raw maximum,
    and returns ``(smoothed_logw, khat)``. khat > 0.7 means the proposal
    is unreliable (Vehtari et al. 2024 threshold). Static-shape, jit-safe.
    """
    S = logw.shape[0]
    M = int(math.ceil(min(0.2 * S, 3.0 * math.sqrt(S))))
    M = max(min(M, S - 1), 5) if S > 6 else max(S // 2, 1)
    dtype = logw.dtype

    order = jnp.argsort(logw)
    logw_sorted = logw[order]
    log_cut = logw_sorted[S - M - 1]  # threshold (stays unsmoothed)
    log_max = logw_sorted[-1]
    tail = logw_sorted[S - M :]
    # exceedances on the ratio scale, shifted by cut for stability
    exc = jnp.expm1(tail - log_cut) * jnp.exp(log_cut - log_max)
    # guard: degenerate tails skip smoothing entirely. The fit divides by
    # the first-quartile exceedance and the maximum, so ties at the cut
    # (near-uniform weights — the BEST case for IS) or nonfinite values
    # must bypass the GPD machinery; khat = -inf signals "no tail".
    x_star_idx = max(int(M / 4.0 + 0.5) - 1, 0)
    finite = jnp.isfinite(exc).all() & (exc[-1] > 0) & (exc[x_star_idx] > 0)
    exc_safe = jnp.where(finite, exc, jnp.linspace(0.1, 1.0, M).astype(dtype))
    khat, sigma = gpd_fit_khat(exc_safe)
    p = (jnp.arange(1, M + 1, dtype=dtype) - 0.5) / M
    # GPD inverse CDF over the threshold; k -> 0 limit is exponential
    q = jnp.where(
        jnp.abs(khat) < 1e-6,
        -sigma * jnp.log1p(-p),
        sigma / khat * (jnp.power(1.0 - p, -khat) - 1.0),
    )
    smoothed_tail = log_max + jnp.log(q + jnp.exp(log_cut - log_max))
    smoothed_tail = jnp.minimum(smoothed_tail, log_max)  # truncate at max
    smoothed_tail = jnp.where(finite, smoothed_tail, tail)
    out = logw_sorted.at[S - M :].set(smoothed_tail)
    # scatter back to original positions
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(S))
    return out[inv], jnp.where(finite, khat, jnp.asarray(-jnp.inf, dtype))


# ---------------------------------------------------------------------------
# the public API


class PathfinderResult(NamedTuple):
    """Draws + per-path variational diagnostics.

    ``draws`` are the PSIS-resampled posterior draws (n_draws, n);
    ``khat`` the Pareto diagnostic of the pooled importance weights
    (> 0.7 = unreliable proposal — fall back to sampler warmup);
    ``elbo``/``best_iter``/``status``/``iterations`` are per-path (K,);
    ``mu``/``gamma``/``Q``/``sig`` the selected Gaussians (leading K axis);
    ``pool``/``pool_logw`` the pre-resampling proposal pool;
    ``logp_draws`` the target log-density at ``draws``.
    """

    draws: jax.Array
    khat: jax.Array
    elbo: jax.Array
    best_iter: jax.Array
    status: jax.Array
    iterations: jax.Array
    mu: jax.Array
    gamma: jax.Array
    Q: jax.Array
    sig: jax.Array
    pool: jax.Array
    pool_logw: jax.Array
    logp_draws: jax.Array
    n_fev: jax.Array
    n_gev: jax.Array

    def mass(self, path: Optional[int] = None):
        """The selected inverse-Hessian as a sampler metric (`LowRankMass`)
        — the covariance handoff for chees/nuts. ``path=None`` picks the
        highest-ELBO path."""
        from .sampling import LowRankMass

        i = int(jnp.argmax(self.elbo)) if path is None else int(path)
        return LowRankMass(
            gamma=self.gamma[i], Q=self.Q[i], sig=self.sig[i]
        )


@partial(
    jax.jit,
    static_argnames=(
        "obj",
        "n_paths",
        "n_draws",
        "draws_per_path",
        "history",
        "max_iters",
        "elbo_draws",
        "ls",
        "value_and_grad_fn",
    ),
)
def _pathfinder_jit(
    obj,
    key,
    x0,
    n_paths,
    n_draws,
    draws_per_path,
    history,
    max_iters,
    elbo_draws,
    ls,
    tol,
    init_scale,
    value_and_grad_fn,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    n = x0.shape[-1]
    dtype = x0.dtype

    k_init, k_path, k_pool, k_res = jax.random.split(key, 4)
    if x0.ndim == 1:
        x0s = x0[None, :] + init_scale * jax.random.normal(
            k_init, (n_paths, n), dtype
        )
    else:
        x0s = x0
    path_keys = jax.random.split(k_path, x0s.shape[0])

    run = lambda x, k: _single_path(
        vag, f, x, k, history, max_iters, elbo_draws, ls, tol
    )
    best, diag = jax.vmap(run)(x0s, path_keys)
    K = x0s.shape[0]

    valid = jnp.isfinite(best.elbo)  # paths whose every iterate failed drop out

    # --- proposal pool: draws_per_path from each selected Gaussian ---
    R = draws_per_path
    xi = jax.random.normal(k_pool, (K, R, n), dtype)
    zs = best.mu[:, None, :] + jax.vmap(_apply_sqrt_H)(
        best.gamma, best.Q, best.sig, xi
    )
    pool = zs.reshape(K * R, n)

    # mixture log q over the VALID paths (uniform mixture)
    logq_all = jax.vmap(
        lambda g, Q, s, ld, mu: _log_q(g, Q, s, ld, mu, pool)
    )(best.gamma, best.Q, best.sig, best.logdet, best.mu)  # (K, K*R)
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    logq_all = jnp.where(valid[:, None], logq_all, neg_inf)
    n_valid = jnp.maximum(jnp.sum(valid.astype(dtype)), 1.0)
    logq_mix = jax.nn.logsumexp(logq_all, axis=0) - jnp.log(n_valid)

    logp_pool = jax.vmap(f)(pool)
    logw = logp_pool - logq_mix
    # draws from invalid paths are excluded outright
    path_of = jnp.repeat(jnp.arange(K), R)
    logw = jnp.where(valid[path_of] & jnp.isfinite(logw), logw, neg_inf)

    logw_smooth, khat = psis_smooth(logw)
    idx = jax.random.categorical(k_res, logw_smooth, shape=(n_draws,))
    draws = pool[idx]

    return PathfinderResult(
        draws=draws,
        khat=khat,
        elbo=best.elbo,
        best_iter=best.iter,
        status=diag["status"],
        iterations=diag["iterations"],
        mu=best.mu,
        gamma=best.gamma,
        Q=best.Q,
        sig=best.sig,
        pool=pool,
        pool_logw=logw_smooth,
        logp_draws=logp_pool[idx],
        n_fev=diag["n_fev"],
        n_gev=diag["n_gev"],
    )


def pathfinder(
    obj,
    key: jax.Array,
    x0: jax.Array,
    n_paths: int = 8,
    n_draws: int = 1000,
    draws_per_path: Optional[int] = None,
    history: int = 8,
    max_iters: int = 64,
    elbo_draws: int = 16,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-5,
    init_scale: float = 2.0,
    value_and_grad_fn: Optional[Callable] = None,
) -> PathfinderResult:
    """Multi-path Pathfinder variational inference (see module docstring).

    ``obj`` is any objective this package accepts (maximization
    convention — a log-density). ``x0`` is either an (n,) center (each
    path starts at ``x0 + init_scale * normal``) or explicit (K, n)
    starts (overrides ``n_paths``). Returns PSIS-resampled ``draws``
    plus per-path ELBOs, the Pareto ``khat`` reliability diagnostic, and
    the selected low-rank Gaussians (``.mass()`` converts the best one
    into the samplers' `LowRankMass` metric for a chees/nuts handoff).

    Wall cost ≈ one L-BFGS fleet of ``n_paths`` lanes with
    ``elbo_draws`` extra objective evaluations per iteration, all
    batched; memory is O(paths · n · history) — nothing per-iterate is
    retained.
    """
    x0 = jnp.asarray(x0)
    if not jnp.issubdtype(x0.dtype, jnp.floating):
        x0 = x0.astype(jnp.result_type(float))
    if x0.ndim == 2:
        n_paths = x0.shape[0]
    elif x0.ndim != 1:
        raise ValueError(f"x0 must be rank-1 or rank-2, got shape {x0.shape}")
    if draws_per_path is None:
        draws_per_path = max(1, (4 * n_draws) // max(n_paths, 1))
    return _pathfinder_jit(
        obj,
        key,
        x0,
        n_paths,
        n_draws,
        draws_per_path,
        history,
        max_iters,
        elbo_draws,
        ls,
        tol,
        init_scale,
        value_and_grad_fn,
    )
