"""Bridge sampling: model evidence from the posterior draws you already have.

The evidence ladder so far (SURVEY.md §5 — the reference's MAP workflow
feeds HMC; evidence is what the combined pipeline can certify):
`laplace_evidence` is free but structurally biased off-Gaussian;
`ais_evidence` is asymptotically exact but needs a dedicated annealing
run (T rungs × one fleet HMC move each). Bridge sampling (Meng & Wong
1996; the estimator behind the `bridgesampling` R package, Gronau et
al. 2017) fills the gap between them: given N1 POSTERIOR draws — which
`map_then_sample` has already produced — and N2 draws from a normalized
proposal q2 (the Laplace Gaussian at the MAP, also already in hand),
the optimal-bridge identity

    Z = E_q2[ p̃ h ] / E_p[ q2 h ],   h ∝ 1 / (s1 p̃ + s2 Z q2)

yields a fixed-point iteration for Ẑ whose asymptotic variance is
minimal over all bridge functions h. Cost beyond the draws themselves:
N1 + N2 logdensity evaluations and ~30 elementwise/logsumexp sweeps —
no gradients, no extra HMC. It sees every basin the CHAINS visited
(pair with `pt_sample` for multimodal targets: replica exchange supplies
mode-covering draws, the bridge turns them into evidence), unlike
Laplace which integrates one basin by construction.

Accelerator shape: the fixed point runs entirely on device as a
`lax.while_loop` over two logsumexp reductions of precomputed (N,) log
ratios — one fused elementwise+reduce program per iteration, nothing
re-evaluates the model. All arithmetic is in log space (the iteration
is the `bridgesampling` package's numerically stable form).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .ais import _base_from
from .api import as_logdensity

__all__ = ["BridgeResult", "bridge_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)


class BridgeResult(NamedTuple):
    """logZ: the bridge-sampling evidence estimate (log marginal
    likelihood).
    n_iter: fixed-point iterations used (== max_iter means the tolerance
    was not reached — inspect delta).
    delta: |last update| of log Ẑ (convergence certificate).
    re2: approximate relative mean-squared error of Ẑ (Frühwirth-
    Schnatter 2004 / Gronau et al. 2017, eq. 4.1) treating the draws as
    independent — an honest lower bound under autocorrelation; scale the
    posterior term by n_draws/ESS from `diagnose_chains` for a corrected
    value. sqrt(re2) ≈ the coefficient of variation of Ẑ.
    """

    logZ: jax.Array
    n_iter: jax.Array
    delta: jax.Array
    re2: jax.Array


def _gauss_logpdf_and_draw(mu, cov, n2, key, dtype):
    """Normalized proposal-Gaussian logpdf fn + (N2, n) draws, dense or
    diagonal covariance (same base forms the AIS/Laplace legs accept)."""
    n = mu.shape[0]
    if cov.ndim == 1:
        sd = jnp.sqrt(cov)
        logdet = jnp.sum(jnp.log(cov))

        def logq2(x):
            d = (x - mu[None, :]) / sd[None, :]
            return -0.5 * jnp.sum(d * d, axis=1) - 0.5 * (
                logdet + n * _LOG_2PI
            )

        draws = mu[None, :] + sd[None, :] * jax.random.normal(
            key, (n2, n), dtype
        )
    else:
        chol = jnp.linalg.cholesky(cov)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))

        def logq2(x):
            d = jax.scipy.linalg.solve_triangular(
                chol, (x - mu[None, :]).T, lower=True
            )
            return -0.5 * jnp.sum(d * d, axis=0) - 0.5 * (
                logdet + n * _LOG_2PI
            )

        draws = mu[None, :] + jax.random.normal(key, (n2, n), dtype) @ chol.T
    return logq2, draws


@partial(jax.jit, static_argnames=("obj", "max_iter", "n_proposal"))
def _bridge_core(obj, x1, mu, cov, key, max_iter, tol, n_proposal):
    ld = jax.vmap(as_logdensity(obj))
    dtype = x1.dtype
    n1 = x1.shape[0]

    logq2_fn, x2 = _gauss_logpdf_and_draw(mu, cov, n_proposal, key, dtype)
    n2 = x2.shape[0]

    # log ratios l = log p̃(x) − log q2(x); a draw where the target is
    # -inf (outside support) contributes zero mass in-band, never NaN
    l1 = ld(x1) - logq2_fn(x1)  # posterior draws
    l2 = ld(x2) - logq2_fn(x2)  # proposal draws
    l1 = jnp.where(jnp.isnan(l1), -jnp.inf, l1)
    l2 = jnp.where(jnp.isnan(l2), -jnp.inf, l2)

    ls1 = jnp.log(jnp.asarray(n1 / (n1 + n2), dtype))
    ls2 = jnp.log(jnp.asarray(n2 / (n1 + n2), dtype))
    log_n1 = jnp.log(jnp.asarray(n1, dtype))
    log_n2 = jnp.log(jnp.asarray(n2, dtype))
    lse = jax.scipy.special.logsumexp

    def step(r):
        # numerator: (1/N2) Σ_j p̃/(s1 p̃ + s2 Ẑ q2) at proposal draws
        num = lse(l2 - jnp.logaddexp(ls1 + l2, ls2 + r)) - log_n2
        # denominator: (1/N1) Σ_i q2/(s1 p̃ + s2 Ẑ q2) at posterior draws
        den = lse(-jnp.logaddexp(ls1 + l1, ls2 + r)) - log_n1
        return num - den

    # init: simple importance sampling from the proposal (the r0 the
    # bridgesampling package uses); the fixed point is a contraction
    r0 = lse(l2) - log_n2

    def cond(c):
        r, r_prev, it = c
        return (jnp.abs(r - r_prev) > tol) & (it < max_iter)

    def body(c):
        r, _, it = c
        return step(r), r, it + 1

    r, r_prev, n_iter = lax.while_loop(
        cond, body, (step(r0), r0, jnp.ones((), jnp.int32))
    )

    # relative MSE (iid draws): RE² = Var_q2[f1]/(N2 E[f1]²)
    #                               + Var_p[f2]/(N1 E[f2]²)
    # with f1 = p̃/(s1 p̃ + s2 Ẑ q2) on proposal draws and
    #      f2 = q2/(s1 p̃ + s2 Ẑ q2) on posterior draws — computed from
    # shifted exponentials of the same log quantities the iteration used
    def rel_var(logf, n_draws):
        m = jnp.max(logf)
        f = jnp.exp(logf - m)  # scale cancels in Var/E²
        mean = jnp.mean(f)
        var = jnp.mean((f - mean) ** 2) * n_draws / jnp.maximum(
            n_draws - 1.0, 1.0
        )
        return var / (mean * mean * n_draws)

    logf1 = l2 - jnp.logaddexp(ls1 + l2, ls2 + r)
    logf2 = -jnp.logaddexp(ls1 + l1, ls2 + r)
    re2 = rel_var(logf1, float(n2)) + rel_var(logf2, float(n1))

    return BridgeResult(
        logZ=r, n_iter=n_iter, delta=jnp.abs(r - r_prev), re2=re2
    )


def bridge_evidence(
    obj,
    key: jax.Array,
    draws,
    base,
    n_proposal: Optional[int] = None,
    max_iter: int = 200,
    tol: float = 1e-10,
) -> BridgeResult:
    """Bridge-sampling log evidence from posterior draws + a Gaussian
    proposal.

    ``draws``: posterior samples — (N, n), or (n_samples, chains, n) as
    every sampler here returns them (flattened internally). They must
    actually target ``obj`` (for `map_then_sample(transform=)` pass the
    Z-SPACE draws ``result.samples`` with the z-space objective; the
    z evidence IS the constrained model's evidence).

    ``base``: the proposal Gaussian — a BFGS solve result (scalar or
    fleet; mode and curvature become N(x*, B)) or an explicit
    ``(mu, cov)`` with cov dense (n, n) or diagonal (n,).
    ``n_proposal`` samples are drawn from it (default: as many as there
    are posterior draws). The proposal must OVERLAP the posterior mass
    the draws occupy; `result.re2` blowing up (or n_iter == max_iter)
    is the in-band symptom of a too-narrow proposal.

    Cost: N + N logdensity evaluations, no gradients — the cheapest
    asymptotically consistent estimator once a sampling run exists.
    Multimodal note: the estimate integrates exactly the mass the CHAINS
    found; draws from `pt_sample` (replica exchange) make it exact-in-
    expectation across basins, where `laplace_evidence` is structurally
    one-basin.
    """
    x1 = jnp.asarray(draws)
    if x1.ndim == 3:
        x1 = x1.reshape(-1, x1.shape[-1])
    if x1.ndim != 2:
        raise ValueError(
            f"draws must be (N, n) or (n_samples, chains, n), got "
            f"{x1.shape}"
        )
    if max_iter < 1:
        raise ValueError("max_iter must be >= 1")
    if n_proposal is None:
        n_proposal = x1.shape[0]
    if n_proposal < 2:
        raise ValueError("n_proposal must be >= 2")
    dtype = x1.dtype
    mu, cov = _base_from(base, dtype)
    if mu.ndim != 1 or mu.shape[0] != x1.shape[1]:
        raise ValueError(
            f"base mean shape {mu.shape} does not match draw dimension "
            f"{x1.shape[1]}"
        )
    if cov.ndim not in (1, 2):
        raise ValueError("base cov must be (n, n) dense or (n,) diagonal")
    return _bridge_core(
        obj, x1, mu, cov, key, max_iter, jnp.asarray(tol, dtype),
        int(n_proposal),
    )
