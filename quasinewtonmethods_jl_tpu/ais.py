"""Annealed importance sampling + adaptive tempered SMC: model evidence.

`laplace_evidence` is the curvature-based Gaussian approximation at the
mode (the third leg of the reference's MAP workflow — SURVEY.md §5); it
is exact for Gaussian posteriors and silently biased everywhere else
(skew, heavy tails, and catastrophically so for multimodal posteriors,
where it integrates ONE basin). AIS (Neal 2001) repairs this with a
fleet-native estimator: anneal N particles from the Laplace Gaussian
q0 = N(x*, B) to the posterior p along

    pi_t(x) ∝ q0(x)^(1-b_t) · p(x)^(b_t),   0 = b_0 < ... < b_T = 1,

accumulating log-importance weights  Δlog w = (b_{t+1} − b_t)·(log p −
log q0)  and applying one tempered-target HMC move per rung. Then
E_q0[w] = Z exactly (q0 is normalized), so

    log Ẑ = logsumexp(log w) − log N

is unbiased in w with MC error that vanishes as the anneal lengthens —
and the COMBINATION is the point: the MAP fleet supplies the base
Gaussian that makes short anneals accurate.

``schedule='adaptive'`` upgrades the fixed ladder to adaptive tempered
SMC (Del Moral–Doucet–Jasra 2012; Jasra et al. 2011): each rung picks
the LARGEST temperature increment whose post-update weight ESS stays at
``adapt_target · N`` (on-device bisection over the increment — the
increment's cost is a handful of (N,) logsumexp sweeps against the
rung's batched-gradient leapfrog). Easy directions anneal in a few big
jumps; the hard stretch gets all the rungs. A remaining-budget floor
``(1−b)/(rungs left)`` guarantees b reaches 1 within the ``n_steps``
cap (degrading gracefully to the linear ladder when the ESS target is
unreachable), so the compiled program keeps a static trip bound.

Accelerator shape: the particle fleet is one (N, n) batch advancing through a
single `lax.scan` over rungs (fixed schedule) or a `lax.while_loop`
with a static cap (adaptive) — every rung is one batched leapfrog (the
tempered gradient is an affine combination of the analytic base gradient
and the model gradient) plus elementwise weight updates. No per-particle
control flow; the only gather is systematic resampling, at most one per
rung.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad
from .sampling import _da_update

__all__ = ["AISResult", "ais_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)


class AISResult(NamedTuple):
    """logZ: the AIS evidence estimate (logsumexp(logw) − log N).
    logw: (N,) per-particle log weights (for stratified reuse).
    ess: scalar weight effective sample size in [1, N] — the reliability
    diagnostic (ess ≪ N means lengthen the anneal / check the base).
    accept_rate: (T,) fleet-mean HMC acceptance per rung (adaptive mode:
    zero-padded past ``n_rungs``).
    step_size: final adapted leapfrog step.
    n_resamples: scalar count of SMC resampling events (0 in plain-AIS
    mode or when the weights never collapsed).
    final_x: (N, n) particles at b = 1 (posterior draws, weighted by w).
    betas: (T+1,) the temperature ladder actually used (adaptive mode:
    padded with 1.0 past ``n_rungs``).
    n_rungs: scalar int — rungs executed (== n_steps for a fixed
    schedule; ≤ n_steps when the adaptive anneal finishes early).
    """

    logZ: jax.Array
    logw: jax.Array
    ess: jax.Array
    accept_rate: jax.Array
    step_size: jax.Array
    n_resamples: jax.Array
    final_x: jax.Array
    betas: jax.Array
    n_rungs: jax.Array


def _base_from(base, dtype):
    """(mu, cov) from an explicit pair or a solve result (scalar or
    batched fleet — the Laplace base the MAP engines already produced)."""
    if isinstance(base, tuple) and len(base) == 2:
        mu, cov = base
        return jnp.asarray(mu, dtype), jnp.asarray(cov, dtype)
    x = getattr(base, "x", None)
    state = getattr(base, "state", None)
    if x is None or state is None or not hasattr(state, "B"):
        raise TypeError(
            "base must be a (mu, cov) pair or a BFGS solve result "
            "(OptimizeResult with a dense-B state); for L-BFGS fleets "
            "pass (x_map, mass) from chain_init_from_map explicitly"
        )
    if x.ndim == 2:  # fleet: best converged lane's mode, lane-averaged B
        from .sampling import chain_init_from_map
        from .state import Status

        ok = base.status == Status.CONVERGED
        if not bool(jnp.any(ok)):
            # a no-converged-lane fleet would silently anchor the base at
            # a failed iterate with an identity mass — same contract as
            # the workflow's MAP stage: refuse loudly
            raise ValueError(
                "ais_evidence: no lane of the base fleet converged — "
                "the Laplace base would be meaningless; fix the MAP "
                "solve or pass an explicit (mu, cov)"
            )
        best = jnp.argmax(jnp.where(ok, base.fun, -jnp.inf))
        mu = x[best]
        _, cov = chain_init_from_map(base)
        return mu.astype(dtype), cov.astype(dtype)
    return x.astype(dtype), state.B.astype(dtype)


def _systematic_resample(logw, x, q0x, px, k, N, dtype):
    """Systematic resampling: ONE uniform stratifies N positions over the
    normalized-weight CDF (searchsorted + gather — the single gather per
    resampled rung is the price of SMC; everything else stays
    gather-free). Returns equal-weight particles."""
    lse = jax.scipy.special.logsumexp(logw)
    w = jnp.exp(logw - lse)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(k, (), dtype)
    pos = (u0 + jnp.arange(N, dtype=dtype)) / N
    idx = jnp.searchsorted(cdf, pos, side="left")
    idx = jnp.clip(idx, 0, N - 1)
    return x[idx], q0x[idx], px[idx]


def _make_gaussian_base(mu, cov, diag_cov, N, n, dtype):
    """Closure bundle for the base Gaussian q0 = N(mu, cov) and the
    cov-preconditioned HMC kinetics: (q0_draw, q0_val_grad, draw_p, kin,
    vel). All through one Cholesky (diag: elementwise)."""
    if diag_cov:
        sd = jnp.sqrt(cov)
        logdet = jnp.sum(jnp.log(cov))

        def q0_draw(k):
            return mu[None, :] + sd[None, :] * jax.random.normal(
                k, (N, n), dtype
            )

        def q0_val_grad(x):
            d = (x - mu[None, :]) / cov[None, :]
            val = (
                -0.5 * jnp.sum((x - mu[None, :]) * d, axis=1)
                - 0.5 * (logdet + n * _LOG_2PI)
            )
            return val, -d

        def draw_p(k):
            return jax.random.normal(k, (N, n), dtype) / sd[None, :]

        def kin(p):
            return 0.5 * jnp.sum(cov[None, :] * p * p, axis=1)

        def vel(p):
            return cov[None, :] * p
    else:
        chol = jnp.linalg.cholesky(cov)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        prec = jax.scipy.linalg.cho_solve(
            (chol, True), jnp.eye(n, dtype=dtype)
        )
        chol_u = chol.T

        def q0_draw(k):
            z = jax.random.normal(k, (N, n), dtype)
            return mu[None, :] + z @ chol.T

        def q0_val_grad(x):
            d = (x - mu[None, :]) @ prec  # (N, n) = Σ⁻¹ (x − mu) rows
            val = (
                -0.5 * jnp.sum((x - mu[None, :]) * d, axis=1)
                - 0.5 * (logdet + n * _LOG_2PI)
            )
            return val, -d

        def draw_p(k):
            z = jax.random.normal(k, (N, n), dtype)
            return jax.scipy.linalg.solve_triangular(
                chol_u, z.T, lower=False
            ).T

        def kin(p):
            return 0.5 * jnp.einsum("ci,ij,cj->c", p, cov, p)

        def vel(p):
            return p @ cov.T

    return q0_draw, q0_val_grad, draw_p, kin, vel


def _tempered_hmc_move(
    x, q0x, px, b1, eps, k1, k2, n_leapfrog, base, p_val_grad
):
    """One fleet HMC move targeting pi_{b1} ∝ q0^(1-b1) · p^(b1),
    preconditioned by the base covariance. Returns the post-Metropolis
    (x, q0x, px) and the fleet acceptance probabilities."""
    _q0_draw, q0_val_grad, draw_p, kin, vel = base
    p0 = draw_p(k1)

    def grad_t(xx):
        qv, qg = q0_val_grad(xx)
        pv, pg = p_val_grad(xx)
        return qv, pv, (1.0 - b1) * qg + b1 * pg

    # gradient (and both values) ride the carry: ONE evaluation per
    # leapfrog step (+1 seed) — step i's closing half-kick and step
    # i+1's opening half-kick share the same position — and the
    # post-loop Metropolis values come out of the carry for free
    def body(_, c):
        xx, pp, _qv, _pv, g = c
        pp = pp + 0.5 * eps * g
        xx = xx + eps * vel(pp)
        qv, pv, g = grad_t(xx)
        pp = pp + 0.5 * eps * g
        return xx, pp, qv, pv, g

    qv0, pv0, g0 = grad_t(x)
    x_new, p_new, q0_new, p_val_new, _ = lax.fori_loop(
        0, n_leapfrog, body, (x, p0, qv0, pv0, g0)
    )
    logpi_old = (1.0 - b1) * q0x + b1 * px
    logpi_new = (1.0 - b1) * q0_new + b1 * p_val_new
    log_ratio = (logpi_new - kin(p_new)) - (logpi_old - kin(p0))
    a_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
    a_prob = jnp.where(jnp.isfinite(a_prob), a_prob, 0.0)
    N = x.shape[0]
    acc = jax.random.uniform(k2, (N,), x.dtype) < a_prob
    x = jnp.where(acc[:, None], x_new, x)
    q0x = jnp.where(acc, q0_new, q0x)
    px = jnp.where(acc, p_val_new, px)
    return x, q0x, px, a_prob


def _weight_ess(logw):
    """exp(2·lse(w) − lse(w²)): the weight effective sample size."""
    return jnp.exp(
        2.0 * jax.scipy.special.logsumexp(logw)
        - jax.scipy.special.logsumexp(2.0 * logw)
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_particles", "n_leapfrog",
        "target_accept", "diag_cov", "resample",
    ),
)
def _ais_core(
    obj, key, mu, cov, betas, n_particles, n_leapfrog, step_size,
    target_accept, value_and_grad_fn, diag_cov, resample,
    resample_threshold,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag)

    n = mu.shape[0]
    dtype = mu.dtype
    N = n_particles
    T = betas.shape[0] - 1

    base = _make_gaussian_base(mu, cov, diag_cov, N, n, dtype)
    q0_draw, q0_val_grad = base[0], base[1]

    def p_val_grad(x):
        return vag_b(x)

    k_init, k_anneal = jax.random.split(key)
    x0 = q0_draw(k_init)
    q0_x, _ = q0_val_grad(x0)
    p_x, _ = p_val_grad(x0)

    mu_da = jnp.log(10.0 * jnp.asarray(step_size, dtype))
    log_eps0 = jnp.log(jnp.asarray(step_size, dtype))

    def rung(carry, t):
        (x, q0x, px, logw, logz_acc, n_resamp, log_eps, log_eps_bar,
         h_bar, t_da) = carry
        b0 = betas[t]
        b1 = betas[t + 1]
        # weight increment at the CURRENT particles (before the move):
        # failed/overflowed particles carry -inf weight, not NaN poison
        dw = (b1 - b0) * (px - q0x)
        logw = logw + jnp.where(jnp.isfinite(dw), dw, -jnp.inf)

        # one HMC move targeting pi_{b1} = (1-b1) q0 + b1 p
        k = jax.random.fold_in(k_anneal, t)
        k1, k2, k3 = jax.random.split(k, 3)

        if resample:
            # SMC: when the weight ESS collapses, bank the partial
            # evidence (logsumexp(w) − log N) and restart equal weights
            # on resampled particles
            lse_t = jax.scipy.special.logsumexp(logw)
            ess_t = jnp.exp(2.0 * lse_t
                            - jax.scipy.special.logsumexp(2.0 * logw))

            def do_rs(args):
                x, q0x, px, logw, logz_acc, n_resamp = args
                x, q0x, px = _systematic_resample(
                    logw, x, q0x, px, k3, N, dtype
                )
                logz_acc = logz_acc + lse_t - jnp.log(
                    jnp.asarray(N, dtype)
                )
                return (x, q0x, px, jnp.zeros_like(logw), logz_acc,
                        n_resamp + 1)

            x, q0x, px, logw, logz_acc, n_resamp = lax.cond(
                ess_t < resample_threshold * N,
                do_rs,
                lambda a: a,
                (x, q0x, px, logw, logz_acc, n_resamp),
            )
        eps = jnp.exp(log_eps)
        x, q0x, px, a_prob = _tempered_hmc_move(
            x, q0x, px, b1, eps, k1, k2, n_leapfrog, base, p_val_grad
        )
        log_eps, log_eps_bar, h_bar, t_da = _da_update(
            h_bar, log_eps_bar, t_da,
            target_accept - jnp.mean(a_prob), mu_da,
        )
        carry = (x, q0x, px, logw, logz_acc, n_resamp, log_eps,
                 log_eps_bar, h_bar, t_da)
        return carry, jnp.mean(a_prob)

    carry0 = (
        x0, q0_x, p_x, jnp.zeros((N,), dtype), jnp.zeros((), dtype),
        jnp.zeros((), jnp.int32),
        log_eps0, log_eps0, jnp.zeros((), dtype), jnp.zeros((), dtype),
    )
    carry, accs = lax.scan(rung, carry0, jnp.arange(T))
    (x, _q0x, _px, logw, logz_acc, n_resamp, log_eps, _leb, _hb,
     _tda) = carry

    lse = jax.scipy.special.logsumexp(logw)
    logZ = logz_acc + lse - jnp.log(jnp.asarray(N, dtype))
    ess = jnp.exp(2.0 * lse - jax.scipy.special.logsumexp(2.0 * logw))
    return AISResult(
        logZ=logZ,
        logw=logw,
        ess=ess,
        accept_rate=accs,
        step_size=jnp.exp(log_eps),
        n_resamples=n_resamp,
        final_x=x,
        betas=betas,
        n_rungs=jnp.asarray(T, jnp.int32),
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_particles", "n_leapfrog",
        "target_accept", "diag_cov", "resample", "n_steps",
    ),
)
def _smc_adaptive_core(
    obj, key, mu, cov, n_steps, n_particles, n_leapfrog, step_size,
    target_accept, value_and_grad_fn, diag_cov, resample,
    resample_threshold, adapt_target,
):
    """Adaptive tempered SMC: rungs run under a while_loop capped at
    ``n_steps``; each rung bisects the temperature increment db so the
    post-update combined-weight ESS lands on ``adapt_target · N``
    (largest db that keeps ESS ≥ target), floored at the
    remaining-budget linear split so b provably reaches 1 by the cap."""
    vag = as_value_and_grad(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag)

    n = mu.shape[0]
    dtype = mu.dtype
    N = n_particles
    T = n_steps

    base = _make_gaussian_base(mu, cov, diag_cov, N, n, dtype)
    q0_draw, q0_val_grad = base[0], base[1]

    def p_val_grad(x):
        return vag_b(x)

    k_init, k_anneal = jax.random.split(key)
    x0 = q0_draw(k_init)
    q0_x, _ = q0_val_grad(x0)
    p_x, _ = p_val_grad(x0)

    mu_da = jnp.log(10.0 * jnp.asarray(step_size, dtype))
    log_eps0 = jnp.log(jnp.asarray(step_size, dtype))
    one = jnp.asarray(1.0, dtype)
    ess_target = adapt_target * N

    def cond(carry):
        return (carry[7] < T) & (carry[6] < one)

    def rung(carry):
        (x, q0x, px, logw, logz_acc, n_resamp, b, t, log_eps,
         log_eps_bar, h_bar, t_da, acc_buf, beta_buf) = carry

        delta = px - q0x  # (N,) the per-particle log-weight slope in b

        def lw_at(db):
            dw = db * delta
            return logw + jnp.where(jnp.isfinite(dw), dw, -jnp.inf)

        if resample:
            # combined-weight ESS: resampling resets logw to zeros, so
            # the criterion recovers after each resample and keeps
            # measuring the quantity the resampler acts on
            def crit_ess(db):
                return _weight_ess(lw_at(db))
        else:
            # no-resample mode: the combined ESS is monotone
            # NON-INCREASING in t — once it crosses the target every
            # later rung would take the remaining-budget floor and the
            # "adaptive" ladder would stop adapting. Bisect instead on
            # the CONDITIONAL ESS of the increment (Zhou–Johansen–Aston
            # 2016): CESS = N·(Σ Ŵ·w)²/(Σ Ŵ·w²) with Ŵ the normalized
            # carried weights and w = exp(db·delta) — a per-rung local
            # discrepancy that stays in (0, N] for every rung
            lse_prev = jax.scipy.special.logsumexp(logw)
            lW = logw - lse_prev  # normalized log carried weights

            def crit_ess(db):
                dw = db * delta
                dw = jnp.where(jnp.isfinite(dw), dw, -jnp.inf)
                return jnp.asarray(N, dtype) * jnp.exp(
                    2.0 * jax.scipy.special.logsumexp(lW + dw)
                    - jax.scipy.special.logsumexp(lW + 2.0 * dw)
                )

        rem = one - b
        # largest db in (0, rem] with criterion-ESS >= target: 30 fixed
        # bisection steps on (N,) sweeps — noise vs the rung's
        # n_leapfrog batched model gradients
        full_ok = crit_ess(rem) >= ess_target

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = crit_ess(mid) >= ess_target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo, _hi = lax.fori_loop(0, 30, bis, (jnp.zeros((), dtype), rem))
        db = jnp.where(full_ok, rem, lo)
        # remaining-budget floor: guarantees termination at the cap and
        # degrades to the linear ladder when the target is unreachable
        floor = rem / (T - t).astype(dtype)
        db = jnp.clip(db, floor, rem)
        b1 = jnp.where(db >= rem, one, b + db)

        dw = (b1 - b) * delta
        logw = logw + jnp.where(jnp.isfinite(dw), dw, -jnp.inf)

        k = jax.random.fold_in(k_anneal, t)
        k1, k2, k3 = jax.random.split(k, 3)

        if resample:
            lse_t = jax.scipy.special.logsumexp(logw)
            ess_t = jnp.exp(2.0 * lse_t
                            - jax.scipy.special.logsumexp(2.0 * logw))

            def do_rs(args):
                x, q0x, px, logw, logz_acc, n_resamp = args
                x, q0x, px = _systematic_resample(
                    logw, x, q0x, px, k3, N, dtype
                )
                logz_acc = logz_acc + lse_t - jnp.log(
                    jnp.asarray(N, dtype)
                )
                return (x, q0x, px, jnp.zeros_like(logw), logz_acc,
                        n_resamp + 1)

            x, q0x, px, logw, logz_acc, n_resamp = lax.cond(
                ess_t < resample_threshold * N,
                do_rs,
                lambda a: a,
                (x, q0x, px, logw, logz_acc, n_resamp),
            )

        eps = jnp.exp(log_eps)
        x, q0x, px, a_prob = _tempered_hmc_move(
            x, q0x, px, b1, eps, k1, k2, n_leapfrog, base, p_val_grad
        )
        log_eps, log_eps_bar, h_bar, t_da = _da_update(
            h_bar, log_eps_bar, t_da,
            target_accept - jnp.mean(a_prob), mu_da,
        )
        acc_buf = acc_buf.at[t].set(jnp.mean(a_prob))
        beta_buf = beta_buf.at[t + 1].set(b1)
        return (x, q0x, px, logw, logz_acc, n_resamp, b1, t + 1,
                log_eps, log_eps_bar, h_bar, t_da, acc_buf, beta_buf)

    beta_buf0 = jnp.ones((T + 1,), dtype).at[0].set(0.0)
    carry0 = (
        x0, q0_x, p_x, jnp.zeros((N,), dtype), jnp.zeros((), dtype),
        jnp.zeros((), jnp.int32), jnp.zeros((), dtype),
        jnp.zeros((), jnp.int32),
        log_eps0, log_eps0, jnp.zeros((), dtype), jnp.zeros((), dtype),
        jnp.zeros((T,), dtype), beta_buf0,
    )
    (x, _q0x, _px, logw, logz_acc, n_resamp, _b, t, log_eps, _leb,
     _hb, _tda, acc_buf, beta_buf) = lax.while_loop(cond, rung, carry0)

    lse = jax.scipy.special.logsumexp(logw)
    logZ = logz_acc + lse - jnp.log(jnp.asarray(N, dtype))
    ess = jnp.exp(2.0 * lse - jax.scipy.special.logsumexp(2.0 * logw))
    return AISResult(
        logZ=logZ,
        logw=logw,
        ess=ess,
        accept_rate=acc_buf,
        step_size=jnp.exp(log_eps),
        n_resamples=n_resamp,
        final_x=x,
        betas=beta_buf,
        n_rungs=t,
    )


def ais_evidence(
    obj,
    key: jax.Array,
    base,
    n_particles: int = 1024,
    n_steps: int = 64,
    n_leapfrog: int = 8,
    step_size: float = 0.2,
    target_accept: float = 0.8,
    schedule=1.0,
    resample: bool = False,
    resample_threshold: float = 0.5,
    adapt_target: float = 0.5,
    value_and_grad_fn: Optional[Callable] = None,
) -> AISResult:
    """Annealed-importance-sampling log evidence from a Laplace base.

    ``base``: a BFGS solve result (scalar or fleet — mode x* and
    curvature B become the base Gaussian q0 = N(x*, B); for a fleet the
    best converged lane's mode and the converged-lane-averaged B), or an
    explicit ``(mu, cov)`` pair with ``cov`` dense (n, n) or diagonal
    (n,) — e.g. `chain_init_from_map`'s mass for L-BFGS fleets.

    ``n_steps`` rungs anneal q0 → posterior (one fleet HMC move per rung,
    preconditioned by the base covariance, step size dual-averaged along
    the anneal); ``schedule``: a float power p gives
    b_t = (t/T)^p (p > 1 spends rungs near the base, p = 1 linear), pass
    an explicit (n_steps+1,) array from 0 to 1, or ``'adaptive'`` for
    adaptive tempered SMC — each rung bisects (on device) the LARGEST
    temperature increment keeping an ESS criterion at
    ``adapt_target · n_particles``, so easy stretches anneal in a few
    jumps and the rung budget concentrates where the target changes
    fastest; ``n_steps`` becomes a CAP (a remaining-budget floor
    guarantees b reaches 1 within it; ``result.n_rungs`` reports rungs
    used and ``result.betas`` the ladder found, padded with 1.0).
    Adaptive mode pairs naturally with ``resample=True`` (the classic
    SMC sampler), where the criterion is the combined-weight ESS the
    resampler acts on; without resampling that ESS is monotone
    non-increasing (the ladder would stop adapting once it crossed the
    target), so the criterion switches to the conditional ESS of each
    increment (CESS, Zhou–Johansen–Aston 2016) and the run is AIS on a
    self-tuned ladder.

    ``resample=True`` upgrades plain AIS to an SMC sampler: whenever the
    weight ESS drops below ``resample_threshold · n_particles``, the
    partial evidence logsumexp(w) − log N is banked into the estimate,
    particles systematically resample to equal weights (one gather —
    the only gather in the program), and the anneal continues. This
    keeps long anneals on hard targets from being dominated by a few
    surviving particles; `result.n_resamples` reports how often it
    fired.

    `result.logZ` estimates log Z (unbiased in the weights); compare
    `laplace_evidence` to measure the Gaussian approximation's error —
    on multimodal posteriors Laplace integrates one basin while AIS, with
    a wide-enough base, sees them all. `result.ess` ≪ n_particles means
    the anneal is too short or the base too narrow.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    x_probe = getattr(base, "x", base[0] if isinstance(base, tuple) else None)
    if x_probe is None:
        raise TypeError("base must be a solve result or a (mu, cov) pair")
    dtype = jnp.asarray(x_probe).dtype
    mu, cov = _base_from(base, dtype)
    if mu.ndim != 1:
        raise ValueError(f"base mean must be (n,), got {mu.shape}")
    if cov.ndim not in (1, 2):
        raise ValueError("base cov must be (n, n) dense or (n,) diagonal")
    if not (0.0 < resample_threshold < 1.0):
        raise ValueError("resample_threshold must be in (0, 1)")
    adaptive = isinstance(schedule, str)
    if adaptive:
        if schedule != "adaptive":
            raise ValueError(
                f"schedule must be a power, an array, or 'adaptive'; "
                f"got {schedule!r}"
            )
        if not (0.0 < adapt_target < 1.0):
            raise ValueError("adapt_target must be in (0, 1)")
        return _smc_adaptive_core(
            obj, key, mu, cov, n_steps, n_particles, n_leapfrog,
            step_size, target_accept, value_and_grad_fn, cov.ndim == 1,
            resample, jnp.asarray(resample_threshold, dtype),
            jnp.asarray(adapt_target, dtype),
        )
    if isinstance(schedule, (int, float)):
        if schedule <= 0:
            raise ValueError("schedule power must be > 0")
        betas = jnp.linspace(0.0, 1.0, n_steps + 1, dtype=dtype) ** float(
            schedule
        )
    else:
        betas = jnp.asarray(schedule, dtype)
        if betas.shape != (n_steps + 1,):
            raise ValueError(
                f"schedule array must be ({n_steps + 1},), got {betas.shape}"
            )
    return _ais_core(
        obj, key, mu, cov, betas, n_particles, n_leapfrog,
        step_size, target_accept, value_and_grad_fn, cov.ndim == 1,
        resample, jnp.asarray(resample_threshold, dtype),
    )
