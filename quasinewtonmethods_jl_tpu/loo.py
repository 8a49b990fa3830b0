"""PSIS-LOO cross-validation: out-of-sample model comparison from draws.

The workflow the reference anchors (MAP → HMC; SURVEY.md §3.3's
probability-model protocol) ends with competing fitted models; this
module adds the standard way to pick between them (Vehtari, Gelman &
Gabry 2017): leave-one-out predictive density estimated by importance
sampling from the FULL-posterior draws, with each observation's weights
Pareto-smoothed (the same GPD machinery `pathfinder.psis_smooth`
already uses for its proposal pool) so the estimate stays stable where
raw IS weights have infinite variance, and with the per-observation
Pareto k̂ reporting exactly where even that fails (k̂ > 0.7 →
refit-without-that-point territory).

Inputs are pointwise log-likelihoods log p(y_i | θ_s) — an (S, N)
matrix, or a callable evaluated over the draws here — because only the
user's model knows how its density factorizes over observations; the
library supplies everything after that point.

Accelerator shape: one `vmap` of the static-shape PSIS smoother over the N
observation columns (each is an (S,) sort + GPD quantile fill), then
logsumexp reductions — a single jitted program, draws never leave the
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from .pathfinder import psis_smooth

__all__ = ["LOOResult", "WAICResult", "loo_psis", "loo_compare", "waic"]


class LOOResult(NamedTuple):
    """elpd: expected log pointwise predictive density, summed over
    observations (higher = better out-of-sample fit).
    se: standard error of elpd (sqrt(N · var of the pointwise terms)).
    p_loo: effective number of parameters (lpd − elpd; ≈ the true
    parameter count for well-specified regular models — a much larger
    value flags misspecification).
    elpd_pointwise: (N,) per-observation contributions (feed to
    `loo_compare`; inspect alongside khat).
    khat: (N,) per-observation Pareto k̂ diagnostics — k̂ > 0.7 means
    that observation's importance weights are unreliable (typically an
    influential/outlying point); -inf means the weights were
    near-uniform and needed no smoothing.
    """

    elpd: jax.Array
    se: jax.Array
    p_loo: jax.Array
    elpd_pointwise: jax.Array
    khat: jax.Array


@jax.jit
def _loo_core(ll):
    S = ll.shape[0]
    lse = jax.scipy.special.logsumexp

    # raw LOO importance log-weights per observation: w_s ∝ 1/p(y_i|θ_s)
    logw = -ll  # (S, N)
    smooth, khat = jax.vmap(psis_smooth, in_axes=1, out_axes=(1, 0))(logw)
    logw_norm = smooth - lse(smooth, axis=0, keepdims=True)

    elpd_i = lse(logw_norm + ll, axis=0)  # (N,)
    lpd_i = lse(ll, axis=0) - jnp.log(jnp.asarray(S, ll.dtype))
    n = ll.shape[1]
    elpd = jnp.sum(elpd_i)
    se = jnp.sqrt(n * jnp.var(elpd_i, ddof=1)) if n > 1 else jnp.zeros_like(
        elpd
    )
    return LOOResult(
        elpd=elpd,
        se=se,
        p_loo=jnp.sum(lpd_i - elpd_i),
        elpd_pointwise=elpd_i,
        khat=khat,
    )


def loo_psis(
    loglik: Union[jax.Array, Callable],
    draws: Optional[jax.Array] = None,
) -> LOOResult:
    """Pareto-smoothed importance-sampling LOO (Vehtari et al. 2017).

    ``loglik``: an (S, N) pointwise log-likelihood matrix — S posterior
    draws × N observations, log p(y_i | θ_s) — or a callable
    ``theta -> (N,) pointwise log-likelihood`` evaluated here over
    ``draws`` ((S, n) or the samplers' (n_samples, chains, n), flattened)
    via one `vmap`.

    Returns `LOOResult`; compare fitted models on the same data with
    `loo_compare` (never by raw elpd alone — the pointwise pairing is
    what gives the difference its standard error). Check `khat`: any
    observation above 0.7 makes its contribution unreliable (the honest
    remedies are refitting without that point or a more robust model —
    the diagnostic exists so this failure is visible, not silent).
    """
    if callable(loglik):
        if draws is None:
            raise ValueError(
                "a callable loglik needs draws= (posterior samples)"
            )
        x = jnp.asarray(draws)
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        if x.ndim != 2:
            raise ValueError(
                f"draws must be (S, n) or (n_samples, chains, n), got "
                f"{x.shape}"
            )
        ll = jax.vmap(loglik)(x)
    else:
        ll = jnp.asarray(loglik)
    if ll.ndim != 2:
        raise ValueError(
            f"pointwise log-likelihood must be (S draws, N obs), got "
            f"{ll.shape}"
        )
    if ll.shape[0] < 8:
        raise ValueError("need at least 8 draws for PSIS-LOO")
    return _loo_core(ll)


class WAICResult(NamedTuple):
    """elpd: WAIC expected log pointwise predictive density (higher =
    better). se: its standard error. p_waic: effective parameter count
    (sum of per-observation log-likelihood variances over draws).
    elpd_pointwise: (N,) per-observation terms (feeds `loo_compare` —
    it only reads `.elpd_pointwise`, so LOO and WAIC results mix)."""

    elpd: jax.Array
    se: jax.Array
    p_waic: jax.Array
    elpd_pointwise: jax.Array


@jax.jit
def _waic_core(ll):
    S = ll.shape[0]
    lse = jax.scipy.special.logsumexp
    lpd_i = lse(ll, axis=0) - jnp.log(jnp.asarray(S, ll.dtype))
    p_i = jnp.var(ll, axis=0, ddof=1)
    elpd_i = lpd_i - p_i
    n = ll.shape[1]
    se = jnp.sqrt(n * jnp.var(elpd_i, ddof=1)) if n > 1 else jnp.zeros(
        (), ll.dtype
    )
    return WAICResult(
        elpd=jnp.sum(elpd_i), se=se, p_waic=jnp.sum(p_i),
        elpd_pointwise=elpd_i,
    )


def waic(
    loglik: Union[jax.Array, Callable],
    draws: Optional[jax.Array] = None,
) -> WAICResult:
    """Widely applicable information criterion (Watanabe 2010; the
    Gelman et al. 2014 elpd formulation). Same inputs as `loo_psis`;
    pure reductions, no importance weights — cheaper but less robust
    than PSIS-LOO (its variance-based penalty understates under strong
    influence, and there is no per-observation reliability diagnostic),
    so prefer `loo_psis` and use WAIC as its cross-check: the two
    agreeing is evidence neither is being distorted."""
    if callable(loglik):
        if draws is None:
            raise ValueError(
                "a callable loglik needs draws= (posterior samples)"
            )
        x = jnp.asarray(draws)
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        if x.ndim != 2:
            raise ValueError(
                f"draws must be (S, n) or (n_samples, chains, n), got "
                f"{x.shape}"
            )
        ll = jax.vmap(loglik)(x)
    else:
        ll = jnp.asarray(loglik)
    if ll.ndim != 2:
        raise ValueError(
            f"pointwise log-likelihood must be (S draws, N obs), got "
            f"{ll.shape}"
        )
    if ll.shape[0] < 2:
        raise ValueError("need at least 2 draws for WAIC")
    return _waic_core(ll)


def loo_compare(a: LOOResult, b: LOOResult) -> tuple:
    """Paired model comparison: returns ``(elpd_diff, se_diff)`` where
    ``elpd_diff = a.elpd − b.elpd`` (> 0 favors model a) and ``se_diff``
    is the standard error OF THE DIFFERENCE, computed from the paired
    pointwise terms (the correct uncertainty — pointwise elpds on the
    same data are strongly correlated across models, so this is far
    smaller than combining the marginal SEs). |elpd_diff| ≲ 2·se_diff
    means the data cannot distinguish the models."""
    da = a.elpd_pointwise
    db = b.elpd_pointwise
    if da.shape != db.shape:
        raise ValueError(
            f"models were evaluated on different observation sets: "
            f"{da.shape} vs {db.shape}"
        )
    d = da - db
    n = d.shape[0]
    se = jnp.sqrt(n * jnp.var(d, ddof=1)) if n > 1 else jnp.zeros_like(
        a.elpd
    )
    return jnp.sum(d), se
