"""MCMC convergence diagnostics for the batched samplers — split R-hat and
effective sample size.

The reference workflow ends at the MAP handoff; this module closes the
loop on the sampling side the way `solve_stats` does for the optimizer
fleets: given the (n_samples, chains, n) draws that `hmc_sample` /
`chees_sample` return, it computes the two numbers every HMC user needs
before trusting them — the split-chain potential scale reduction factor
(R-hat, Gelman & Rubin via the split formulation of Vehtari et al. 2021)
and the autocorrelation-aware effective sample size (Geyer's initial
monotone sequence estimator, the Stan formulation).

Two implementations, one contract:

  * `split_rhat` / `ess` / `diagnose_chains` — host-side numpy. The
    readable oracle; runs on data already fetched for analysis.
  * `split_rhat_device` / `ess_device` / `diagnose_chains_device` —
    the same math as jitted XLA over the ON-DEVICE draws (batched rFFT
    autocovariance, `lax.cummin` for the Geyer monotone envelope).
    Only the (n,)-sized summaries ever cross from device to host.
    This is the `map_then_sample` default: fetching every draw for host
    FFTs costs far more transfer than the computation itself —
    diagnostics are a handful of reductions and one batched FFT, exactly
    what the device is for.

Parity between the two is calibration-tested (same iid/AR(1)/disjoint
fixtures run through both paths).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "ChainDiagnostics",
    "split_rhat",
    "ess",
    "rank_normalized_rhat",
    "tail_ess",
    "diagnose_chains",
    "energy_bfmi",
    "PosteriorSummary",
    "posterior_summary",
    "split_rhat_device",
    "ess_device",
    "rank_normalized_rhat_device",
    "tail_ess_device",
    "diagnose_chains_device",
    "energy_bfmi_device",
]


class ChainDiagnostics(NamedTuple):
    """Per-dimension convergence summary for a batch of chains.

    rhat: (n,) split-chain R-hat (want < 1.01)
    ess: (n,) bulk effective sample size (out of draws * chains)
    mean/std: (n,) pooled posterior moment estimates
    rhat_rank: (n,) rank-normalized R-hat — max of the bulk
    (rank-normalized) and folded (|x − median| rank-normalized) split
    R-hats (Vehtari et al. 2021). Catches chain-VARIANCE mismatch the
    mean-based `rhat` is structurally blind to. None when not computed
    (`rank=False`).
    ess_tail: (n,) tail ESS — min over the 5%/95% quantile-indicator
    ESSs; ≪ `ess` means the chains mix in the bulk but not the tails
    (credible-interval endpoints are then untrustworthy). None when not
    computed.
    """

    rhat: np.ndarray
    ess: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    rhat_rank: object = None
    ess_tail: object = None


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(draws, chains, n) -> (draws//2, 2*chains, n): each chain split in
    half, so a chain drifting between halves shows up as between-chain
    variance (the 'split' in split R-hat)."""
    d = (x.shape[0] // 2) * 2
    first, second = x[: d // 2], x[d // 2 : d]
    return np.concatenate([first, second], axis=1)


def split_rhat(samples) -> np.ndarray:
    """Split-chain R-hat per dimension.

    samples: (draws, chains, n) array (as returned by the samplers).
    Returns (n,) — values near 1 indicate the chains agree; > 1.01 means
    keep sampling (Vehtari et al. 2021 threshold)."""
    x = _split_chains(np.asarray(samples, np.float64))
    n_draw, n_chain, _ = x.shape
    if n_draw < 2:
        raise ValueError("need at least 4 draws for split R-hat")
    chain_mean = x.mean(axis=0)  # (chains, n)
    chain_var = x.var(axis=0, ddof=1)  # (chains, n)
    w = chain_var.mean(axis=0)  # within
    b = n_draw * chain_mean.var(axis=0, ddof=1)  # between
    var_plus = (n_draw - 1) / n_draw * w + b / n_draw
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / w)
    # a dimension the chains never move in (w == 0) is perfectly mixed
    return np.where(w > 0, out, 1.0)


def _chain_autocov(x: np.ndarray) -> np.ndarray:
    """Biased (1/N) autocovariance per (chain, dim) via FFT.
    x: (draws, chains, n) -> (draws, chains, n)."""
    n_draw = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n_draw]
    return acov.real / n_draw


def ess(samples) -> np.ndarray:
    """Bulk effective sample size per dimension (Geyer initial monotone
    sequence over the multi-chain autocorrelation, as in Stan).

    samples: (draws, chains, n). Returns (n,) — iid draws give
    ~draws*chains; sticky chains give much less."""
    x = _split_chains(np.asarray(samples, np.float64))
    n_draw, n_chain, n_dim = x.shape
    if n_draw < 4:
        raise ValueError("need at least 8 draws for ess")
    acov = _chain_autocov(x)  # (draws, chains, n)
    chain_var = acov[0] * n_draw / (n_draw - 1.0)  # (chains, n)
    w = chain_var.mean(axis=0)
    var_plus = (n_draw - 1) / n_draw * w + n_draw * x.mean(axis=0).var(
        axis=0, ddof=1
    ) / n_draw
    var_plus = np.where(var_plus > 0, var_plus, 1.0)

    # rho_t = 1 - (W - mean_chain_acov_t) / var_plus     (Stan eq.)
    rho = 1.0 - (w[None, :] - acov.mean(axis=1)) / var_plus[None, :]
    rho[0] = 1.0

    # Geyer: sum consecutive pairs while positive, enforce monotone decay
    n_pair = n_draw // 2
    pair = rho[0 : 2 * n_pair : 2] + rho[1 : 2 * n_pair : 2]  # (n_pair, n)
    # monotone decreasing envelope
    pair = np.minimum.accumulate(pair, axis=0)
    # truncate at the first non-positive pair (exclusive)
    positive = pair > 0.0
    first_bad = np.where(
        positive.all(axis=0), n_pair, positive.argmin(axis=0)
    )  # (n,)
    mask = np.arange(n_pair)[:, None] < first_bad[None, :]
    tau = -1.0 + 2.0 * np.sum(pair * mask, axis=0)  # sum includes rho_0 pair
    tau = np.maximum(tau, 1.0 / np.log10(n_draw * n_chain + 10.0))
    return n_draw * n_chain / tau


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Pooled rank-normalization per dimension (Vehtari et al. 2021):
    ordinal ranks over ALL draws × chains, mapped through the normal
    quantile function with the Blom offset z = Φ⁻¹((r − 3/8)/(S + 1/4)).
    x: (draws, chains, n) -> same shape, now standard-normal-ish
    regardless of the target's tails (this is what makes rank R-hat and
    its folded variant robust to heavy tails / infinite variance)."""
    from scipy.special import ndtri

    d, c, n = x.shape
    flat = x.reshape(d * c, n)
    # double argsort = ordinal ranks (draws are continuous; ties
    # measure-zero), 1-based
    r = np.argsort(np.argsort(flat, axis=0), axis=0) + 1.0
    z = ndtri((r - 0.375) / (d * c + 0.25))
    return z.reshape(d, c, n)


def rank_normalized_rhat(samples) -> np.ndarray:
    """Rank-normalized split R-hat per dimension: the max of the bulk
    statistic (split R-hat of the rank-normalized draws) and the FOLDED
    statistic (same, on |x − median|, which measures scale/tail
    disagreement between chains). This is the R-hat modern Stan reports:
    a chain stuck at the right mean but the wrong variance passes the
    classic `split_rhat` (between-chain variance of MEANS is zero) and
    fails here. Want < 1.01."""
    x = np.asarray(samples, np.float64)
    bulk = split_rhat(_rank_normalize(x))
    folded = split_rhat(
        _rank_normalize(np.abs(x - np.median(x, axis=(0, 1))))
    )
    # ordinal ranks of an all-tied (constant) dimension would fabricate a
    # drift pattern; a dimension the chains never move in is perfectly
    # mixed (same contract as split_rhat's w == 0 guard)
    const = x.max(axis=(0, 1)) == x.min(axis=(0, 1))
    return np.where(const, 1.0, np.maximum(bulk, folded))


def tail_ess(samples) -> np.ndarray:
    """Tail effective sample size per dimension: the min of the Geyer
    ESSs of the 5%- and 95%-quantile indicator sequences I(x ≤ q)
    (Vehtari et al. 2021). Bulk `ess` can look healthy while the chains
    rarely exchange tail visits — this is the number that certifies
    credible-interval ENDPOINTS."""
    x = np.asarray(samples, np.float64)
    q05, q95 = np.quantile(x, [0.05, 0.95], axis=(0, 1))  # (n,) each
    e05 = ess((x <= q05).astype(np.float64))
    e95 = ess((x <= q95).astype(np.float64))
    return np.minimum(e05, e95)


def diagnose_chains(samples, rank: bool = True) -> ChainDiagnostics:
    """One-call summary: split R-hat, bulk ESS, pooled mean/std — and,
    with ``rank=True`` (default), the rank-normalized/folded R-hat and
    tail ESS (Vehtari et al. 2021) that catch variance mismatch and
    tail stickiness the classic pair can't."""
    x = np.asarray(samples, np.float64)
    pooled = x.reshape(-1, x.shape[-1])
    return ChainDiagnostics(
        rhat=split_rhat(x),
        ess=ess(x),
        mean=pooled.mean(axis=0),
        std=pooled.std(axis=0, ddof=1),
        rhat_rank=rank_normalized_rhat(x) if rank else None,
        ess_tail=tail_ess(x) if rank else None,
    )


# ---------------------------------------------------------------------------
# On-device (jitted XLA) implementations — identical math, jnp primitives.
# The split/center/variance steps are shared; f32 draws are accumulated in
# f32 after centering (the subtraction removes the catastrophic-cancellation
# risk; calibration tests bound the drift vs the f64 host oracle).
# ---------------------------------------------------------------------------


def _split_chains_j(x: jax.Array) -> jax.Array:
    d = (x.shape[0] // 2) * 2
    return jnp.concatenate([x[: d // 2], x[d // 2 : d]], axis=1)


@jax.jit
def split_rhat_device(samples: jax.Array) -> jax.Array:
    """`split_rhat` as one jitted XLA program over the on-device draws.

    samples: (draws, chains, n) device array; returns an (n,) device array
    — nothing else crosses the host boundary."""
    if samples.shape[0] < 4:
        raise ValueError("need at least 4 draws for split R-hat")
    x = _split_chains_j(samples)
    n_draw = x.shape[0]
    chain_mean = jnp.mean(x, axis=0)  # (chains, n)
    chain_var = jnp.var(x, axis=0, ddof=1)
    w = jnp.mean(chain_var, axis=0)
    b = n_draw * jnp.var(chain_mean, axis=0, ddof=1)
    var_plus = (n_draw - 1) / n_draw * w + b / n_draw
    out = jnp.sqrt(var_plus / w)
    return jnp.where(w > 0, out, 1.0)


def _chain_autocov_j(x: jax.Array) -> jax.Array:
    """Biased (1/N) autocovariance per (chain, dim) via batched rFFT.
    x: (draws, chains, n) -> (draws, chains, n). XLA's FFT wants the
    transform on the MINOR axis — transpose, batch-transform, transpose
    back (the two transposes are fused copies, cheap next to a host
    round-trip)."""
    n_draw = x.shape[0]
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    xt = jnp.moveaxis(xc, 0, -1)  # (chains, n, draws)
    f = jnp.fft.rfft(xt, n=size, axis=-1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=size, axis=-1)[..., :n_draw]
    return jnp.moveaxis(acov.real.astype(x.dtype), -1, 0) / n_draw


@jax.jit
def ess_device(samples: jax.Array) -> jax.Array:
    """`ess` as one jitted XLA program: batched-FFT autocovariance, the
    Stan rho formula, and Geyer's initial monotone sequence done with
    `lax.cummin` (monotone envelope) + a cumulative-AND mask (truncation
    at the first non-positive pair). Returns the (n,) device array."""
    if samples.shape[0] < 8:
        raise ValueError("need at least 8 draws for ess")
    x = _split_chains_j(samples)
    n_draw, n_chain, n_dim = x.shape
    acov = _chain_autocov_j(x)  # (draws, chains, n)
    chain_var = acov[0] * n_draw / (n_draw - 1.0)
    w = jnp.mean(chain_var, axis=0)
    var_plus = (n_draw - 1) / n_draw * w + n_draw * jnp.var(
        jnp.mean(x, axis=0), axis=0, ddof=1
    ) / n_draw
    var_plus = jnp.where(var_plus > 0, var_plus, 1.0)

    rho = 1.0 - (w[None, :] - jnp.mean(acov, axis=1)) / var_plus[None, :]
    rho = rho.at[0].set(1.0)

    n_pair = n_draw // 2
    pair = rho[0 : 2 * n_pair : 2] + rho[1 : 2 * n_pair : 2]  # (n_pair, n)
    pair = lax.cummin(pair, axis=0)
    positive = pair > 0.0
    # mask[t] = all pairs up to and including t are positive == t < first_bad
    mask = lax.associative_scan(jnp.logical_and, positive, axis=0)
    tau = -1.0 + 2.0 * jnp.sum(jnp.where(mask, pair, 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / np.log10(n_draw * n_chain + 10.0))
    return n_draw * n_chain / tau


def _rank_normalize_j(x: jax.Array) -> jax.Array:
    """`_rank_normalize` on device: two batched sorts (XLA lowers argsort
    to a key-value sort) + the normal quantile map."""
    d, c, n = x.shape
    flat = x.reshape(d * c, n)
    r = jnp.argsort(jnp.argsort(flat, axis=0), axis=0) + 1.0
    z = jax.scipy.special.ndtri(
        (r - 0.375) / (d * c + 0.25)
    ).astype(x.dtype)
    return z.reshape(d, c, n)


@jax.jit
def rank_normalized_rhat_device(samples: jax.Array) -> jax.Array:
    """`rank_normalized_rhat` as one jitted XLA program (two pooled sorts
    per statistic are the only non-elementwise ops). NOTE: the pooled
    sort runs over the CHAIN axis — under a chain-sharded mesh this
    gathers, unlike `split_rhat_device`; that is why the workflow's
    sharded path keeps it opt-in."""
    pooled = samples.reshape(-1, samples.shape[-1])
    pooled_med = jnp.median(pooled, axis=0)
    bulk = split_rhat_device(_rank_normalize_j(samples))
    folded = split_rhat_device(
        _rank_normalize_j(jnp.abs(samples - pooled_med))
    )
    # all-tied (constant) dimension: ordinal ranks would fabricate drift
    const = jnp.max(pooled, axis=0) == jnp.min(pooled, axis=0)
    return jnp.where(const, 1.0, jnp.maximum(bulk, folded))


@jax.jit
def tail_ess_device(samples: jax.Array) -> jax.Array:
    """`tail_ess` as one jitted XLA program: two pooled quantiles + the
    Geyer ESS of the two indicator sequences."""
    pooled = samples.reshape(-1, samples.shape[-1])
    q = jnp.quantile(
        pooled.astype(jnp.float32)
        if pooled.dtype == jnp.bfloat16 else pooled,
        jnp.asarray([0.05, 0.95]), axis=0,
    )
    e05 = ess_device((samples <= q[0]).astype(samples.dtype))
    e95 = ess_device((samples <= q[1]).astype(samples.dtype))
    return jnp.minimum(e05, e95)


@partial(jax.jit, static_argnames=("rank",))
def diagnose_chains_device(
    samples: jax.Array, rank: bool = False
) -> ChainDiagnostics:
    """`diagnose_chains` computed on device: one jitted program producing
    (n,)-sized arrays; fetch them whenever convenient (or never).

    ``rank=False`` by default (unlike the host oracle): the rank
    statistics need pooled sorts over the chain axis, which under a
    chain-sharded mesh force cross-device gathers — the lean default
    keeps the sharded pipeline's no-gather property. Pass ``rank=True``
    on single-chip (or gathered) draws for the full Vehtari et al. 2021
    panel."""
    pooled = samples.reshape(-1, samples.shape[-1])
    return ChainDiagnostics(
        rhat=split_rhat_device(samples),
        ess=ess_device(samples),
        mean=jnp.mean(pooled, axis=0),
        std=jnp.std(pooled, axis=0, ddof=1),
        rhat_rank=rank_normalized_rhat_device(samples) if rank else None,
        ess_tail=tail_ess_device(samples) if rank else None,
    )


def energy_bfmi(energies) -> np.ndarray:
    """Per-chain E-BFMI, the Bayesian fraction of missing information of
    the Hamiltonian transition (Betancourt 2016, "Diagnosing suboptimal
    cotangent disintegrations"; Stan's ``E-BFMI`` check):

        E-BFMI_c = sum_t (E_t - E_{t-1})^2 / sum_t (E_t - E_bar)^2

    where E_t are the per-draw Hamiltonians that `hmc_sample` /
    `chees_sample` / `nuts_sample` return as ``result.energies``
    ((draws, chains)). It compares how far momentum refreshment moves the
    energy (numerator) against the marginal energy spread the chain must
    traverse (denominator): values near 2 are an ideally mixing Gaussian
    energy spectrum; **below ~0.3** (Stan's warning bar) the sampler
    random-walks across energy levels — heavy-tailed or funnel-like
    targets — and no amount of extra draws fixes it (reparameterize, or
    hand the geometry a better mass via `chain_init_from_map` /
    ``adapt_mass``).

    Host-side numpy; `energy_bfmi_device` is the on-device twin.
    """
    e = np.asarray(energies, np.float64)
    if e.ndim != 2 or e.shape[0] < 3:
        raise ValueError(
            f"energies must be (draws >= 3, chains), got shape {e.shape}"
        )
    num = np.sum(np.diff(e, axis=0) ** 2, axis=0)
    den = np.sum((e - e.mean(axis=0)) ** 2, axis=0)
    return num / np.maximum(den, np.finfo(np.float64).tiny)


@jax.jit
def energy_bfmi_device(energies: jax.Array) -> jax.Array:
    """`energy_bfmi` as one jitted XLA program over the on-device
    (draws, chains) energies — two reductions, no host fetch."""
    e = energies
    num = jnp.sum(jnp.diff(e, axis=0) ** 2, axis=0)
    den = jnp.sum((e - jnp.mean(e, axis=0)) ** 2, axis=0)
    return num / jnp.maximum(den, jnp.finfo(e.dtype).tiny)


class PosteriorSummary(NamedTuple):
    """The Stan/ArviZ-style per-dimension posterior table — everything a
    practitioner reads off ``print(fit)`` before trusting a run. All
    fields (n,) host numpy; build with `posterior_summary`, render with
    `.table()`.

    mean/sd: pooled posterior moments
    mcse: Monte Carlo standard error of the mean, sd/sqrt(ess_bulk) —
        the "is my posterior mean itself converged?" number
    q5/median/q95: pooled quantiles (the 90% credible interval + center)
    ess_bulk: rank-normalized-bulk-equivalent ESS (Geyer, per
        `diagnose_chains`)
    ess_tail: min of the 5%/95% quantile-indicator ESSs
    rhat: rank-normalized split R-hat (max of bulk and folded — the
        Vehtari et al. 2021 recommendation; want < 1.01)
    """

    mean: np.ndarray
    sd: np.ndarray
    mcse: np.ndarray
    q5: np.ndarray
    median: np.ndarray
    q95: np.ndarray
    ess_bulk: np.ndarray
    ess_tail: np.ndarray
    rhat: np.ndarray

    def table(self, names=None, precision: int = 3) -> str:
        """Render the summary as the fixed-width table every Bayesian
        toolkit prints; ``names`` labels the rows (default x[i])."""
        n = self.mean.shape[0]
        if names is None:
            names = [f"x[{i}]" for i in range(n)]
        elif len(names) != n:
            raise ValueError(
                f"names has {len(names)} entries for {n} dimensions"
            )
        cols = ("mean", "sd", "mcse", "q5", "median", "q95",
                "ess_bulk", "ess_tail", "rhat")
        w = max(9, precision + 6)
        name_w = max(len(str(s)) for s in names) + 1
        out = [" " * name_w + "".join(f"{c:>{w}}" for c in cols)]
        for i in range(n):
            row = f"{str(names[i]):<{name_w}}"
            for c in cols:
                v = float(getattr(self, c if c != "mcse" else "mcse")[i])
                if c in ("ess_bulk", "ess_tail"):
                    row += f"{v:>{w}.0f}"
                elif c == "rhat":
                    row += f"{v:>{w}.3f}"
                else:
                    row += f"{v:>{w}.{precision}g}"
            out.append(row)
        return "\n".join(out)


def posterior_summary(samples) -> PosteriorSummary:
    """One-call posterior report over (draws, chains, n) samples from any
    of the library's samplers: pooled moments and quantiles, the MCSE of
    the mean, bulk/tail ESS, and the rank-normalized split R-hat — the
    numbers `diagnose_chains` computes, arranged as the standard
    publication-ready panel (plus MCSE, which no other entry point
    reports). Host-side numpy (analysis time); print
    ``summary.table(names)`` for the classic fixed-width readout.
    """
    x = np.asarray(samples, np.float64)
    if x.ndim != 3:
        raise ValueError(
            f"samples must be (draws, chains, n), got shape {x.shape}"
        )
    d = diagnose_chains(x, rank=True)
    pooled = x.reshape(-1, x.shape[-1])
    q5, med, q95 = np.percentile(pooled, [5.0, 50.0, 95.0], axis=0)
    ess_bulk = np.maximum(d.ess, 1.0)
    return PosteriorSummary(
        mean=d.mean,
        sd=d.std,
        mcse=d.std / np.sqrt(ess_bulk),
        q5=q5,
        median=med,
        q95=q95,
        ess_bulk=d.ess,
        ess_tail=d.ess_tail,
        rhat=d.rhat_rank,
    )
