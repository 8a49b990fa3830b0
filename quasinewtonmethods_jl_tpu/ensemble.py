"""Affine-invariant ensemble sampler (Goodman–Weare stretch move).

The GRADIENT-FREE member of the sampler family: where HMC/ChEES/NUTS/PT
spend one value_and_grad per leapfrog step and SVGD differentiates the
target, the stretch move (Goodman & Weare 2010; the "emcee" algorithm,
Foreman-Mackey et al. 2013) needs only logdensity VALUES — it covers
black-box, non-differentiable, or branchy targets none of the
gradient-based samplers can touch, and its affine invariance makes it
insensitive to linear correlation/scaling without any mass matrix.

Accelerator shape: the walker ensemble IS the batch axis — the red-black
half-ensemble scheme (Foreman-Mackey et al. §3) updates each half as one
fused batched step (one objective eval + elementwise accept per half), so
a W-walker step is exactly two vmapped logdensity sweeps; no per-walker
control flow, no scan over walkers. The only non-elementwise op is the
partner pick:

  * ``partner='gather'`` (default): independent uniform partners — the
    literature algorithm verbatim; one (W/2, n) row gather per half-step.
  * ``partner='shift'``: one shared random offset, partners
    x_other[(i+s) mod W/2] via `jnp.roll` — no gather at all (the
    CLAUDE.md per-lane-gather poison class). A valid MH kernel for each
    fixed offset (the partner distribution is state-independent and the
    per-walker acceptance ratio is unchanged); partners are correlated
    WITHIN a step, so mixing per step can be slightly slower — measure
    before preferring it.

Walkers are NOT independent chains — cross-walker R-hat from
`diagnose_chains` is still a useful stationarity signal (emcee practice),
but effective sample size should be discounted by the ensemble
autocorrelation; use many walkers (W ≳ 2n+2 per Goodman & Weare) and
long runs for tail quantities.

Contracts shared with the rest of the library: maximization convention
(``obj`` is the logdensity), resumable/checkpointable `EnsembleState`
with the fold_in key discipline (chunked == one long run, bitwise),
f32-safe under x64. Non-finite logdensities are treated as -inf (a
proposal outside the support is rejected; a walker STARTING outside the
support can still move in, the emcee convention).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_fn

__all__ = ["EnsembleResult", "EnsembleState", "ensemble_autocorr_time",
           "ensemble_sample", "ensemble_sample_from_state"]


class EnsembleState(NamedTuple):
    """Resumable stretch-move state (the sampler-state contract).

    Per-step RNG keys derive as fold_in(fold_in(key, phase), step), so
    resumption needs only the counters — no key stream is consumed by
    chunking (the HMCState discipline)."""

    x: jax.Array  # (walkers, n) current positions
    f: jax.Array  # (walkers,) logdensity at x (-inf outside support)
    key: jax.Array  # base PRNG key (typed)
    phase: jax.Array  # () int32: 0 = warmup, 1 = sampling
    step: jax.Array  # () int32 steps taken within the phase
    n_accept: jax.Array  # (walkers,) int32 accepted moves (sampling phase)


class EnsembleResult(NamedTuple):
    """samples: (n_samples, walkers, n) post-warmup draws (one per full
    red-black step); accept_rate: (walkers,) sampling-phase acceptance;
    final_x: (walkers, n); state: resume via `ensemble_sample_from_state`.
    """

    samples: jax.Array
    accept_rate: jax.Array
    final_x: jax.Array
    state: EnsembleState

    @property
    def n_walkers(self) -> int:
        return self.final_x.shape[0]


def _finite_or_neg_inf(f):
    return jnp.where(jnp.isfinite(f), f, -jnp.inf)


def _half_step(f_b, x_upd, f_upd, x_other, key, a, partner):
    """Stretch-move update of one half-ensemble against the other.

    y = x_j + z (x_i - x_j), z ~ g(z) ∝ 1/√z on [1/a, a] (inverse-CDF:
    z = ((a-1)u + 1)²/a), accepted with log-prob (n-1)·log z + f(y) - f(x).
    """
    w2, n = x_upd.shape
    dtype = x_upd.dtype
    k_part, k_z, k_u = jax.random.split(key, 3)
    if partner == "gather":
        idx = jax.random.randint(k_part, (w2,), 0, x_other.shape[0])
        xj = jnp.take(x_other, idx, axis=0)
    else:  # 'shift'
        s = jax.random.randint(k_part, (), 0, x_other.shape[0])
        xj = jnp.roll(x_other, s, axis=0)
    u = jax.random.uniform(k_z, (w2,), dtype)
    a_ = jnp.asarray(a, dtype)
    z = ((a_ - 1.0) * u + 1.0) ** 2 / a_
    y = xj + z[:, None] * (x_upd - xj)
    fy = _finite_or_neg_inf(f_b(y))
    log_acc = (n - 1) * jnp.log(z) + fy - f_upd
    # -inf - -inf = NaN: a walker outside the support proposing outside
    # the support must reject, and NaN < anything is False either way
    accept = jnp.log(jax.random.uniform(k_u, (w2,), dtype)) < log_acc
    x_new = jnp.where(accept[:, None], y, x_upd)
    f_new = jnp.where(accept, fy, f_upd)
    return x_new, f_new, accept


def _full_step(f_b, x, f, key, a, partner):
    """One red-black sweep: update half A against B, then B against the
    UPDATED A (the sequential scheme that keeps detailed balance with
    whole-half vectorization, Foreman-Mackey et al. §3)."""
    w2 = x.shape[0] // 2
    kA, kB = jax.random.split(key)
    xA, fA = x[:w2], f[:w2]
    xB, fB = x[w2:], f[w2:]
    xA, fA, accA = _half_step(f_b, xA, fA, xB, kA, a, partner)
    xB, fB, accB = _half_step(f_b, xB, fB, xA, kB, a, partner)
    return (
        jnp.concatenate([xA, xB]),
        jnp.concatenate([fA, fB]),
        jnp.concatenate([accA, accB]),
    )


def _run_phase(f_b, state: EnsembleState, n_steps, phase, a, partner,
               collect: bool):
    """Scan ``n_steps`` full steps in the given phase, optionally
    collecting one draw per step."""

    def body(carry, step_idx):
        x, f, n_acc = carry
        k = jax.random.fold_in(
            jax.random.fold_in(state.key, phase), step_idx
        )
        x, f, acc = _full_step(f_b, x, f, k, a, partner)
        n_acc = n_acc + acc.astype(jnp.int32)
        out = x if collect else None
        return (x, f, n_acc), out

    steps = state.step + jnp.arange(n_steps, dtype=jnp.int32)
    (x, f, n_acc), draws = lax.scan(
        body, (state.x, state.f, state.n_accept), steps
    )
    new_state = state._replace(
        x=x, f=f, step=state.step + jnp.int32(n_steps), n_accept=n_acc
    )
    return new_state, draws


@partial(
    jax.jit,
    static_argnames=("obj", "n_samples", "n_warmup", "a", "partner",
                     "value_and_grad_fn"),
)
def _ensemble_run_jit(obj, state, n_samples, n_warmup, a, partner,
                      value_and_grad_fn):
    f_one = as_value_fn(obj, value_and_grad_fn)
    f_b = jax.vmap(f_one)

    # (re-)evaluate cached logdensities only where unset (fresh start)
    f0 = jnp.where(
        jnp.isnan(state.f), _finite_or_neg_inf(f_b(state.x)), state.f
    )
    state = state._replace(f=f0)

    # remaining warmup (phase 0), then sampling (phase 1); phase
    # transitions reset the step counter so resumed key streams align
    in_warm = state.phase == 0
    warm_state = state
    if n_warmup > 0:
        # a resumed sampling-phase state skips warmup entirely (the
        # phase is a traced value, hence the cond, not Python if)
        warm_state = lax.cond(
            in_warm,
            lambda st: _run_phase(
                f_b, st, n_warmup, 0, a, partner, collect=False
            )[0],
            lambda st: st,
            warm_state,
        )
    draws = None
    if n_samples > 0:
        # the warmup -> sampling transition happens HERE, not after the
        # warmup block: a run that ends with n_samples == 0 stays in the
        # warmup phase so chunked warmup resumes bitwise
        samp_state = warm_state._replace(
            phase=jnp.int32(1),
            step=jnp.where(in_warm, jnp.int32(0), state.step),
            # acceptance is a sampling-phase statistic
            n_accept=jnp.where(
                in_warm, jnp.zeros_like(state.n_accept), state.n_accept
            ),
        )
        samp_state, draws = _run_phase(
            f_b, samp_state, n_samples, 1, a, partner, collect=True
        )
    else:
        samp_state = warm_state
    if draws is None:
        draws = jnp.zeros((0,) + state.x.shape, state.x.dtype)
    accept_rate = samp_state.n_accept / jnp.maximum(samp_state.step, 1)
    return EnsembleResult(
        samples=draws,
        accept_rate=accept_rate.astype(state.x.dtype),
        final_x=samp_state.x,
        state=samp_state,
    )


def _validate(x0s, a, partner, n_samples, n_warmup, mass):
    if mass is not None:
        raise ValueError(
            "ensemble_sample takes no mass matrix — affine invariance IS "
            "the preconditioning (linear correlation/scaling cancels in "
            "the stretch move); drop mass= (mass_form/init handoffs do "
            "not apply to sampler='ensemble')"
        )
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (walkers, n), got shape {x0s.shape}")
    w = x0s.shape[0]
    if w < 4 or w % 2 != 0:
        raise ValueError(
            f"need an even walker count >= 4 (red-black halves), got {w}; "
            "Goodman & Weare recommend >= 2n+2 walkers"
        )
    if not a > 1.0:
        raise ValueError(f"stretch scale a must be > 1, got {a}")
    if partner not in ("gather", "shift"):
        raise ValueError(
            f"partner must be 'gather' or 'shift', got {partner!r}"
        )
    if n_samples < 0 or n_warmup < 0:
        raise ValueError("n_samples and n_warmup must be >= 0")


def ensemble_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,
    n_samples: int = 1000,
    n_warmup: int = 500,
    a: float = 2.0,
    partner: str = "gather",
    value_and_grad_fn: Optional[Callable] = None,
    mass=None,
) -> EnsembleResult:
    """Sample with the affine-invariant stretch move — NO gradients.

    ``x0s`` is the (walkers, n) initial ensemble (walkers even, >= 4;
    >= 2n+2 recommended — e.g. a jittered MAP fleet). ``a`` is the
    stretch scale (2.0 is the universal default; larger = bolder moves,
    lower acceptance — tune toward ~0.2-0.5 acceptance). One draw is
    recorded per full red-black step; thin on the result if desired.

    Use this sampler when the target's gradient is unavailable,
    unreliable, or expensive (black-box simulators, branchy likelihoods,
    non-differentiable priors); for smooth targets the HMC family's
    gradient-guided proposals mix far better per evaluation.

    ``value_and_grad_fn`` is accepted for API uniformity (its value half
    is used only if ``obj`` provides no value-only form).
    """
    x0s = jnp.asarray(x0s)
    _validate(x0s, a, partner, n_samples, n_warmup, mass)
    if jnp.issubdtype(key.dtype, jnp.uint32):
        key = jax.random.wrap_key_data(key)
    state = EnsembleState(
        x=x0s,
        f=jnp.full((x0s.shape[0],), jnp.nan, x0s.dtype),
        key=key,
        phase=jnp.int32(0),
        step=jnp.int32(0),
        n_accept=jnp.zeros((x0s.shape[0],), jnp.int32),
    )
    return _ensemble_run_jit(
        obj, state, int(n_samples), int(n_warmup), float(a), partner,
        value_and_grad_fn,
    )


def ensemble_sample_from_state(
    obj,
    state: EnsembleState,
    n_samples: int = 0,
    n_warmup: int = 0,
    a: float = 2.0,
    partner: str = "gather",
    value_and_grad_fn: Optional[Callable] = None,
) -> EnsembleResult:
    """Continue (or checkpoint-chunk) a stretch-move run.

    Chunked == one long run, bitwise: per-step keys derive from the
    carried (key, phase, step) counters, so a resumed run replays the
    exact key stream the uninterrupted run would have used. Pass the
    same ``a``/``partner`` as the original run. ``n_warmup`` only
    applies while the state is still in the warmup phase (a resumed
    sampling-phase state ignores it)."""
    _validate(state.x, a, partner, n_samples, n_warmup, mass=None)
    return _ensemble_run_jit(
        obj, state, int(n_samples), int(n_warmup), float(a), partner,
        value_and_grad_fn,
    )


def ensemble_autocorr_time(samples, c: float = 5.0):
    """Integrated autocorrelation time per dimension (the emcee
    diagnostic — Goodman & Weare's recommended convergence measure,
    with Sokal's adaptive window as implemented in emcee).

    Walkers are NOT independent chains, so `diagnose_chains`' split
    R-hat/ESS (which assume independence) OVERSTATE the information in
    a stretch-move run. The ensemble convention instead averages each
    walker's normalized autocorrelation function and reports

        τ(M) = 1 + 2 Σ_{t=1..M} ρ_t,   M = min window with M >= c·τ(M).

    Effective samples ≈ draws·walkers / τ. Returns ``(tau, reliable)``,
    both (n,): ``reliable`` is emcee's rule of thumb
    draws > 50·τ — below it the τ estimate itself has not converged
    (treat it as a lower bound and run longer).

    Host-side numpy (an analysis-time diagnostic, not a hot path);
    accepts the (draws, walkers, n) array from `EnsembleResult.samples`.
    """
    import numpy as np

    x = np.asarray(samples, np.float64)
    if x.ndim != 3 or x.shape[0] < 8:
        raise ValueError(
            "samples must be (draws >= 8, walkers, n), got shape "
            f"{x.shape}"
        )
    n_draw = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n_draw].real
    # average the per-walker autocorrelation functions (emcee), guarding
    # frozen walkers (zero variance -> zero autocov contributions)
    acov = acov.mean(axis=1)  # (draws, n)
    denom = np.where(acov[0] > 0.0, acov[0], 1.0)
    rho = acov / denom[None, :]
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0  # τ(M) for every window M
    ts = np.arange(n_draw)[:, None]
    crossed = ts >= c * taus
    # first window satisfying Sokal's condition; none -> the full length
    has = crossed.any(axis=0)
    M = np.where(has, crossed.argmax(axis=0), n_draw - 1)
    tau = np.maximum(taus[M, np.arange(x.shape[-1])], 1.0)
    reliable = has & (n_draw > 50.0 * tau)
    return tau, reliable
