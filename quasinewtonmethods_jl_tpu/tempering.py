"""Replica-exchange (parallel tempering) HMC over fleet axes.

The reference is the inner MAP engine for MCMC initialization
(/root/reference/README.md:14); this framework already covers the
unimodal posterior workflow (MAP fleet → mass handoff → HMC/ChEES/NUTS).
What that workflow cannot do is sample a genuinely MULTIMODAL posterior:
`multistart` finds the modes, but a single-temperature sampler started in
one basin essentially never crosses to another, so mode weights come out
wrong no matter how long it runs. Replica exchange is the standard fix —
and it is a *perfect* Accelerator shape:

  * the temperature ladder × chain fleet is one dense (K, C, n) batch —
    every replica advances through the SAME leapfrog program in lockstep
    (tempered gradient = beta_k · ∇f, a broadcast scale, so there is no
    per-temperature control flow at all);
  * the exchange move is an even–odd sweep over adjacent temperature
    pairs — a vectorized masked shift along the small leading axis, no
    gathers, no per-chain branching;
  * every chain column swaps independently, so C chains give C
    independent tempering ladders — fleet-scale replica exchange for the
    price of one batched HMC step.

Design choices (accelerator-first, same contracts as the other samplers):

  * one base HMC step per replica per round (velocity Verlet, shared
    static trip count `n_leapfrog`), per-TEMPERATURE step size adapted by
    dual averaging on the fleet-mean acceptance of that temperature (hot
    replicas want bigger steps; chains within a temperature share the
    geometry);
  * exchange every `swap_every` rounds, alternating even/odd adjacent
    pairs by GLOBAL step parity (so chunked resume replays the long
    run's exact sweep schedule);
  * optional in-warmup LADDER adaptation (`adapt_ladder=True`):
    anchored swap-rate equalization — the log-spacings of the ladder
    redistribute multiplicatively toward equal per-pair swap acceptance
    (pairs accepting above the ladder mean widen, below-mean pairs
    shrink), with both endpoints pinned (beta_0 = 1, beta_{K-1} =
    beta_min) and a decaying adaptation rate (Vousden, Farr & Mandel
    2016 style, re-anchored). A (K-1,) elementwise update per sweep —
    free on the device. Frozen at sampling; the adapted ladder rides in
    the state, so resume continues it;
  * the cached per-replica logdensity is stored UNTEMPERED — the HMC
    ratio multiplies by beta on the fly and the swap ratio
    (beta_i − beta_j)(f_j − f_i) reads it directly; a swap never
    re-evaluates the objective;
  * samples are the COLD (beta = 1) row only; the hot rows are the
    mixing machinery. Swap acceptance per adjacent pair is returned —
    the standard ladder-health diagnostic (aim ~0.2–0.6; a pair near 0
    means the ladder has a gap there).

All state lives in `PTState` (NamedTuple of arrays) and
`pt_sample_from_state` resumes chunk-for-chunk identically to one long
run, exactly like the other samplers' resume contracts.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .api import as_value_and_grad, as_value_fn
from .sampling import (
    _MASS_ADAPT_MIN_CHAINS,
    _apply_mass,
    _da_update,
    _draw_momentum,
    _kinetic,
    _mass_setup,
)

__all__ = ["PTState", "PTResult", "pt_sample", "pt_sample_from_state",
           "geometric_ladder"]

# ladder adaptation: EMA weight for per-pair swap acceptance, base rate
# and decay scale (in swap sweeps) for the multiplicative spacing update
_LADDER_EMA = 0.2
_LADDER_KAPPA0 = 0.4
_LADDER_T0 = 50.0
# adapt_mass: per-rung fleet-variance EMA weight
_MASS_EMA = 0.15


class PTState(NamedTuple):
    """Resumable replica-exchange state (see HMCState for the key-stream
    discipline: per-step keys are fold_in(fold_in(key, phase), step), so
    chunking consumes no keys and needs only the counters)."""

    x: jax.Array  # (K, C, n) replica positions (row 0 = cold)
    f: jax.Array  # (K, C) UNTEMPERED logdensity at x
    betas: jax.Array  # (K,) inverse temperatures, betas[0] == 1
    log_eps: jax.Array  # (K,) per-temperature DA iterate
    log_eps_bar: jax.Array  # (K,) averaged iterate (the frozen eps)
    h_bar: jax.Array  # (K,) DA error accumulator
    t_da: jax.Array  # () DA step count
    mu: jax.Array  # () DA shrink target log(10 * eps0)
    key: jax.Array  # the run's base PRNG key
    i_warm: jax.Array  # () int32 warmup rounds completed
    i_samp: jax.Array  # () int32 sampling rounds completed
    swap_acc: jax.Array  # (K-1,) summed swap accept probabilities
    swap_att: jax.Array  # (K-1,) swap attempts (per adjacent pair)
    swap_ema: jax.Array  # (K-1,) per-pair acceptance EMA (ladder adapt)
    tag: jax.Array  # (K, C) int32 replica-flow tag (0 unset, 1 last
    # visited cold end, 2 last visited hot end) — rides the swaps
    round_trips: jax.Array  # (C,) int32 completed hot→cold transits
    var_ema: jax.Array  # (K, n) per-rung fleet-variance EMA (the
    # adapt_mass=True metric; all-ones and unused otherwise)


class PTResult(NamedTuple):
    """samples: (n_samples, C, n) cold-chain draws.
    accept_rate: (K,) fleet-mean HMC acceptance per temperature.
    swap_rate: (K-1,) mean exchange acceptance per adjacent pair
    (cumulative over the whole run incl. warmup — ladder health).
    step_size: (K,) adapted per-temperature leapfrog step.
    betas: (K,) the ladder actually sampled with (adapted if
    adapt_ladder, else the input ladder).
    round_trips: (C,) per-chain completed replica round trips (a state
    reaching the hot end and returning to the cold row) over the whole
    run — the DEEP mixing diagnostic: healthy swap_rate with ~zero
    round trips means replicas ping-pong locally and the ladder is too
    long or too weakly coupled for states to actually traverse it.
    energies: (n_samples, C) cold-row Hamiltonians at each HMC
    transition's selected point (beta = 1, so this is the true target's
    energy — feed `diagnostics.energy_bfmi`; recorded pre-exchange).
    divergences: (C,) int32 cold-row divergent-transition counts over
    sampling (the hmc_sample convention).
    final_x: (K, C, n) last replica positions.
    state: PTState — resume via `pt_sample_from_state`."""

    samples: jax.Array
    accept_rate: jax.Array
    swap_rate: jax.Array
    step_size: jax.Array
    betas: jax.Array
    round_trips: jax.Array
    energies: jax.Array
    divergences: jax.Array
    final_x: jax.Array
    state: PTState


def geometric_ladder(n_temps: int, beta_min: float = 0.05,
                     dtype=jnp.float32) -> jax.Array:
    """The standard geometric inverse-temperature ladder
    1 = beta_0 > ... > beta_{K-1} = beta_min. Geometric spacing gives
    roughly constant swap acceptance between neighbours on
    Gaussian-like targets (constant energy-variance ratio)."""
    if n_temps < 1:
        raise ValueError("n_temps must be >= 1")
    if n_temps == 1:
        return jnp.ones((1,), dtype)
    if not (0.0 < beta_min < 1.0):
        raise ValueError("beta_min must be in (0, 1)")
    return jnp.geomspace(1.0, beta_min, n_temps).astype(dtype)


def _ladder_adapt(betas, swap_ema, sweep_idx, dtype):
    """Anchored swap-rate equalization: redistribute the ladder's
    log-spacings multiplicatively toward equal per-pair acceptance.
    Endpoints stay pinned (total log-span conserved), so this reshapes
    the ladder rather than stretching it."""
    s = jnp.log(betas[:-1]) - jnp.log(betas[1:])  # (K-1,) > 0 spacings
    kappa = _LADDER_KAPPA0 / (1.0 + sweep_idx.astype(dtype) / _LADDER_T0)
    # above-average pairs widen, below-average shrink
    s_new = s * jnp.exp(kappa * (swap_ema - jnp.mean(swap_ema)))
    s_new = s_new * (jnp.sum(s) / jnp.sum(s_new))  # conserve the span
    log_b = jnp.concatenate(
        [jnp.zeros((1,), dtype), -jnp.cumsum(s_new)]
    )
    return jnp.exp(log_b)


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_samples", "n_warmup", "n_leapfrog",
        "swap_every", "target_accept", "adapt_ladder", "adapt_mass",
        "i_warm0", "i_samp0",
    ),
)
def _pt_core(
    obj, state: PTState, mass, n_samples, n_warmup, n_leapfrog,
    swap_every, target_accept, adapt_ladder, adapt_mass,
    value_and_grad_fn, i_warm0, i_samp0,
) -> PTResult:
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f_flat = jax.vmap(as_value_fn(obj, value_and_grad_fn))
    grad_flat = jax.vmap(lambda xx: vag(xx)[1])

    K, C, n = state.x.shape
    dtype = state.x.dtype

    mass_b, chol_u = _mass_setup(mass, n, dtype)

    def f_all(x):  # (K, C, n) -> (K, C), untempered
        return f_flat(x.reshape(K * C, n)).reshape(K, C)

    def grad_all(x):  # (K, C, n) -> (K, C, n), untempered
        return grad_flat(x.reshape(K * C, n)).reshape(K, C, n)

    # metric ops: with adapt_mass the metric is a PER-TEMPERATURE (K, n)
    # diagonal (each rung's stationary distribution has its own scale —
    # beta_k spreads positions by 1/sqrt(beta_k) elementwise and more on
    # multimodal targets); otherwise the shared static preconditioner.
    # The exchange move is mass-independent (its ratio reads only f),
    # so per-row metrics leave swap validity untouched.
    if adapt_mass:
        def draw_p(k, m):
            z = jax.random.normal(k, (K, C, n), dtype)
            return z / jnp.sqrt(m)[:, None, :]

        def kin(p, m):
            return 0.5 * jnp.sum(m[:, None, :] * p * p, axis=2)

        def vel(p, m):
            return m[:, None, :] * p
    else:
        def draw_p(k, m):
            return _draw_momentum(k, K * C, n, dtype, mass_b,
                                  chol_u).reshape(K, C, n)

        def kin(p, m):
            return _kinetic(p.reshape(K * C, n), mass_b).reshape(K, C)

        def vel(p, m):
            return _apply_mass(mass_b, p.reshape(K * C, n)).reshape(K, C, n)

    def leapfrog(x, p, eps, betas, m):
        """Velocity Verlet on the tempered targets: dp/dt = +beta·∇f
        (ascent form, matching _leapfrog). eps: (K,) per temperature.
        The gradient rides the carry — exactly ONE evaluation per step
        (+1 to seed), since step i's closing half-kick and step i+1's
        opening half-kick share the same position."""
        e = eps[:, None, None]
        b = betas[:, None, None]

        def body(_, carry):
            x, p, g = carry
            p = p + 0.5 * e * (b * g)
            x = x + e * vel(p, m)
            g = grad_all(x)
            p = p + 0.5 * e * (b * g)
            return x, p, g

        x, p, _ = lax.fori_loop(0, n_leapfrog, body, (x, p, grad_all(x)))
        return x, p

    def hmc_move(x, f, eps, betas, m, k):
        """One tempered HMC step on every replica. Returns the new
        (x, f) and the (K, C) acceptance probabilities."""
        k1, k2 = jax.random.split(k)
        p = draw_p(k1, m)
        kin0 = kin(p, m)
        x_new, p_new = leapfrog(x, p, eps, betas, m)
        f_new = f_all(x_new)
        kin1 = kin(p_new, m)
        log_ratio = betas[:, None] * (f_new - f) - (kin1 - kin0)
        a_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        a_prob = jnp.where(jnp.isfinite(a_prob), a_prob, 0.0)
        u = jax.random.uniform(k2, (K, C), dtype)
        acc = u < a_prob
        x = jnp.where(acc[:, :, None], x_new, x)
        f = jnp.where(acc, f_new, f)
        # cold-row observability (the row whose draws are the samples;
        # beta = 1, so this is the true target's Hamiltonian at the
        # transition's selected point — see hmc_step in sampling.py)
        e_cold = jnp.where(
            acc[0], kin1[0] - f_new[0], kin0[0] - f[0]
        )
        div_cold = ~jnp.isfinite(log_ratio[0]) | (log_ratio[0] < -1000.0)
        return x, f, a_prob, e_cold, div_cold

    def swap_move(x, f, tag, trips, betas, i, k):
        """Even–odd exchange sweep over adjacent temperature pairs.
        Pair p = (p, p+1) is active when p % 2 == i % 2; active pairs
        are disjoint, so the whole sweep is one masked shift along the
        K axis. The replica-flow ``tag`` rides the same shift; after
        the sweep, a hot-tagged state landing on the cold row completes
        a round trip. Returns updated (x, f, tag, trips) and the
        (K-1,) per-pair accept probabilities + attempt mask."""
        if K == 1:
            z = jnp.zeros((0,), dtype)
            return x, f, tag, trips, z, z
        parity = (i % 2).astype(jnp.int32)
        pair_on = (jnp.arange(K - 1, dtype=jnp.int32) % 2) == parity  # (K-1,)
        # swap ratio: exp((beta_p - beta_{p+1}) (f_{p+1} - f_p)) per chain
        log_a = (betas[:-1] - betas[1:])[:, None] * (f[1:] - f[:-1])
        a_prob = jnp.exp(jnp.minimum(log_a, 0.0))
        a_prob = jnp.where(jnp.isfinite(a_prob), a_prob, 0.0)
        u = jax.random.uniform(k, (K - 1, C), dtype)
        acc = (u < a_prob) & pair_on[:, None]  # (K-1, C)
        zrow = jnp.zeros((1, C), bool)
        take_up = jnp.concatenate([acc, zrow], 0)  # row p takes row p+1
        take_dn = jnp.concatenate([zrow, acc], 0)  # row p takes row p-1
        x_up = jnp.roll(x, -1, axis=0)
        x_dn = jnp.roll(x, 1, axis=0)
        x = jnp.where(take_up[:, :, None], x_up,
                      jnp.where(take_dn[:, :, None], x_dn, x))
        f_up = jnp.roll(f, -1, axis=0)
        f_dn = jnp.roll(f, 1, axis=0)
        f = jnp.where(take_up, f_up, jnp.where(take_dn, f_dn, f))
        tag = jnp.where(take_up, jnp.roll(tag, -1, axis=0),
                        jnp.where(take_dn, jnp.roll(tag, 1, axis=0), tag))
        # flow bookkeeping at the ends: a hot-tagged state on the cold
        # row completes a round trip (and re-arms as cold-tagged); any
        # state on the hot row arms as hot-tagged
        trips = trips + (tag[0] == 2).astype(jnp.int32)
        tag = tag.at[0].set(1)
        tag = tag.at[K - 1].set(2)
        pair_acc = jnp.sum(jnp.where(pair_on[:, None], a_prob, 0.0), axis=1)
        pair_att = jnp.where(pair_on, jnp.asarray(C, dtype), 0.0)
        return x, f, tag, trips, pair_acc, pair_att

    def round_(x, f, tag, trips, eps, betas, m, i, k, swap_acc, swap_att,
               swap_ema):
        """One HMC move on every replica + (on schedule) an exchange
        sweep. ``i`` is the GLOBAL round index — the sweep parity and
        swap cadence derive from it so chunked runs replay exactly."""
        k_hmc, k_swap = jax.random.split(k)
        x, f, a_prob, e_cold, div_cold = hmc_move(x, f, eps, betas, m,
                                                  k_hmc)
        do_swap = (i % swap_every) == 0
        x_s, f_s, tag_s, trips_s, pair_acc, pair_att = swap_move(
            x, f, tag, trips, betas, i // swap_every, k_swap
        )
        x = jnp.where(do_swap, x_s, x)
        f = jnp.where(do_swap, f_s, f)
        tag = jnp.where(do_swap, tag_s, tag)
        trips = jnp.where(do_swap, trips_s, trips)
        swap_acc = swap_acc + jnp.where(do_swap, pair_acc, 0.0)
        swap_att = swap_att + jnp.where(do_swap, pair_att, 0.0)
        if K > 1:
            # per-pair acceptance EMA, updated only on attempted pairs
            rate = pair_acc / jnp.maximum(pair_att, 1.0)
            upd = (do_swap & (pair_att > 0)).astype(dtype)
            swap_ema = swap_ema + upd * _LADDER_EMA * (rate - swap_ema)
        return (x, f, tag, trips, a_prob, swap_acc, swap_att, swap_ema,
                e_cold, div_cold)

    # first-ever call: the cached logdensity is not populated yet
    f0 = f_all(state.x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    k_warm = jax.random.fold_in(state.key, 0)
    k_samp = jax.random.fold_in(state.key, 1)

    # ---- warmup: per-temperature dual averaging (+ ladder adaptation) ----
    def warm_body(carry, i):
        (x, f, tag, trips, betas, var_ema, log_eps, log_eps_bar, h_bar,
         t, s_acc, s_att, s_ema) = carry
        k = jax.random.fold_in(k_warm, i)
        x, f, tag, trips, a_prob, s_acc, s_att, s_ema, _e, _d = round_(
            x, f, tag, trips, jnp.exp(log_eps), betas, var_ema, i, k,
            s_acc, s_att, s_ema
        )
        if adapt_mass and C >= _MASS_ADAPT_MIN_CHAINS:
            # per-rung across-chain variance EMA (each rung's stationary
            # spread differs); floored against collapsed fleets
            v = jnp.maximum(jnp.var(x, axis=1), 1e-10)
            var_ema = (1.0 - _MASS_EMA) * var_ema + _MASS_EMA * v
        if adapt_ladder and K > 2:
            betas = jnp.where(
                (i % swap_every) == 0,
                _ladder_adapt(betas, s_ema, i // swap_every, dtype),
                betas,
            )
        acc_err = target_accept - jnp.mean(a_prob, axis=1)  # (K,)
        log_eps, log_eps_bar, h_bar, t = _da_update(
            h_bar, log_eps_bar, t, acc_err, state.mu
        )
        return (x, f, tag, trips, betas, var_ema, log_eps, log_eps_bar,
                h_bar, t, s_acc, s_att, s_ema), None

    carry_w = (state.x, f0, state.tag, state.round_trips, state.betas,
               state.var_ema, state.log_eps, state.log_eps_bar,
               state.h_bar, state.t_da, state.swap_acc, state.swap_att,
               state.swap_ema)
    if n_warmup > 0:
        carry_w, _ = lax.scan(
            warm_body, carry_w, i_warm0 + jnp.arange(n_warmup)
        )
    (x, f, tag, trips, betas, var_ema, log_eps, log_eps_bar, h_bar, t_da,
     swap_acc, swap_att, swap_ema) = carry_w
    eps_final = jnp.exp(log_eps_bar)

    # ---- sampling at the adapted steps on the (frozen) final ladder ----
    def sample_body(carry, j):
        x, f, tag, trips, s_acc, s_att, s_ema = carry
        k = jax.random.fold_in(k_samp, j)
        x, f, tag, trips, a_prob, s_acc, s_att, s_ema, e, dv = round_(
            x, f, tag, trips, eps_final, betas, var_ema, j, k, s_acc,
            s_att, s_ema
        )
        return (x, f, tag, trips, s_acc, s_att, s_ema), (x[0], a_prob, e, dv)

    ((x, f, tag, trips, swap_acc, swap_att, swap_ema),
     (samples, a_probs, energies, divs)) = lax.scan(
        sample_body, (x, f, tag, trips, swap_acc, swap_att, swap_ema),
        i_samp0 + jnp.arange(n_samples),
    )

    out_state = PTState(
        x=x, f=f, betas=betas, log_eps=log_eps, log_eps_bar=log_eps_bar,
        h_bar=h_bar, t_da=t_da, mu=state.mu, key=state.key,
        i_warm=jnp.asarray(i_warm0 + n_warmup, jnp.int32),
        i_samp=jnp.asarray(i_samp0 + n_samples, jnp.int32),
        swap_acc=swap_acc, swap_att=swap_att, swap_ema=swap_ema,
        tag=tag, round_trips=trips, var_ema=var_ema,
    )
    accept_rate = (
        jnp.mean(a_probs, axis=(0, 2)) if n_samples > 0
        else jnp.zeros((K,), dtype)
    )
    swap_rate = swap_acc / jnp.maximum(swap_att, 1.0)
    return PTResult(
        samples=samples,
        accept_rate=accept_rate,
        swap_rate=swap_rate,
        step_size=eps_final,
        betas=betas,
        round_trips=trips,
        energies=energies,
        divergences=jnp.sum(divs.astype(jnp.int32), axis=0),
        final_x=x,
        state=out_state,
    )


def pt_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,  # (chains, n) or (K, chains, n) initial positions
    mass: Optional[jax.Array] = None,
    betas: Optional[jax.Array] = None,
    n_temps: int = 8,
    beta_min: float = 0.05,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    swap_every: int = 1,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_ladder: bool = False,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> PTResult:
    """Replica-exchange (parallel tempering) HMC for multimodal targets.

    Runs `n_temps` tempered copies of the chain fleet — replica k targets
    beta_k·logdensity — with even–odd exchange sweeps between adjacent
    temperatures every `swap_every` rounds. Hot replicas cross energy
    barriers; exchanges transport their states down to the cold row,
    whose draws are returned. The whole ladder advances as ONE lockstep
    (K·C)-batched HMC program (the tempered gradient is a broadcast
    scale), and the exchange sweep is a masked shift along the small
    temperature axis — no gathers, no per-chain control flow.

    ``x0s``: (chains, n) starts every temperature from the same fleet
    (e.g. `multistart`/MAP modes), or (K, chains, n) for per-temperature
    starts. ``betas``: explicit ladder (betas[0] must be 1.0), default
    `geometric_ladder(n_temps, beta_min)`. ``mass``: the usual shared
    preconditioner (dense / diag / LowRankMass / None).

    Warmup adapts a PER-TEMPERATURE step size by dual averaging on that
    temperature's fleet-mean acceptance. With ``adapt_ladder=True``
    (K > 2) warmup also reshapes the ladder itself: log-spacings
    redistribute multiplicatively toward equal per-pair swap acceptance
    (endpoints pinned at 1 and beta_min, span conserved, decaying rate)
    — the fix when a default geometric ladder leaves a low-acceptance
    gap. The adapted ladder freezes at sampling and is reported as
    `result.betas`. `result.swap_rate` (per adjacent pair, cumulative)
    is the ladder-health diagnostic: values near 0 mean a gap (adapt,
    add temperatures, or raise beta_min); well-tuned ladders sit
    ~0.2–0.6.

    ``adapt_mass=True`` adapts a PER-RUNG (K, n) diagonal metric during
    warmup (across-chain variance EMA per temperature — each rung's
    stationary spread differs; exchange validity is untouched, the swap
    ratio reads only cached logdensities). The standalone answer for
    scale-heterogeneous targets when there is no MAP-fleet mass to hand
    over; mutually exclusive with ``mass=``; silently keeps the identity
    below 8 chains (the fleet variance means nothing there — same policy
    as ChEES).

    Gradient cost per draw: K·n_leapfrog per-chain gradient evaluations —
    the standard tempering premium. Use the smallest K whose swap rates
    stay healthy.
    """
    if adapt_mass and mass is not None:
        raise ValueError(
            "adapt_mass=True adapts its own per-rung diagonal metric; "
            "drop mass= (or pass the mass and keep adapt_mass=False)"
        )
    if swap_every < 1:
        raise ValueError(f"swap_every must be >= 1, got {swap_every}")
    x0s = jnp.asarray(x0s)
    if betas is not None:
        # validate on the host copy (one conversion, no repeated syncs)
        b_host = np.asarray(betas, dtype=np.float64)
        if b_host.ndim != 1 or b_host.shape[0] < 1:
            raise ValueError("betas must be a 1-D ladder")
        # beta_0 = 1 is the samples contract (row 0 IS the posterior);
        # beta <= 0 is an improper target (and breaks ladder adaptation's
        # log-spacings); non-monotone ladders break the adjacent-pair
        # exchange semantics
        if b_host[0] != 1.0:
            raise ValueError("betas[0] must be exactly 1.0 (the cold chain)")
        if b_host.shape[0] > 1 and (
            np.any(b_host[1:] <= 0.0) or np.any(np.diff(b_host) >= 0.0)
        ):
            raise ValueError(
                "betas must be strictly decreasing with every entry > 0"
            )
        K = b_host.shape[0]
    else:
        K = n_temps
    if x0s.ndim == 2:
        x0s = jnp.broadcast_to(x0s[None], (K,) + x0s.shape)
    elif x0s.ndim != 3 or x0s.shape[0] != K:
        raise ValueError(
            "x0s must be (chains, n) or (n_temps, chains, n); got "
            f"{x0s.shape} with {K} temperatures"
        )
    dtype = x0s.dtype
    if betas is None:
        betas = geometric_ladder(K, beta_min, dtype)
    else:
        betas = jnp.asarray(betas).astype(dtype)
    _, C, _n = x0s.shape
    log_eps0 = jnp.full((K,), jnp.log(jnp.asarray(step_size, dtype)))
    state0 = PTState(
        x=x0s,
        f=jnp.full((K, C), jnp.nan, dtype),
        betas=betas,
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=jnp.zeros((K,), dtype),
        t_da=jnp.zeros((), dtype),
        mu=jnp.log(10.0 * jnp.asarray(step_size, dtype)),
        key=key,
        i_warm=jnp.zeros((), jnp.int32),
        i_samp=jnp.zeros((), jnp.int32),
        swap_acc=jnp.zeros((max(K - 1, 0),), dtype),
        swap_att=jnp.zeros((max(K - 1, 0),), dtype),
        swap_ema=jnp.full((max(K - 1, 0),), 0.5, dtype),
        # flow tags: cold row armed 1, hot row armed 2, interior unset
        tag=jnp.where(
            jnp.arange(K)[:, None] == 0,
            1,
            jnp.where(jnp.arange(K)[:, None] == K - 1, 2, 0),
        ).astype(jnp.int32) * jnp.ones((1, C), jnp.int32),
        round_trips=jnp.zeros((C,), jnp.int32),
        var_ema=jnp.ones((K, _n), dtype),
    )
    return _pt_core(
        obj, state0, mass, n_samples, n_warmup, n_leapfrog, swap_every,
        target_accept, adapt_ladder, adapt_mass, value_and_grad_fn, 0, 0,
    )


def pt_sample_from_state(
    obj,
    state: PTState,
    mass: Optional[jax.Array] = None,
    n_samples: int = 0,
    n_warmup: int = 0,
    n_leapfrog: int = 16,
    swap_every: int = 1,
    target_accept: float = 0.8,
    adapt_ladder: bool = False,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> PTResult:
    """Continue a `pt_sample` run: ``n_warmup`` MORE warmup rounds, then
    ``n_samples`` more draws. Chunked calls replay one long run exactly
    (same base key; ``mass``/``n_leapfrog``/``swap_every``/
    ``target_accept``/``adapt_ladder``/``adapt_mass`` are config, not
    state, and must be re-passed). Warmup cannot resume after sampling
    has begun."""
    if swap_every < 1:
        raise ValueError(f"swap_every must be >= 1, got {swap_every}")
    if adapt_mass and mass is not None:
        raise ValueError(
            "adapt_mass=True adapts its own per-rung diagonal metric; "
            "drop mass= (or pass the mass and keep adapt_mass=False)"
        )
    i_warm0, i_samp0 = int(state.i_warm), int(state.i_samp)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    return _pt_core(
        obj, state, mass, n_samples, n_warmup, n_leapfrog, swap_every,
        target_accept, adapt_ladder, adapt_mass, value_and_grad_fn,
        i_warm0, i_samp0,
    )
