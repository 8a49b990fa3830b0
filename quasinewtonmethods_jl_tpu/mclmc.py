"""Microcanonical Langevin Monte Carlo — the unadjusted, fixed-cost
fleet sampler (Robnik, De Luca, Silverstein & Seljak 2022; Robnik &
Seljak 2023 — the MCLMC popularized by blackjax).

Why it earns a place next to HMC/ChEES/NUTS here: MCLMC is the most
accelerator-shaped member of the gradient-sampler family. Every chain takes the
SAME two batched gradient evaluations per step — no accept/reject (no
wasted trajectories), no trees (no data-dependent trip counts, none of
NUTS's lockstep-depth tax), no step-size/trajectory tuning loops at
sample time. The dynamics move on the isokinetic constraint ||u|| = 1
(velocity confined to the unit sphere), whose stationary x-marginal is
exactly the target; a partial momentum refresh with decoherence length
``L`` makes it ergodic (the Langevin part). The price is an O(eps²)
discretization bias instead of MH exactness — warmup adapts eps until
the per-step energy-error variance hits ``desired_energy_var`` per
dimension (5e-4 default, the published operating point at which the
bias is far below MC error for realistic draw budgets).

The batched translation of the published algorithm:

  * chains are the batch axis; the momentum update's per-chain norms and
    the refresh are elementwise/reduction ops over (chains, n) — one
    fused XLA program per step, two batched value_and_grads.
  * tuning is FLEET-NATIVE: the published single-chain schemes estimate
    Var(ΔE) and the trace of the posterior covariance from a long run;
    a 4096-chain fleet measures both across chains at every step, so
    warmup adapts eps by a damped log-Newton on the fleet's energy-error
    variance (ΔE scales as eps³ for a 2nd-order integrator, so log Var
    responds 6× to log eps) and sets L = sqrt(Σᵢ varᵢ) from the fleet
    variance EMA (frozen at ``mass_freeze`` so eps re-adapts to the
    final geometry — the same schedule the ChEES/NUTS warmups use).
  * the integrator is the minimal-norm (McLachlan) two-stage splitting
    the MCLMC papers recommend (2 gradients/step, markedly larger
    stable eps than leapfrog).
  * failure handling is in-band (the library contract): a chain whose
    step produces non-finite state reverts to its pre-step point with a
    fresh random velocity ("bounce"), the event counts into
    ``divergences``, and the energy error feeds the eps adaptation as a
    large penalty so the fleet steps down out of the unstable regime.
    A chain STARTING outside the support (f non-finite) instead walks
    ballistically (zero gradient there) until a step lands inside —
    best-effort entry, not a divergence; start chains in or near the
    support (far-outside wanderers are unguided and may drift).

Maximization convention throughout (``obj`` is the logdensity to be
MAXIMIZED, reference src/QuasiNewtonMethods.jl:8-9): the potential is
−f, so du/dt = P⊥(u) ∇f / (n−1) and ΔE = ΔK − Δf.

Resume/checkpoint contracts match the other samplers: `MCLMCState`
carries positions, velocities, cached (f, g), the full adaptation state
and phase counters; per-step keys derive as
fold_in(fold_in(key, phase), global_step), so chunked runs replay one
long run bitwise. `utils.checkpoint.save_state` serializes it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad

__all__ = ["MCLMCResult", "MCLMCState", "mclmc_sample",
           "mclmc_sample_from_state"]

# McLachlan two-stage minimal-norm coefficient (the b1 of the
# v(b1)-p(1/2)-v(1-2b1)-p(1/2)-v(b1) splitting)
_MCLACHLAN_B1 = 0.1931833275037836


class MCLMCState(NamedTuple):
    """Resumable state for `mclmc_sample`: positions, unit velocities,
    cached (logdensity, gradient), the eps/L adaptation state, the base
    RNG key, and the phase counters. ``n_warmup_total`` / ``mass_freeze``
    pin the variance-EMA freeze step so chunked runs replay the long run
    exactly. Serializable via `utils.checkpoint.save_state`."""

    x: jax.Array  # (chains, n) positions
    f: jax.Array  # (chains,) logdensity at x
    g: jax.Array  # (chains, n) gradient at x
    u: jax.Array  # (chains, n) unit velocities
    log_eps: jax.Array  # () adapted step size (log)
    var_ema: jax.Array  # (n,) fleet-variance EMA (sets L and the
    #                        adaptive diagonal preconditioner)
    varE_ema: jax.Array  # () EMA of the per-dim energy-error variance
    key: jax.Array  # base PRNG key
    i_warm: jax.Array  # () int32 warmup steps completed
    i_samp: jax.Array  # () int32 sampling steps completed
    n_warmup_total: jax.Array  # () int32 the run's planned warmup length
    mass_freeze: jax.Array  # () int32 var-EMA freeze step


class MCLMCResult(NamedTuple):
    """Samples and diagnostics for a batched MCLMC run.

    samples: (n_samples, chains, n) draws (every post-warmup step is a
        draw — MCLMC has no rejections to thin away)
    step_size: () the adapted integrator step
    L: () the momentum decoherence length in the preconditioned space
    mass_diag: (n,) the diagonal preconditioner the run sampled with
        (ones unless ``adapt_mass``/``mass`` supplied one)
    energy_changes: (n_samples, chains) per-step energy errors ΔE —
        their variance per dimension is THE quality dial: it sits at
        ``desired_energy_var`` when warmup converged, and rising values
        flag regions the step size is too coarse for
    energy_var: () mean ΔE²/n over the sampling phase (the realized
        operating point; compare against ``desired_energy_var``)
    divergences: (chains,) int32 bounce counts over sampling (non-finite
        steps reverted in-band; nonzero on a real target means eps or
        the geometry needs attention — exactly the HMC-family contract)
    final_x: (chains, n) last positions
    state: MCLMCState — resume via `mclmc_sample_from_state`
    """

    samples: jax.Array
    step_size: jax.Array
    L: jax.Array
    mass_diag: jax.Array
    energy_changes: jax.Array
    energy_var: jax.Array
    divergences: jax.Array
    final_x: jax.Array
    state: MCLMCState


def _unit(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def _mom_update(dt, u, g_eff):
    """Exact solution of the isokinetic velocity ODE
    du/dτ = P⊥(u) g / (d−1) over time ``dt`` for frozen g (the
    Robnik et al. closed form), batched over chains.

    Returns the new unit velocity and the per-chain kinetic-energy
    change (d−1)·Δr. Degenerate gradients (‖g‖ → 0) reduce to the
    identity with zero energy change.
    """
    chains, d = u.shape
    gn = jnp.linalg.norm(g_eff, axis=1)
    # zero-gradient guard via where, NOT max(gn, finfo.tiny): a backend
    # that flushes denormal-range constants to 0 would turn the floor
    # into 0/0 NaNs exactly in the flat/out-of-support regions the
    # guard exists for
    safe = gn > 0.0
    e = g_eff / jnp.where(safe, gn, 1.0)[:, None]
    ue = jnp.sum(u * e, axis=1)
    delta = dt * gn / (d - 1)
    zeta = jnp.exp(-delta)
    uu = (
        e * ((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)))[:, None]
        + (2.0 * zeta)[:, None] * u
    )
    u_new = _unit(uu)
    dk = (d - 1) * (
        delta - math.log(2.0)
        + jnp.log1p(ue + (1.0 - ue) * zeta * zeta)
    )
    return u_new, dk


def _partial_refresh(u, k, eps, L):
    """O-U partial momentum refresh on the sphere with decoherence
    length L: u ← normalize(u + ν z), ν² = e^{2eps/L} − 1."""
    nu = jnp.sqrt(jnp.expm1(2.0 * eps / L))
    z = jax.random.normal(k, u.shape, u.dtype)
    return _unit(u + nu * z)


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_samples", "n_warmup",
        "desired_energy_var", "adapt_mass", "i_warm0", "i_samp0",
    ),
)
def _mclmc_core(
    obj, state: MCLMCState, mass, n_samples, n_warmup,
    desired_energy_var, adapt_mass, value_and_grad_fn, i_warm0, i_samp0,
) -> MCLMCResult:
    vag = as_value_and_grad(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag)

    chains, n = state.x.shape
    dtype = state.x.dtype
    b1 = jnp.asarray(_MCLACHLAN_B1, dtype)
    target = jnp.asarray(desired_energy_var, dtype)
    mass_freeze = state.mass_freeze

    def _precond(var_ema):
        """(s, L) from the variance EMA: s whitens (when adapting or
        given a mass), L is the decoherence length in the whitened
        space — one formula covers all three modes (L² = Σ varᵢ/mᵢ)."""
        if adapt_mass:
            m = var_ema
        elif mass is not None:
            if callable(getattr(mass, "diag", None)):
                m = jnp.asarray(mass.diag(), dtype)  # LowRankMass handoff
            else:
                m = jnp.asarray(mass, dtype)
                if m.ndim == 2:
                    m = jnp.diagonal(m)
        else:
            m = jnp.ones((n,), dtype)
        s = jnp.sqrt(m)
        L = jnp.sqrt(jnp.sum(var_ema / m))
        return s, L

    def step(x, f, g, u, eps, s, L, k):
        """One McLachlan step + bounce guard + partial refresh.
        Returns (x, f, g, u, dE, bad)."""
        u1, dk1 = _mom_update(b1 * eps, u, s * g)
        x1 = x + (0.5 * eps) * (s * u1)
        f1, g1 = vag_b(x1)
        u2, dk2 = _mom_update((1.0 - 2.0 * _MCLACHLAN_B1) * eps, u1,
                              s * g1)
        x2 = x1 + (0.5 * eps) * (s * u2)
        f2, g2 = vag_b(x2)
        u3, dk3 = _mom_update(b1 * eps, u2, s * g2)
        # support-boundary semantics (the library's in-band conventions):
        #   * inside (f finite) -> outside/non-finite: REVERT with a
        #     fresh direction and count a divergence (reflection — the
        #     chain stays at its last good point);
        #   * outside (f non-finite, e.g. a -inf start): move
        #     BALLISTICALLY (the gradient is zero there) until a step
        #     lands inside — entry, not a divergence, ΔE referenced to
        #     the landing value so it is finite.
        f_ref = jnp.where(jnp.isfinite(f), f, f2)
        dE = (dk1 + dk2 + dk3) - (f2 - f_ref)
        structural_ok = (
            jnp.all(jnp.isfinite(g2), axis=1)
            & jnp.all(jnp.isfinite(x2), axis=1)
            & jnp.all(jnp.isfinite(u3), axis=1)
        )
        outside = ~jnp.isfinite(f)
        move = structural_ok & (jnp.isfinite(f2) | outside)
        bad = ~move
        # in-band bounce: revert the chain, fresh random direction
        u_fresh = _unit(jax.random.normal(
            jax.random.fold_in(k, 1), (chains, n), dtype
        ))
        m = move[:, None]
        x_o = jnp.where(m, x2, x)
        f_o = jnp.where(move, f2, f)
        g_o = jnp.where(m, g2, g)
        u_o = jnp.where(m, u3, u_fresh)
        dE_o = jnp.where(move & jnp.isfinite(dE), dE, 0.0)
        u_o = _partial_refresh(u_o, jax.random.fold_in(k, 2), eps, L)
        return x_o, f_o, g_o, u_o, dE_o, bad, outside

    # first-ever call: cached (f, g) and the initial velocities
    if i_warm0 == 0 and i_samp0 == 0:
        f0, g0 = vag_b(state.x)
        u0 = _unit(jax.random.normal(
            jax.random.fold_in(state.key, 2), (chains, n), dtype
        ))
    else:
        f0, g0, u0 = state.f, state.g, state.u
    k_warm = jax.random.fold_in(state.key, 0)
    k_samp = jax.random.fold_in(state.key, 1)

    # ---- warmup: eps by damped log-Newton on the fleet energy-error
    # variance; L (and optionally the preconditioner) from the fleet
    # variance EMA, frozen at mass_freeze ----
    def warm_body(carry, i):
        x, f, g, u, log_eps, var_ema, varE_ema = carry
        s, L = _precond(var_ema)
        k = jax.random.fold_in(k_warm, i)
        x, f, g, u, dE, bad, outside = step(
            x, f, g, u, jnp.exp(log_eps), s, L, k
        )
        # bounced chains feed a penalty (not their masked 0) so
        # instability steps eps DOWN; 100x target — big enough that a
        # fleet-wide blow-up saturates the clipped Newton step, small
        # enough that sporadic boundary reflections (hard -inf supports)
        # cost ~log(1 + 99·frac)/12 instead of death-spiraling eps (a
        # 1e6 penalty measured: ONE bounce among 64 chains pinned the
        # update at the -0.25 clip every step). Chains still hunting for
        # the support (outside, ballistic) carry no energy-error signal
        # and contribute NEUTRALLY (exactly the target).
        vE = jnp.mean(
            jnp.where(bad, 1e2 * target * n,
                      jnp.where(outside, target * n, dE * dE))
        ) / n
        varE_ema = 0.8 * varE_ema + 0.2 * vE
        # ΔE ~ eps³ ⇒ log varE/d responds 6× to log eps: damped Newton,
        # clipped to ±0.25 per step so a cold EMA cannot slingshot
        move = (jnp.log(target) - jnp.log(varE_ema + 1e-30)) / 6.0
        log_eps = log_eps + jnp.clip(0.5 * move, -0.25, 0.25)
        var_now = jnp.maximum(jnp.var(x, axis=0), 1e-10)
        upd = i < mass_freeze
        var_ema = jnp.where(upd, 0.9 * var_ema + 0.1 * var_now, var_ema)
        return (x, f, g, u, log_eps, var_ema, varE_ema), None

    carry = (state.x, f0, g0, u0, state.log_eps, state.var_ema,
             state.varE_ema)
    if n_warmup > 0:
        carry, _ = lax.scan(warm_body, carry, i_warm0 + jnp.arange(n_warmup))
    x, f, g, u, log_eps, var_ema, varE_ema = carry
    eps_final = jnp.exp(log_eps)
    s_final, L_final = _precond(var_ema)

    # ---- sampling at the frozen (eps, s, L): every step is a draw ----
    def sample_body(carry, j):
        x, f, g, u = carry
        x, f, g, u, dE, bad, _outside = step(
            x, f, g, u, eps_final, s_final, L_final,
            jax.random.fold_in(k_samp, j),
        )
        return (x, f, g, u), (x, dE, bad)

    (x, f, g, u), (samples, dEs, bads) = lax.scan(
        sample_body, (x, f, g, u), i_samp0 + jnp.arange(n_samples)
    )
    out_state = MCLMCState(
        x=x, f=f, g=g, u=u, log_eps=log_eps, var_ema=var_ema,
        varE_ema=varE_ema, key=state.key,
        i_warm=jnp.asarray(i_warm0 + n_warmup, jnp.int32),
        i_samp=jnp.asarray(i_samp0 + n_samples, jnp.int32),
        n_warmup_total=state.n_warmup_total,
        mass_freeze=mass_freeze,
    )
    n_draws = max(n_samples, 1)
    return MCLMCResult(
        samples=samples,
        step_size=eps_final,
        L=L_final,
        mass_diag=s_final * s_final,
        energy_changes=dEs,
        energy_var=jnp.sum(dEs * dEs) / (n_draws * chains * n),
        divergences=jnp.sum(bads.astype(jnp.int32), axis=0),
        final_x=x,
        state=out_state,
    )


def mclmc_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass: Optional[jax.Array] = None,  # (n,) diag (or (n, n): its diag)
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: Optional[float] = None,
    desired_energy_var: float = 5e-4,
    adapt_mass: bool = False,
    total_warmup: Optional[int] = None,
    value_and_grad_fn: Optional[Callable] = None,
) -> MCLMCResult:
    """Batched microcanonical Langevin Monte Carlo over a chain fleet.

    ``obj`` is the same pure logdensity (MAXIMIZED) the optimizers and
    the HMC family take. Each post-warmup step is a draw: two batched
    gradient evaluations, no accept/reject, no trees — the cheapest
    per-draw gradient sampler in the library, at the price of an
    O(eps²) discretization bias that warmup controls by adapting eps
    until the per-step energy-error variance is ``desired_energy_var``
    per dimension (5e-4 default — the published operating point; lower
    it for stricter bias at more warmup/smaller steps).

    ``mass``: an optional (n,) variance-like diagonal preconditioner
    (e.g. `chain_init_from_map(..., mass_form='diag')`); a dense (n, n)
    B is accepted and its DIAGONAL used (the isokinetic dynamics
    precondition per-coordinate). ``adapt_mass=True`` learns the
    diagonal from the fleet variance during warmup instead (frozen at
    warmup/2 like the ChEES/NUTS warmups). The momentum decoherence
    length L is always fleet-tuned (sqrt of the preconditioned
    posterior trace).

    Draws should be consumed through `diagnose_chains` like any other
    sampler's; `result.energy_var` / `result.divergences` are the
    MCLMC-specific health dials (see `MCLMCResult`).

    The result carries a resumable `state`; `mclmc_sample_from_state`
    continues (or checkpoint-chunks) the run trajectory-identically. To
    chunk THROUGH warmup, announce the plan with ``total_warmup`` (it
    pins the variance-EMA freeze step) and run
    ``n_warmup <= total_warmup`` steps now, the rest via
    `mclmc_sample_from_state`.
    """
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (chains, n), got shape {x0s.shape}")
    chains, n = x0s.shape
    if n < 2:
        raise ValueError(
            "MCLMC needs n >= 2 (the isokinetic dynamics divide by n-1); "
            "use hmc/chees/nuts for univariate targets"
        )
    if n_warmup < 0 or n_samples < 0:
        raise ValueError("n_samples and n_warmup must be >= 0")
    if total_warmup is None:
        total_warmup = n_warmup
    if n_warmup > total_warmup:
        raise ValueError(
            f"n_warmup ({n_warmup}) exceeds total_warmup ({total_warmup})"
        )
    if n_samples > 0 and n_warmup < total_warmup:
        raise ValueError(
            "cannot draw samples before the announced warmup plan is "
            f"complete ({n_warmup} of {total_warmup} steps); chunk with "
            "mclmc_sample_from_state"
        )
    if desired_energy_var <= 0.0:
        raise ValueError("desired_energy_var must be > 0")
    if mass is not None and adapt_mass:
        raise ValueError("pass either mass= or adapt_mass=True, not both")
    dtype = x0s.dtype
    # eps0: a quarter of the isotropic L (the published warm start);
    # warmup's bounce-penalized adaptation pulls it down fast if hot
    eps0 = float(step_size) if step_size is not None else 0.25 * math.sqrt(n)
    if eps0 <= 0.0:
        raise ValueError("step_size must be > 0")
    state0 = MCLMCState(
        x=x0s,
        f=jnp.full((chains,), jnp.nan, dtype),
        g=jnp.zeros((chains, n), dtype),
        u=jnp.zeros((chains, n), dtype),
        log_eps=jnp.asarray(math.log(eps0), dtype),
        var_ema=jnp.ones((n,), dtype),
        varE_ema=jnp.asarray(desired_energy_var, dtype),
        key=key,
        i_warm=jnp.zeros((), jnp.int32),
        i_samp=jnp.zeros((), jnp.int32),
        n_warmup_total=jnp.asarray(total_warmup, jnp.int32),
        mass_freeze=jnp.asarray(max(total_warmup // 2, 1), jnp.int32),
    )
    return _mclmc_core(
        obj, state0, mass, int(n_samples), int(n_warmup),
        float(desired_energy_var), bool(adapt_mass), value_and_grad_fn,
        0, 0,
    )


def mclmc_sample_from_state(
    obj,
    state: MCLMCState,
    mass: Optional[jax.Array] = None,
    n_samples: int = 0,
    n_warmup: int = 0,
    desired_energy_var: float = 5e-4,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> MCLMCResult:
    """Continue an `mclmc_sample` run from its saved state: ``n_warmup``
    MORE warmup steps, then ``n_samples`` more draws. Chunked calls are
    trajectory-identical to one long run with the same totals (same base
    key; ``mass``/``adapt_mass``/``desired_energy_var`` are config, not
    state, and must be re-passed). Warmup cannot resume after sampling
    has begun (phases are monotone), nor exceed (or be left short of)
    the plan the first call announced via ``total_warmup``."""
    i_warm0, i_samp0 = int(state.i_warm), int(state.i_samp)
    n_total = int(state.n_warmup_total)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    if i_warm0 + n_warmup > n_total:
        raise ValueError(
            f"warmup plan exceeded: state has {i_warm0} of "
            f"{n_total} planned steps; requested {n_warmup} more"
        )
    if n_samples > 0 and i_warm0 + n_warmup < n_total:
        raise ValueError(
            "cannot draw samples before the announced warmup plan is "
            f"complete ({i_warm0 + n_warmup} of {n_total} steps)"
        )
    if mass is not None and adapt_mass:
        raise ValueError("pass either mass= or adapt_mass=True, not both")
    return _mclmc_core(
        obj, state, mass, int(n_samples), int(n_warmup),
        float(desired_energy_var), bool(adapt_mass), value_and_grad_fn,
        i_warm0, i_samp0,
    )
