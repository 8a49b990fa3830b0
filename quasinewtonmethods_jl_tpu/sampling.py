"""Batched HMC sampling warm-started by the MAP fleet — the use case the
reference library exists for, completed end to end.

The reference is "the inner MAP/mode-finding engine intended for
ProbabilityModels.jl + InplaceDHMC.jl (HMC chain initialization)"
(reference README.md:14; SURVEY.md gestalt) — it finds the mode, and an
external HMC machine takes over. This module is that machine's accelerator-native
counterpart, designed around what the optimizer already produced:

  * the batched MAP result's iterates are the chain initializations
    (one chain per lane — the multi-chain pattern `PtrBFGSState` exists
    for in the reference, :117-121);
  * the converged inverse Hessian B ≈ the posterior covariance at the
    mode, which is exactly the (dense) mass-matrix preconditioner
    Euclidean HMC wants: kinetic energy 0.5 pᵀ B p, position update
    x += eps * B p — both a single matvec with the B the solver already
    holds. No inversion is needed anywhere: momenta are drawn via the
    Cholesky of B (p = L⁻ᵀ z gives cov(p) = B⁻¹).

Everything is batched the accelerator way: `lax.scan` over steps, chains as a
leading axis, one fused program for all chains; the maximization
convention carries over unchanged (logdensity IS the log target).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad, as_value_fn

__all__ = [
    "get_sampler",
    "LowRankMass",
    "HMCResult",
    "HMCState",
    "ChEESResult",
    "ChEESState",
    "NUTSResult",
    "NUTSState",
    "hmc_sample",
    "hmc_sample_from_state",
    "chees_sample",
    "chees_sample_from_state",
    "nuts_sample",
    "nuts_sample_depth_sorted",
    "nuts_sample_from_state",
    "DepthSortInfo",
    "chain_init_from_map",
]


class HMCState(NamedTuple):
    """Full resumable sampler state for `hmc_sample` (the sampler-side
    analog of the optimizers' BFGSState/LBFGSState): positions, cached
    log-densities, the COMPLETE dual-averaging accumulators, the base RNG
    key, and the phase counters. `hmc_sample_from_state` continues a run
    (finish warmup, then draw) trajectory-identically to one long run;
    `utils.checkpoint.save_state`/`load_state` serialize it.

    Per-step RNG keys derive as fold_in(fold_in(key, phase), global_step),
    so resumption needs only the counters — no key stream is consumed by
    chunking."""

    x: jax.Array  # (chains, n) current positions
    f: jax.Array  # (chains,) logdensity at x
    log_eps: jax.Array  # (chains,) dual-averaging iterate
    log_eps_bar: jax.Array  # (chains,) averaged iterate (the frozen eps)
    h_bar: jax.Array  # (chains,) DA error accumulator
    t_da: jax.Array  # () DA step count
    mu: jax.Array  # () DA shrink target log(10 * eps0)
    key: jax.Array  # the run's base PRNG key
    i_warm: jax.Array  # () int32 warmup steps completed
    i_samp: jax.Array  # () int32 sampling steps completed


class HMCResult(NamedTuple):
    """Samples and diagnostics for a batched HMC run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_rate: (chains,) mean Metropolis acceptance over sampling
    step_size: (chains,) final (adapted) leapfrog step size
    energies: (n_samples, chains) Hamiltonian -f(x)+K(p) of each
        transition's selected phase-space point (Stan's ``energy__``) —
        feed `diagnostics.energy_bfmi` for the Betancourt E-BFMI check
    divergences: (chains,) int32 count of divergent transitions over
        sampling (non-finite or catastrophic energy error)
    final_x: (chains, n) last state
    state: HMCState — resume via `hmc_sample_from_state`
    """

    samples: jax.Array
    accept_rate: jax.Array
    step_size: jax.Array
    energies: jax.Array
    divergences: jax.Array
    final_x: jax.Array
    state: HMCState


def _pt_sample_lazy(*args, **kwargs):
    # deferred: tempering imports this module (circular at import time)
    from .tempering import pt_sample

    return pt_sample(*args, **kwargs)


def _ensemble_sample_lazy(*args, **kwargs):
    # deferred for symmetry/import weight; ensemble needs no gradients
    from .ensemble import ensemble_sample

    return ensemble_sample(*args, **kwargs)


def _mclmc_sample_lazy(*args, **kwargs):
    # deferred: mclmc imports this module's conventions at call time
    from .mclmc import mclmc_sample

    return mclmc_sample(*args, **kwargs)


def get_sampler(name: str):
    """Resolve a sampler by name — ONE registry for every dispatch site
    (workflow pipeline, mesh sharding)."""
    samplers = {"chees": chees_sample, "hmc": hmc_sample,
                "nuts": nuts_sample, "pt": _pt_sample_lazy,
                "ensemble": _ensemble_sample_lazy,
                "mclmc": _mclmc_sample_lazy}
    if name not in samplers:
        raise ValueError(
            f"unknown sampler {name!r}; use one of {sorted(samplers)}"
        )
    return samplers[name]


def chain_init_from_map(result, jitter: float = 0.0, key=None,
                        mass_form: str = "auto"):
    """(x0s, mass) from a batched MAP result (`optimize_batched*` or the
    L-BFGS fleet engines).

    Returns the per-chain initial positions and a SINGLE mass
    preconditioner ≈ posterior covariance. ``mass_form``:

      * 'auto' (default): the dense (n, n) B for BFGS fleets,
        lane-averaged over CONVERGED lanes (averaging smooths per-lane
        noise; all lanes of a well-posed MAP land on the same mode); for
        L-BFGS fleets the compact-form diag(H) (O(m²·n),
        `ops.lbfgs_compact.lbfgs_diag_inv_hessian`) — the samplers'
        diagonal-mass form, no n×n matrix ever materializes.
      * 'lowrank' (L-BFGS fleets): a `LowRankMass` built from the BEST
        converged lane's ring via `lbfgs_lowrank_inv_hessian` — keeps
        the ring's correlation structure (2m directions) where 'auto'
        collapses to a diagonal, still O(m²·n). All lanes estimate the
        same curvature at the shared mode, so one lane's spectral form
        is the right large-n stand-in for the dense fleet average.

    Optional Gaussian jitter decorrelates chains that share the mode.
    """
    from .state import Status

    if jitter and key is None:
        raise ValueError(
            "chain_init_from_map: jitter > 0 needs an explicit `key` "
            "(silently skipping it would hand back perfectly correlated "
            "chain starts)"
        )
    if mass_form not in ("auto", "lowrank"):
        raise ValueError(
            f"mass_form must be 'auto' or 'lowrank', got {mass_form!r}"
        )
    x0s = result.x
    ok = (result.status == Status.CONVERGED).astype(x0s.dtype)
    # zero converged lanes: fall back to an identity mass instead of the
    # all-zero average (which yields NaN momenta via cholesky/sqrt).
    # Branchless so the helper stays jittable.
    any_ok = jnp.sum(ok) > 0
    w = ok / jnp.maximum(jnp.sum(ok), 1.0)
    state = result.state
    if hasattr(state, "B"):
        if mass_form == "lowrank":
            raise ValueError(
                "mass_form='lowrank' is the L-BFGS handoff; a BFGS fleet "
                "already has the dense B (use the default)"
            )
        n = x0s.shape[-1]
        mass = jnp.einsum("b,bij->ij", w, state.B)
        mass = jnp.where(any_ok, mass, jnp.eye(n, dtype=x0s.dtype))
    elif hasattr(state, "JTJ"):
        # LM fleet (least_squares): the Gauss-Newton matrix JTJ at the
        # solution is the observed information of the Gaussian
        # log-likelihood -1/2*||r||^2, so mass ~ covariance = inv(JTJ).
        # Failed lanes can carry NaN products (NONFINITE_VALUE at x0) -
        # mask BEFORE weighting (the 0*NaN hazard, same class as the
        # frozen-iterate regression in the BFGS driver).
        if mass_form == "lowrank":
            raise ValueError(
                "mass_form='lowrank' is the L-BFGS handoff; an LM fleet "
                "hands over the dense inv(JTJ) (use the default)"
            )
        n = x0s.shape[-1]
        eye = jnp.eye(n, dtype=x0s.dtype)
        jtj = jnp.where((ok > 0)[:, None, None], state.JTJ, 0.0)
        avg = jnp.einsum("b,bij->ij", w, jtj)
        avg = jnp.where(any_ok, avg, eye)
        minv = jnp.linalg.inv(avg)
        # singular JTJ (rank-deficient jacobian at the solution) -> inf/NaN
        # inverse: fall back to the identity metric, in-band
        mass = jnp.where(jnp.all(jnp.isfinite(minv)), minv, eye)
    elif mass_form == "lowrank":
        from .ops.lbfgs_compact import lbfgs_lowrank_inv_hessian

        # best converged lane (the -inf-masked argmax the workflow uses)
        best = jnp.argmax(jnp.where(ok > 0, result.fun, -jnp.inf))
        gamma, Q, sig = lbfgs_lowrank_inv_hessian(
            state.S[best], state.Y[best], state.hist[best],
            state.gamma[best],
        )
        # no converged lane: identity metric (gamma 1, empty-rank sig=1)
        gamma = jnp.where(any_ok, gamma, jnp.ones_like(gamma))
        sig = jnp.where(any_ok, sig, jnp.ones_like(sig))
        mass = LowRankMass(gamma=gamma, Q=Q, sig=sig)
    else:  # L-BFGS: diagonal of the compact-form inverse-Hessian estimate
        from .ops.lbfgs_compact import lbfgs_diag_inv_hessian

        diags = jax.vmap(lbfgs_diag_inv_hessian)(
            state.S, state.Y, state.hist, state.gamma
        )  # (batch, n)
        # clamp: a lane that never pushed a pair contributes gamma = 1s;
        # negative entries (indefinite secant noise) are floored out
        diags = jnp.maximum(diags, 1e-10)
        mass = jnp.einsum("b,bn->n", w, diags)
        mass = jnp.where(any_ok, mass, jnp.ones_like(mass))
    if jitter and key is not None:
        x0s = x0s + jitter * jax.random.normal(key, x0s.shape, x0s.dtype)
    return x0s, mass


class LowRankMass(NamedTuple):
    """Low-rank + scalar covariance-like metric for large n:

        M = γ·(I − QQᵀ) + Q·diag(sig)·Qᵀ,  Q (n, r) orthonormal, sig > 0

    — M acts as γ off the captured subspace and with eigenvalues ``sig``
    on it, so M^(1/2) and M^(-1/2) are CLOSED-FORM in the same basis (no
    n×n Cholesky anywhere): exactly the form the L-BFGS compact
    representation factors into (`ops.lbfgs_compact
    .lbfgs_lowrank_inv_hessian`, `chain_init_from_map(mass_form=
    'lowrank')`). Accepted wherever the samplers take ``mass``.

    ``d`` (optional, round 4): a per-coordinate OUTER scale making the
    metric M_d = D^(1/2)·M·D^(1/2) with D = diag(d) — i.e. the low-rank
    core lives in d-standardized coordinates. This is what
    ``adapt_mass='lowrank'`` produces: the diagonal variance EMA
    supplies D (everything diagonal adaptation captures) and the
    subspace captures the residual CORRELATION of the standardized
    fleet — a scalar-γ core alone throws the per-coordinate scales away
    (measured: deeper NUTS trees than plain diag on a geomspaced-scale
    target). Closed forms survive: M_d^(±1/2) ≠ D^(±1/2)·M^(±1/2) in
    general, but every operation HMC needs factors exactly —
    velocity M_d·p = √d·(M·(√d·p)), kinetic through the same
    standardization, momenta p = (1/√d)·M^(-1/2)z giving
    cov(p) = M_d^(-1)."""

    gamma: jax.Array  # ()
    Q: jax.Array  # (n, r) orthonormal columns
    sig: jax.Array  # (r,) positive eigenvalues along Q
    d: Optional[jax.Array] = None  # (n,) outer scale (None = ones)

    @property
    def diag(self) -> jax.Array:
        """diag(M_d) = d·(γ + Σ_j (sig_j − γ)·Q_ij²) — for reporting."""
        core = self.gamma + jnp.sum(
            (self.sig[None, :] - self.gamma) * self.Q * self.Q, axis=1
        )
        return core if self.d is None else self.d * core


def _mass_setup(mass, n, dtype):
    """(mass_arr, chol_u) for a covariance-like preconditioner: (n, n)
    dense (chol_u = upper Cholesky factor, momenta p = U^-1 z have
    cov(p) = mass^-1 = M), (n,) diagonal, `LowRankMass` (closed-form
    roots, chol_u unused), or None (identity diagonal). ONE home for the
    validation + Cholesky all samplers share."""
    if mass is None:
        return jnp.ones((n,), dtype), None
    if isinstance(mass, LowRankMass):
        return mass, None
    mass = jnp.asarray(mass, dtype)
    if mass.ndim == 2:
        return mass, jnp.linalg.cholesky(mass).T
    if mass.ndim == 1:
        return mass, None
    raise ValueError("mass must be (n, n), (n,), LowRankMass, or None")


def _draw_momentum(k, chains, n, dtype, mass_arr, chol_u):
    """p ~ N(0, M⁻¹) for every metric form. Dense without a precomputed
    chol_u (the fleet-adapted dense EMA inside warmup) factors on the
    fly — n is sampler-scale there, the n³ is noise next to the
    leapfrog gradients."""
    z = jax.random.normal(k, (chains, n), dtype)
    if isinstance(mass_arr, LowRankMass):
        # core: M^(-1/2) z = z/sqrt(γ) + Q[(1/sqrt(sig) − 1/sqrt(γ))·(Qᵀz)]
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        qz = z @ Q  # (chains, r)
        p = z * jax.lax.rsqrt(g) + (
            qz * (jax.lax.rsqrt(sig) - jax.lax.rsqrt(g))[None, :]
        ) @ Q.T
        if mass_arr.d is not None:
            # p = D^(-1/2)·M^(-1/2)·z  =>  cov(p) = (D^(1/2) M D^(1/2))^(-1)
            p = p * jax.lax.rsqrt(mass_arr.d)[None, :]
        return p
    if mass_arr.ndim == 2:
        if chol_u is None:
            chol_u = jnp.linalg.cholesky(mass_arr).T
        return jax.scipy.linalg.solve_triangular(chol_u, z.T, lower=False).T
    return z / jnp.sqrt(mass_arr)[None, :]


def _apply_mass(mass_arr, p):
    """M^-1 p — the preconditioned leapfrog velocity (any metric form)."""
    if isinstance(mass_arr, LowRankMass):
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        if mass_arr.d is not None:
            sd = jnp.sqrt(mass_arr.d)[None, :]
            ps = p * sd
            return sd * (g * ps + ((ps @ Q) * (sig - g)[None, :]) @ Q.T)
        return g * p + ((p @ Q) * (sig - g)[None, :]) @ Q.T
    if mass_arr.ndim == 2:
        return p @ mass_arr.T
    return mass_arr[None, :] * p


def _kinetic(p, mass_arr):
    """0.5 p' M^-1 p with M^-1 = mass_arr (any metric form)."""
    if isinstance(mass_arr, LowRankMass):
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        if mass_arr.d is not None:
            p = p * jnp.sqrt(mass_arr.d)[None, :]
        pq = p @ Q
        return 0.5 * (
            g * jnp.sum(p * p, axis=1)
            + jnp.sum(pq * pq * (sig - g)[None, :], axis=1)
        )
    if mass_arr.ndim == 2:
        return 0.5 * jnp.einsum("ci,ij,cj->c", p, mass_arr, p)
    return 0.5 * jnp.sum(mass_arr[None, :] * p * p, axis=1)


def _mass_diag(mass_arr) -> jax.Array:
    """(n,) diagonal of any metric form — the result-field reporting."""
    if isinstance(mass_arr, LowRankMass):
        return mass_arr.diag
    if mass_arr.ndim == 2:
        return jnp.diagonal(mass_arr)
    return mass_arr


# Dual averaging toward a target acceptance (Hoffman & Gelman 2014, the
# standard schedule). Elementwise: works for per-chain vectors (hmc_sample)
# and the fleet-mean scalar (chees_sample) alike.
_DA_T0, _DA_KAPPA, _DA_GAMMA = 10.0, 0.75, 0.05

# Fleet mass adaptation needs enough chains for the across-chain variance
# to mean anything (1 chain gives exactly 0; 2-4 are biased low) — below
# this the samplers silently keep the identity metric.
_MASS_ADAPT_MIN_CHAINS = 8


def _da_update(h_bar, log_eps_bar, t, accept_err, mu):
    t = t + 1.0
    eta = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta) * h_bar + eta * accept_err
    log_eps = mu - jnp.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar, t


def _apply_mass_single(mass, p):
    """M^-1 p for one chain's (n,) momentum (any metric form)."""
    if isinstance(mass, LowRankMass):
        if mass.d is not None:
            sd = jnp.sqrt(mass.d)
            ps = p * sd
            return sd * (
                mass.gamma * ps
                + mass.Q @ ((mass.sig - mass.gamma) * (mass.Q.T @ ps))
            )
        return mass.gamma * p + mass.Q @ (
            (mass.sig - mass.gamma) * (mass.Q.T @ p)
        )
    if mass.ndim == 2:
        return mass @ p
    return mass * p


def _leapfrog(grad_fn, x, p, eps, mass, n_steps):
    """Standard velocity-Verlet with M⁻¹ = mass (ascent form: dp/dt = +∇)."""

    def body(_, carry):
        x, p = carry
        p = p + 0.5 * eps * grad_fn(x)
        x = x + eps * _apply_mass_single(mass, p)
        p = p + 0.5 * eps * grad_fn(x)
        return x, p

    return lax.fori_loop(0, n_steps, body, (x, p))


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_samples", "n_warmup", "n_leapfrog",
        "target_accept", "i_warm0", "i_samp0",
    ),
)
def _hmc_core(
    obj, state: HMCState, mass, n_samples, n_warmup, n_leapfrog,
    target_accept, value_and_grad_fn, i_warm0, i_samp0,
) -> HMCResult:
    """Shared chunkable core: run ``n_warmup`` more warmup steps (global
    indices i_warm0..) then ``n_samples`` draws (global indices i_samp0..).
    Per-step keys are fold_in(fold_in(key, phase), global_step), so a
    chunked run replays the long run's exact key stream."""
    vag = as_value_and_grad(obj, value_and_grad_fn)
    # value-only for Metropolis ratios: the trajectory's final gradient was
    # already computed inside the leapfrog — never pay a second backward
    f_b = jax.vmap(as_value_fn(obj, value_and_grad_fn))

    chains, n = state.x.shape
    dtype = state.x.dtype

    mass_b, chol_u = _mass_setup(mass, n, dtype)

    def leap_b(x, p, eps):
        def one(xc, pc, ec):
            return _leapfrog(lambda xx: vag(xx)[1], xc, pc, ec, mass_b,
                             n_leapfrog)
        return jax.vmap(one)(x, p, eps)

    def hmc_step(x, f, eps, k):
        k1, k2 = jax.random.split(k)
        p = _draw_momentum(k1, chains, n, dtype, mass_b, chol_u)
        x_new, p_new = leap_b(x, p, eps)
        f_new = f_b(x_new)
        e_init = _kinetic(p, mass_b) - f
        e_prop = _kinetic(p_new, mass_b) - f_new
        log_ratio = e_init - e_prop
        # NaN-robust: a diverged trajectory (non-finite ratio) is rejected
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept_prob = jnp.where(jnp.isfinite(accept_prob), accept_prob, 0.0)
        u = jax.random.uniform(k2, (chains,), dtype)
        acc = u < accept_prob
        x = jnp.where(acc[:, None], x_new, x)
        f = jnp.where(acc, f_new, f)
        # observability: the Hamiltonian of the transition's selected
        # phase-space point (Stan's energy__), and the Stan-convention
        # divergence flag (energy error non-finite or past the blow-up
        # threshold — fixed-length HMC rejects these in-band above)
        energy = jnp.where(acc, e_prop, e_init)
        div = ~jnp.isfinite(log_ratio) | (log_ratio < -1000.0)
        return x, f, acc, accept_prob, energy, div

    # first-ever call: the cached logdensity is not populated yet
    f0 = f_b(state.x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    k_warm = jax.random.fold_in(state.key, 0)
    k_samp = jax.random.fold_in(state.key, 1)

    # ---- warmup: dual averaging toward target_accept (per chain) ----
    def warm_body(carry, i):
        x, f, log_eps, log_eps_bar, h_bar, t = carry
        k = jax.random.fold_in(k_warm, i)
        x, f, _acc, a_prob, _e, _d = hmc_step(x, f, jnp.exp(log_eps), k)
        log_eps, log_eps_bar, h_bar, t = _da_update(
            h_bar, log_eps_bar, t, target_accept - a_prob, state.mu
        )
        return (x, f, log_eps, log_eps_bar, h_bar, t), None

    carry_w = (state.x, f0, state.log_eps, state.log_eps_bar, state.h_bar,
               state.t_da)
    if n_warmup > 0:
        carry_w, _ = lax.scan(
            warm_body, carry_w, i_warm0 + jnp.arange(n_warmup)
        )
    x, f, log_eps, log_eps_bar, h_bar, t_da = carry_w
    eps_final = jnp.exp(log_eps_bar)

    # ---- sampling at the adapted step ----
    def sample_body(carry, j):
        x, f = carry
        x, f, acc, _, e, dv = hmc_step(
            x, f, eps_final, jax.random.fold_in(k_samp, j)
        )
        return (x, f), (x, acc, e, dv)

    (x, f), (samples, accs, energies, divs) = lax.scan(
        sample_body, (x, f), i_samp0 + jnp.arange(n_samples)
    )
    out_state = HMCState(
        x=x, f=f, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
        t_da=t_da, mu=state.mu, key=state.key,
        i_warm=jnp.asarray(i_warm0 + n_warmup, jnp.int32),
        i_samp=jnp.asarray(i_samp0 + n_samples, jnp.int32),
    )
    return HMCResult(
        samples=samples,
        accept_rate=jnp.mean(accs.astype(dtype), axis=0),
        step_size=eps_final,
        energies=energies,
        divergences=jnp.sum(divs.astype(jnp.int32), axis=0),
        final_x=x,
        state=out_state,
    )


def hmc_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass: Optional[jax.Array] = None,  # (n, n) dense or (n,) diagonal ~ cov
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    value_and_grad_fn: Optional[Callable] = None,
) -> HMCResult:
    """Batched Euclidean HMC over independent chains.

    ``obj`` is the same pure logdensity (MAXIMIZED = the log target) the
    optimizer takes; ``mass`` is the covariance-like preconditioner
    (`chain_init_from_map` provides B from the MAP fleet; None = identity).
    Warmup adapts a per-chain step size by dual averaging toward
    ``target_accept`` (Hoffman & Gelman 2014, the standard schedule);
    sampling runs at the adapted step. One jitted `lax.scan` per phase;
    chains advance in lockstep (leapfrog cost is identical per chain, so
    there is no straggler problem — unlike the solves).

    This is deliberately plain HMC, not NUTS: fixed path length keeps the
    program free of data-dependent trip counts, which is what a lockstep
    fleet wants; tune ``n_leapfrog`` to the problem scale.

    The result carries a resumable `state`; `hmc_sample_from_state`
    continues (or checkpoint-chunks) the run trajectory-identically.
    """
    x0s = jnp.asarray(x0s)
    chains, _n = x0s.shape
    dtype = x0s.dtype
    log_eps0 = jnp.full((chains,), jnp.log(jnp.asarray(step_size, dtype)))
    state0 = HMCState(
        x=x0s,
        f=jnp.full((chains,), jnp.nan, dtype),
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=jnp.zeros((chains,), dtype),
        t_da=jnp.zeros((), dtype),
        mu=jnp.log(10.0 * jnp.asarray(step_size, dtype)),
        key=key,
        i_warm=jnp.zeros((), jnp.int32),
        i_samp=jnp.zeros((), jnp.int32),
    )
    return _hmc_core(
        obj, state0, mass, n_samples, n_warmup, n_leapfrog, target_accept,
        value_and_grad_fn, 0, 0,
    )


def hmc_sample_from_state(
    obj,
    state: HMCState,
    mass: Optional[jax.Array] = None,
    n_samples: int = 0,
    n_warmup: int = 0,
    n_leapfrog: int = 16,
    target_accept: float = 0.8,
    value_and_grad_fn: Optional[Callable] = None,
) -> HMCResult:
    """Continue an `hmc_sample` run from its saved state: run ``n_warmup``
    MORE warmup steps, then ``n_samples`` more draws. Chunked calls are
    trajectory-identical to one long run with the same totals (same base
    key, same configuration args — ``mass``/``n_leapfrog``/
    ``target_accept`` are config, not state, and must be re-passed).
    Warmup cannot resume after sampling has begun (phases are monotone).
    """
    i_warm0, i_samp0 = int(state.i_warm), int(state.i_samp)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    return _hmc_core(
        obj, state, mass, n_samples, n_warmup, n_leapfrog, target_accept,
        value_and_grad_fn, i_warm0, i_samp0,
    )


class ChEESState(NamedTuple):
    """Resumable state for `chees_sample`: positions, cached logdensity,
    the full adaptation state (dual-averaging accumulators, Adam moments
    on log T, the fleet-variance mass EMA), the base RNG key, and the
    phase counters. ``n_warmup_total`` / ``mass_freeze`` pin the Halton
    index offset and the mass-freeze step so chunked runs replay the long
    run exactly. Serializable via `utils.checkpoint.save_state`."""

    x: jax.Array  # (chains, n)
    f: jax.Array  # (chains,)
    log_eps: jax.Array  # () DA iterate (shared step size)
    log_eps_bar: jax.Array  # () averaged iterate
    h_bar: jax.Array  # ()
    t_da: jax.Array  # ()
    mu: jax.Array  # () DA shrink target
    log_T: jax.Array  # () Adam iterate (mean trajectory length)
    m1: jax.Array  # () Adam first moment
    m2: jax.Array  # () Adam second moment
    t_adam: jax.Array  # () Adam step count
    log_T_min: jax.Array  # () lower clip (config bound at init)
    var_ema: jax.Array  # (n,) variance or (n, n) covariance mass EMA
    key: jax.Array
    i_warm: jax.Array  # () int32
    i_samp: jax.Array  # () int32
    n_warmup_total: jax.Array  # () int32 planned warmup length
    mass_freeze: jax.Array  # () int32 freeze step (n_warmup_total // 2)
    # adapt_mass='lowrank' only (round 4): the tracked covariance
    # subspace — None in every other mode (old checkpoints load as None)
    lr_Q: Optional[jax.Array] = None  # (n, r) orthonormal basis
    lr_sig: Optional[jax.Array] = None  # (r,) eigenvalues along lr_Q


class ChEESResult(NamedTuple):
    """Samples and adaptation diagnostics for a ChEES-HMC run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_rate: (chains,) mean Metropolis acceptance over sampling
    step_size: () adapted shared leapfrog step size
    traj_length: () adapted mean trajectory length (time units)
    mass_diag: (n,) the (possibly fleet-adapted) diagonal preconditioner
    energies: (n_samples, chains) Hamiltonian of each transition's
        selected phase-space point (Stan's ``energy__``) — feed
        `diagnostics.energy_bfmi` for the Betancourt E-BFMI check
    divergences: (chains,) int32 count of divergent transitions over
        sampling (non-finite or catastrophic energy error)
    final_x: (chains, n) last state
    state: ChEESState — resume via `chees_sample_from_state`
    """

    samples: jax.Array
    accept_rate: jax.Array
    step_size: jax.Array
    traj_length: jax.Array
    mass_diag: jax.Array
    energies: jax.Array
    divergences: jax.Array
    final_x: jax.Array
    state: ChEESState


def _lowrank_gamma(lr_sig, n):
    """Off-subspace eigenvalue of the standardized low-rank core: the
    standardized covariance has trace ≈ n (unit diagonal when the diag
    EMA tracks the marginal scales), so the mean residual eigenvalue is
    (n − Σsig)/(n − r). STATELESS in (lr_sig, n) — derived, not carried,
    so chunked runs replay long runs exactly with no extra state."""
    r = lr_sig.shape[0]
    return jnp.maximum(
        (n - jnp.sum(lr_sig)) / max(n - r, 1), jnp.asarray(1e-10, lr_sig.dtype)
    )


def _lowrank_metric(var_ema, lr_Q, lr_sig):
    """The sampling metric for adapt_mass='lowrank': the diagonal
    variance EMA as the outer scale (everything diag adaptation knows)
    times the standardized low-rank core (the residual correlation).
    Reduces to diag when the core is ≈ identity; approaches the dense
    EMA as the rank covers the correlated directions."""
    n = lr_Q.shape[0]
    return LowRankMass(
        gamma=_lowrank_gamma(lr_sig, n), Q=lr_Q, sig=lr_sig, d=var_ema
    )


def _lowrank_mass_step(x, var_ema, lr_Q, lr_sig, upd, chains):
    """One subspace-iteration step on the EMA'd STANDARDIZED covariance
    OPERATOR M' = 0.9·M_prev + 0.1·Cs_now, Cs = D^(-1/2)·C·D^(-1/2) with
    D the diagonal variance EMA — never an n×n matrix: each apply is
    O(chains·n·r + n·r²), the QR and the (r, r) eigh rotate the basis
    toward M''s top-r eigenspace (a per-round "periodic QR refresh").
    Standardizing first means the subspace only has to capture residual
    CORRELATION — the per-coordinate scales ride the diag EMA, exactly
    as in plain diagonal adaptation (a scalar-γ core in raw coordinates
    measured *deeper* NUTS trees than diag on geomspaced scales).
    Highest matmul precision: reduced-precision default dots would feed
    metric-level noise straight into the kinetic energy. Shared by the
    ChEES and NUTS warmups (`adapt_mass='lowrank'`)."""
    with jax.default_matmul_precision("highest"):
        xc = x - jnp.mean(x, axis=0, keepdims=True)
        xs = xc * jax.lax.rsqrt(var_ema)[None, :]  # standardized residuals
        gam = _lowrank_gamma(lr_sig, lr_Q.shape[0])

        def M_apply(V):
            qv = lr_Q.T @ V  # (r, cols)
            prev = gam * (V - lr_Q @ qv) + lr_Q @ (
                lr_sig[:, None] * qv
            )
            cur = xs.T @ (xs @ V) / (chains - 1)
            return 0.9 * prev + 0.1 * cur

        Qn, _r = jnp.linalg.qr(M_apply(lr_Q))
        B = Qn.T @ M_apply(Qn)
        eigval, U = jnp.linalg.eigh(0.5 * (B + B.T))
        Qn = Qn @ U
    lr_Q = jnp.where(upd, Qn, lr_Q)
    lr_sig = jnp.where(upd, jnp.maximum(eigval, 1e-10), lr_sig)
    var_now = jnp.maximum(jnp.var(x, axis=0), 1e-10)
    var_ema = jnp.where(upd, 0.9 * var_ema + 0.1 * var_now, var_ema)
    return lr_Q, lr_sig, var_ema


def _lowrank_mass_init(mass_rank, n, chains, dtype):
    """Identity metric at rank r: first-r coordinate basis, unit
    eigenvalues — the subspace iteration rotates it toward the fleet
    covariance's top eigenspace from round 1. r is capped so Qᵀ·C·Q
    stays an honest eigenproblem (r < chains) and r <= n."""
    r = max(1, min(mass_rank, n, chains - 1))
    return jnp.eye(n, r, dtype=dtype), jnp.ones((r,), dtype)


def _halton(count: int) -> jnp.ndarray:
    """Base-2 van der Corput sequence (the trajectory-length jitter grid
    the ChEES paper uses; a low-discrepancy alternative to iid uniforms)."""
    import numpy as _np

    idx = _np.arange(1, count + 1, dtype=_np.uint64)
    out = _np.zeros(count)
    base = 0.5
    while idx.any():
        out += base * (idx & 1)
        idx >>= 1
        base *= 0.5
    return jnp.asarray(out)


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_samples", "n_warmup",
        "target_accept", "max_leapfrog", "adapt_mass",
        "i_warm0", "i_samp0", "n_warmup_total", "mass_freeze",
    ),
)
def _chees_core(
    obj, state: ChEESState, mass, n_samples, n_warmup, target_accept,
    max_leapfrog, adapt_mass, value_and_grad_fn, i_warm0, i_samp0,
    n_warmup_total, mass_freeze,
) -> ChEESResult:
    """Chunkable core (see `_hmc_core` for the key-stream discipline).
    ``n_warmup_total`` pins the Halton offset of the sampling phase and
    ``mass_freeze`` the EMA freeze step — both static, carried in the
    state as data so resumption replays the long run exactly."""
    vag = as_value_and_grad(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag)
    # value-only for Metropolis ratios: the trajectory's final gradient was
    # already computed inside the leapfrog — never pay a second backward
    f_b = jax.vmap(as_value_fn(obj, value_and_grad_fn))

    chains, n = state.x.shape
    dtype = state.x.dtype

    # dense (n, n) mass (e.g. the B from chain_init_from_map) is static by
    # construction (adaptation is diagonal-only), so _mass_setup's Cholesky
    # is hoisted out of both scans
    mass0, chol_u = _mass_setup(mass, n, dtype)

    def grad_b(x):
        return vag_b(x)[1]

    def leapfrog_dyn(x, p, eps, mass_d, n_steps):
        # velocity Verlet, shared dynamic trip count (all chains lockstep)
        p = p + 0.5 * eps * grad_b(x)

        def body(c):
            x, p, i = c
            x = x + eps * _apply_mass(mass_d, p)
            g = grad_b(x)
            p = p + jnp.where(i < n_steps - 1, eps, 0.5 * eps) * g
            return x, p, i + 1

        x, p, _ = lax.while_loop(
            lambda c: c[2] < n_steps, body, (x, p, jnp.int32(0))
        )
        return x, p

    def round_(x, f, log_eps, log_T, mass_d, u, k, chol_d=None):
        """One jittered-trajectory HMC round shared by warmup/sampling.

        Returns new (x, f), acceptance probabilities, and the ChEES
        gradient w.r.t. log T. ``chol_d``: precomputed upper Cholesky for
        a STATIC dense mass; the fleet-adapted dense EMA passes None and
        factors per round (n is sampler-scale; the n^3 is noise next to
        the leapfrog gradients)."""
        eps = jnp.exp(log_eps)
        t_jit = u * 2.0 * jnp.exp(log_T)
        n_steps = jnp.clip(
            jnp.round(t_jit / eps).astype(jnp.int32), 1, max_leapfrog
        )
        p = _draw_momentum(k, chains, n, dtype, mass_d, chol_d)
        x_new, p_new = leapfrog_dyn(x, p, eps, mass_d, n_steps)
        f_new = f_b(x_new)
        e_init = _kinetic(p, mass_d) - f
        e_prop = _kinetic(p_new, mass_d) - f_new
        log_ratio = e_init - e_prop
        a_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        a_prob = jnp.where(jnp.isfinite(a_prob), a_prob, 0.0)
        u_mh = jax.random.uniform(jax.random.fold_in(k, 7), (chains,), dtype)
        acc = u_mh < a_prob
        x_out = jnp.where(acc[:, None], x_new, x)
        f_out = jnp.where(acc, f_new, f)
        # observability (see hmc_step): selected-point Hamiltonian +
        # Stan-convention divergence flag
        energy = jnp.where(acc, e_prop, e_init)
        div = ~jnp.isfinite(log_ratio) | (log_ratio < -1000.0)

        # ChEES gradient wrt log T (chain rule through t = u * 2T):
        # Delta_c * <x'_c - mean(x'), dx'/dt = M^-1-velocity ~ mass*p'>,
        # acceptance-weighted over the fleet.
        w = x_new - jnp.mean(x_new, axis=0, keepdims=True)
        v = x - jnp.mean(x, axis=0, keepdims=True)
        delta = jnp.sum(w * w, axis=1) - jnp.sum(v * v, axis=1)
        dxdt = _apply_mass(mass_d, p_new)
        per_chain = delta * jnp.sum(w * dxdt, axis=1)
        wsum = jnp.maximum(jnp.sum(a_prob), 1e-6)
        g_chees = jnp.sum(a_prob * per_chain) / wsum * t_jit
        g_chees = jnp.where(jnp.isfinite(g_chees), g_chees, 0.0)
        return x_out, f_out, a_prob, g_chees, energy, div

    # first-ever call: populate the cached logdensity
    f0 = f_b(state.x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    # astype(dtype): _halton builds in f64; without the cast, f32 chains
    # under jax_enable_x64 promote the warmup carry (t_jit -> g_chees ->
    # log_T/m1/m2) to f64 and lax.scan rejects the carry (regression-tested)
    # The Halton index is GLOBAL (warmup step i -> halton[i]; sampling step
    # j -> halton[n_warmup_total + j]) so chunked runs see the long run's
    # exact jitter sequence.
    us_all = _halton(n_warmup_total + i_samp0 + n_samples).astype(dtype)
    us_w = us_all[i_warm0 : i_warm0 + n_warmup]
    us_s = us_all[n_warmup_total + i_samp0 :]

    k_warm = jax.random.fold_in(state.key, 0)
    k_samp = jax.random.fold_in(state.key, 1)

    # ---- warmup: joint (eps, T, mass) adaptation ----
    b1, b2, adam_lr = 0.9, 0.95, 0.025
    log_T_min = state.log_T_min

    def make_warm_body(frozen_chol=None, frozen=False):
      def warm_body(carry, xs):
        (x, f, log_eps, log_eps_bar, h_bar, tda, log_T, m1, m2, tad,
         var_ema, lr_Q, lr_sig) = carry
        u, i = xs
        k = jax.random.fold_in(k_warm, i)
        if adapt_mass == "lowrank":
            # diag-EMA outer scale x standardized low-rank core;
            # closed-form roots via LowRankMass — see _lowrank_metric
            mass_d = _lowrank_metric(var_ema, lr_Q, lr_sig)
            chol_d = None
        elif adapt_mass:
            # frozen_chol is the post-freeze hoisted factor (identical
            # values; saves a per-round n^3 cholesky in the dense mode)
            mass_d, chol_d = var_ema, frozen_chol
        else:
            mass_d, chol_d = mass0, chol_u
        x, f, a_prob, g_chees, _e, _d = round_(
            x, f, log_eps, log_T, mass_d, u, k, chol_d
        )

        # dual averaging on the fleet-mean acceptance
        log_eps, log_eps_bar, h_bar, tda = _da_update(
            h_bar, log_eps_bar, tda, target_accept - jnp.mean(a_prob),
            state.mu,
        )

        # Adam ascent on log T with the ChEES gradient
        tad = tad + 1.0
        m1 = b1 * m1 + (1.0 - b1) * g_chees
        m2 = b2 * m2 + (1.0 - b2) * g_chees * g_chees
        mhat = m1 / (1.0 - b1**tad)
        vhat = m2 / (1.0 - b2**tad)
        log_T = log_T + adam_lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        log_T = jnp.clip(
            log_T, log_T_min, jnp.log(max_leapfrog * jnp.exp(log_eps_bar))
        )

        # fleet mass: across-chain variance (diag) or covariance (dense)
        # EMA, frozen at half-warmup. The dense EMA stays PD: it mixes a
        # PD carry (eye init) with a PSD sample covariance + tiny ridge.
        # (Post-freeze rounds run in a separate scan with frozen_chol set,
        # so the EMA update and per-round cholesky are elided there.)
        if frozen_chol is None and adapt_mass == "dense":
            xc = x - jnp.mean(x, axis=0, keepdims=True)
            cov_now = xc.T @ xc / (chains - 1)
            cov_now = cov_now + 1e-8 * jnp.eye(n, dtype=dtype) * (
                1.0 + jnp.trace(cov_now) / n
            )
            upd = i < mass_freeze
            var_ema = jnp.where(upd, 0.9 * var_ema + 0.1 * cov_now, var_ema)
        elif (not frozen) and adapt_mass == "lowrank":
            upd = i < mass_freeze
            lr_Q, lr_sig, var_ema = _lowrank_mass_step(
                x, var_ema, lr_Q, lr_sig, upd, chains
            )
        elif frozen_chol is None and adapt_mass and adapt_mass != "lowrank":
            var_now = jnp.maximum(jnp.var(x, axis=0), 1e-10)
            upd = i < mass_freeze
            var_ema = jnp.where(
                upd, 0.9 * var_ema + 0.1 * var_now, var_ema
            )
        return (
            (x, f, log_eps, log_eps_bar, h_bar, tda, log_T, m1, m2, tad,
             var_ema, lr_Q, lr_sig),
            None,
        )

      return warm_body

    carry_w = (
        state.x, f0, state.log_eps, state.log_eps_bar, state.h_bar,
        state.t_da, state.log_T, state.m1, state.m2, state.t_adam,
        state.var_ema, state.lr_Q, state.lr_sig,
    )
    if n_warmup > 0:
        # split at the (static) freeze step: the adapting prefix pays the
        # per-round cholesky (dense) / QR+eigh (lowrank), the frozen
        # suffix hoists/elides it — identical trajectories, measured ~30%
        # of the dense-warmup cost
        n_a = max(0, min(n_warmup, int(mass_freeze) - i_warm0))
        n_b = n_warmup - n_a
        if n_a > 0:
            carry_w, _ = lax.scan(
                make_warm_body(None), carry_w,
                (us_w[:n_a], i_warm0 + jnp.arange(n_a)),
            )
        if n_b > 0:
            frozen = (
                jnp.linalg.cholesky(carry_w[10]).T
                if adapt_mass == "dense"
                else None
            )
            carry_w, _ = lax.scan(
                make_warm_body(frozen, frozen=True), carry_w,
                (us_w[n_a:], i_warm0 + n_a + jnp.arange(n_b)),
            )
    (x, f, log_eps, log_eps_bar, h_bar, t_da, log_T, m1, m2, t_adam,
     var_ema, lr_Q, lr_sig) = carry_w
    if adapt_mass == "lowrank":
        mass_final = _lowrank_metric(var_ema, lr_Q, lr_sig)
    else:
        mass_final = var_ema if adapt_mass else mass0
    eps_final = jnp.exp(log_eps_bar)
    chol_final = (
        jnp.linalg.cholesky(mass_final).T
        if adapt_mass == "dense"
        else (chol_u if not adapt_mass else None)
    )

    # ---- sampling at frozen (eps, T, mass), still Halton-jittered ----
    def sample_body(carry, xs):
        x, f = carry
        u, j = xs
        k = jax.random.fold_in(k_samp, j)
        x, f, a_prob, _g, e, dv = round_(
            x, f, log_eps_bar, log_T, mass_final, u, k, chol_final
        )
        return (x, f), (x, a_prob, e, dv)

    (x, f), (samples, a_probs, energies, divs) = lax.scan(
        sample_body,
        (x, f),
        (us_s, i_samp0 + jnp.arange(n_samples)),
    )
    out_state = ChEESState(
        x=x, f=f, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
        t_da=t_da, mu=state.mu, log_T=log_T, m1=m1, m2=m2, t_adam=t_adam,
        log_T_min=state.log_T_min, var_ema=var_ema, key=state.key,
        i_warm=jnp.asarray(i_warm0 + n_warmup, jnp.int32),
        i_samp=jnp.asarray(i_samp0 + n_samples, jnp.int32),
        n_warmup_total=jnp.asarray(n_warmup_total, jnp.int32),
        mass_freeze=jnp.asarray(mass_freeze, jnp.int32),
        lr_Q=lr_Q, lr_sig=lr_sig,
    )
    return ChEESResult(
        samples=samples,
        accept_rate=jnp.mean(a_probs, axis=0),
        step_size=eps_final,
        traj_length=jnp.exp(log_T),
        mass_diag=_mass_diag(mass_final),
        energies=energies,
        divergences=jnp.sum(divs.astype(jnp.int32), axis=0),
        final_x=x,
        state=out_state,
    )


def _chees_adapt_mass(adapt_mass, mass, chains):
    """ONE home for the static adapt-mass decision (the same rule on first
    call and on resume): an explicit mass or a tiny fleet disables the
    across-chain metric (1 chain -> exactly 0 -> the 1e-10 clamp; 2-4
    chains are biased low). Returns the normalized mode: False, 'diag'
    (the default across-chain variance EMA), 'dense' (full across-chain
    covariance EMA — the fleet-as-estimator answer to correlated
    posteriors, round-2 VERDICT item 4; use for n up to a few hundred),
    or 'lowrank' (ChEES and NUTS: rank-r across-chain covariance tracked
    by per-round subspace iteration — dense-quality correlation capture
    at O(n·r) state for n where dense's O(n²) EMA is unaffordable)."""
    if not adapt_mass or mass is not None or chains < _MASS_ADAPT_MIN_CHAINS:
        return False
    if adapt_mass is True:
        return "diag"
    if adapt_mass in ("diag", "dense", "lowrank"):
        return adapt_mass
    raise ValueError(
        f"adapt_mass must be bool, 'diag', 'dense' or 'lowrank', "
        f"got {adapt_mass!r}"
    )


def _check_resume_mass_mode(adapt_mass, var_ema, lr_Q=None) -> None:
    """Resume guard: the saved state's mass EMA must match the re-passed
    ``adapt_mass`` mode. The (n,) diag variance and the (n, n) covariance
    live in the same ``var_ema`` field, and adapt_mass is config (re-passed
    on resume), so resuming a 'dense' run under the default ('diag') would
    silently row-broadcast the (n,) fleet variance into the (n, n)
    covariance EMA during remaining warmup — an asymmetric, wrong metric
    with no error (advisor round-3 finding). Same guard for 'lowrank'
    (ChEES/NUTS): the saved subspace (``lr_Q``) and the mode must agree, else
    remaining warmup either drops the tracked subspace on the floor or
    tries to subspace-iterate a None."""
    if not adapt_mass:
        return
    saved = (
        "lowrank" if lr_Q is not None
        else ("dense" if var_ema.ndim == 2 else "diag")
    )
    if adapt_mass != saved:
        raise ValueError(
            f"adapt_mass={adapt_mass!r} does not match the saved state's "
            f"{saved!r} mass adaptation (var_ema.ndim={var_ema.ndim}, "
            f"lr_Q={'set' if lr_Q is not None else 'None'}); re-pass "
            f"adapt_mass={saved!r} to resume this run"
        )


def chees_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass: Optional[jax.Array] = None,  # (n,n) dense / (n,) diag ~ cov; None = adapt diag
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: float = 0.1,
    traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_leapfrog: int = 1024,
    adapt_mass: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
    total_warmup: Optional[int] = None,
    mass_rank: int = 16,
) -> ChEESResult:
    """Batched HMC with ChEES-adapted trajectory lengths — the accelerator-native
    answer to NUTS.

    NUTS decides the trajectory length per chain by growing a binary tree
    until a U-turn: data-dependent, per-chain control flow that serializes
    a lockstep fleet (every chain waits for the deepest tree) and resists
    XLA compilation. ChEES (Hoffman, Radul & Sountsov, AISTATS 2021)
    gets the same adaptivity *across* the fleet instead: all chains run
    the SAME jittered trajectory each round, and the mean trajectory
    length is learned by gradient ascent on the Change-in-Estimator of
    the Expected Square criterion

        ChEES = E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ] / 4,

    whose gradient signal per chain is Delta_c * <x'_c - mean(x'), p'_c>
    (weighted by the Metropolis acceptance probability) — an expectation
    the many-chain fleet estimates in one cross-chain reduction per round.
    This is exactly the regime the MAP fleet hands over (thousands of
    lanes), and the whole sampler stays two `lax.scan`s of fixed shape
    with one shared dynamic-trip leapfrog loop per round.

    Adaptation (warmup phase only):
      * trajectory length: Adam on log T with the ChEES gradient; each
        round uses t = u * 2T with u from a base-2 Halton sequence
        (low-discrepancy jitter, per the paper), clamped so the leapfrog
        count stays in [1, max_leapfrog];
      * step size: dual averaging of the fleet-mean acceptance toward
        ``target_accept`` (shared eps — chains are lockstep anyway);
      * mass: with ``adapt_mass`` and no explicit ``mass``, the diagonal
        preconditioner is the ACROSS-CHAIN variance of the fleet state
        (EMA-smoothed, frozen after warmup/2) — with thousands of chains
        the fleet itself is the sample the usual within-chain Welford
        window has to accumulate; another across-fleet estimator, like
        `chain_init_from_map`'s averaged B. ``adapt_mass='dense'`` tracks
        the full (n, n) covariance EMA instead; ``adapt_mass='lowrank'``
        tracks its top-``mass_rank`` eigenspace only (one subspace-
        iteration step per warmup round on the EMA'd covariance operator
        — O(chains·n·r) per round, O(n·r) state) and samples with the
        closed-form `LowRankMass` metric: dense-quality correlation
        capture at n = 512+ where the dense O(n²) EMA and per-round
        O(n³) Cholesky stop being noise.

    Returns post-warmup draws at frozen (eps, T, mass), trajectory still
    Halton-jittered (recommended practice). The result carries a resumable
    `state`; `chees_sample_from_state` continues the run
    trajectory-identically. For CHUNKED warmup, announce the plan up front
    with ``total_warmup`` (it pins the Halton offset and the mass-freeze
    step) and run ``n_warmup <= total_warmup`` steps now, the rest via
    `chees_sample_from_state`.
    """
    x0s = jnp.asarray(x0s)
    chains, n = x0s.shape
    dtype = x0s.dtype
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
            "n_samples=0 and finish warmup via chees_sample_from_state"
        )
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    var0 = (
        jnp.eye(n, dtype=dtype)
        if adapt_mass == "dense"
        else jnp.ones((n,), dtype)
    )
    if adapt_mass == "lowrank":
        lr_Q0, lr_sig0 = _lowrank_mass_init(mass_rank, n, chains, dtype)
    else:
        lr_Q0 = lr_sig0 = None
    zero = jnp.zeros((), dtype)
    state0 = ChEESState(
        x=x0s,
        f=jnp.full((chains,), jnp.nan, dtype),
        log_eps=jnp.log(jnp.asarray(step_size, dtype)),
        log_eps_bar=jnp.log(jnp.asarray(step_size, dtype)),
        h_bar=zero,
        t_da=zero,
        mu=jnp.log(10.0 * jnp.asarray(step_size, dtype)),
        log_T=jnp.log(jnp.asarray(traj_length, dtype)),
        m1=zero,
        m2=zero,
        t_adam=zero,
        log_T_min=jnp.log(jnp.asarray(step_size, dtype) * 0.5),
        var_ema=var0,
        key=key,
        i_warm=jnp.zeros((), jnp.int32),
        i_samp=jnp.zeros((), jnp.int32),
        n_warmup_total=jnp.asarray(total_warmup, jnp.int32),
        mass_freeze=jnp.asarray(max(total_warmup // 2, 1), jnp.int32),
        lr_Q=lr_Q0,
        lr_sig=lr_sig0,
    )
    return _chees_core(
        obj, state0, mass, n_samples, n_warmup, target_accept, max_leapfrog,
        adapt_mass, value_and_grad_fn, 0, 0, total_warmup,
        max(total_warmup // 2, 1),
    )


def chees_sample_from_state(
    obj,
    state: ChEESState,
    mass: Optional[jax.Array] = None,
    n_samples: int = 0,
    n_warmup: int = 0,
    target_accept: float = 0.75,
    max_leapfrog: int = 1024,
    adapt_mass: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
) -> ChEESResult:
    """Continue a `chees_sample` run: ``n_warmup`` MORE warmup steps, then
    ``n_samples`` more draws, trajectory-identical to one long run with the
    same totals. The warmup plan is pinned by the first call's
    ``total_warmup`` (it fixes the Halton offset and the mass-freeze
    step); extending warmup beyond the plan, or drawing before the plan is
    complete, raises. Config args (``mass``/``target_accept``/
    ``max_leapfrog``/``adapt_mass``) are not state and must be
    re-passed."""
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
    chains = state.x.shape[0]
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    _check_resume_mass_mode(adapt_mass, state.var_ema, state.lr_Q)
    return _chees_core(
        obj, state, mass, n_samples, n_warmup, target_accept, max_leapfrog,
        adapt_mass, value_and_grad_fn, i_warm0, i_samp0, n_total,
        int(state.mass_freeze),
    )


class NUTSState(NamedTuple):
    """Resumable state for `nuts_sample`: positions, cached (logdensity,
    gradient), the per-chain dual-averaging accumulators, the
    fleet-variance mass EMA, the base RNG key, and the phase counters.
    ``n_warmup_total`` / ``mass_freeze`` pin the freeze schedule so
    chunked runs replay the long run exactly. Serializable via
    `utils.checkpoint.save_state`."""

    x: jax.Array  # (chains, n)
    f: jax.Array  # (chains,)
    g: jax.Array  # (chains, n) gradient at x
    log_eps: jax.Array  # (chains,)
    log_eps_bar: jax.Array  # (chains,)
    h_bar: jax.Array  # (chains,)
    t_da: jax.Array  # ()
    mu: jax.Array  # ()
    var_ema: jax.Array  # (n,) variance or (n, n) covariance EMA
    key: jax.Array
    i_warm: jax.Array  # () int32
    i_samp: jax.Array  # () int32
    n_warmup_total: jax.Array  # () int32
    mass_freeze: jax.Array  # () int32
    # adapt_mass='lowrank' only (round 4): the tracked covariance
    # subspace — None in every other mode (old checkpoints load as None)
    lr_Q: Optional[jax.Array] = None  # (n, r) orthonormal basis
    lr_sig: Optional[jax.Array] = None  # (r,) eigenvalues along lr_Q
    # warmup depth telemetry (round 4): per-chain tree-depth SUMS over
    # the two tail windows of the warmup plan (`_warm_depth_windows`) —
    # free probe data for `nuts_sample_depth_sorted` (no probe legs).
    # None on pre-telemetry checkpoints (the sorter falls back to legs).
    warm_dsum: Optional[jax.Array] = None  # (2, chains)


class NUTSResult(NamedTuple):
    """Samples and diagnostics for a batched NUTS run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_prob: (chains,) mean leaf acceptance-probability surrogate
    step_size: (chains,) adapted leapfrog step size
    mean_tree_depth: (chains,) mean doublings per draw over sampling
    mass_diag: (n,) the (possibly fleet-adapted) diagonal preconditioner
    energies: (n_samples, chains) post-momentum-refresh Hamiltonian of
        each transition — feed `diagnostics.energy_bfmi` for the
        Betancourt E-BFMI check
    divergences: (chains,) int32 count of draws whose tree hit a
        divergent leaf (energy error past ``max_energy_change``)
    final_x: (chains, n) last state
    state: NUTSState — resume via `nuts_sample_from_state`
    """

    samples: jax.Array
    accept_prob: jax.Array
    step_size: jax.Array
    mean_tree_depth: jax.Array
    mass_diag: jax.Array
    energies: jax.Array
    divergences: jax.Array
    final_x: jax.Array
    state: NUTSState


@partial(
    jax.jit,
    static_argnames=(
        "obj", "value_and_grad_fn", "n_samples", "n_warmup",
        "max_depth", "target_accept", "max_energy_change", "adapt_mass",
        "i_warm0", "i_samp0", "mass_freeze", "warm_total",
    ),
)
def _nuts_core(
    obj, state: NUTSState, mass, n_samples, n_warmup, max_depth,
    target_accept, max_energy_change, adapt_mass, value_and_grad_fn,
    i_warm0, i_samp0, mass_freeze, warm_total,
) -> NUTSResult:
    """Chunkable core (see `_hmc_core` for the key-stream discipline);
    the docstring lives on `nuts_sample`.

    Batched multinomial NUTS (iterative formulation) over lockstep chains.

    The No-U-Turn Sampler (Hoffman & Gelman 2014) with the modern
    refinements Stan ships: multinomial sampling over the trajectory
    (progressive within a subtree, biased toward the new subtree between
    subtrees — Betancourt 2017), iterative tree building with a
    checkpoint stack of O(max_depth) boundary states (the jittable
    formulation, cf. numpyro's iterative NUTS), dual-averaged per-chain
    step sizes driven by the standard leaf acceptance-probability
    surrogate, divergence rejection at ``max_energy_change``, and (with
    ``adapt_mass``, no explicit ``mass``) the same fleet-diagonal mass
    adaptation as `chees_sample` — the across-chain variance EMA, frozen
    at warmup/2. Better preconditioning here is a direct throughput
    lever: each doubling costs 2^j gradient evaluations, so shallower
    trees on rescaled targets pay immediately.

    fleet shape discipline: everything is hand-batched over the chains
    axis with explicit masks (like the fleet solvers) — trees double in
    lockstep, chains that have U-turned/diverged are frozen, and the two
    loops (doublings; leaves within a subtree) are `lax.while_loop`s
    with cross-chain any-reduces, so a round ends as soon as EVERY chain
    is done. The price of lockstep NUTS is that all chains wait for the
    deepest tree each draw; `chees_sample` is the accelerator-native alternative
    that avoids this by construction (see docs/design.md) — NUTS is here
    for parity with CPU/GPU workflows and for single/few-chain use.

    U-turn checks between a stored checkpoint and the current leaf use
    forward-time orientation dx = d * (x - x_ckpt) (leapfrog with -eps
    traces the forward trajectory into the past, so stored momenta are
    already forward-convention).
    """
    vag = as_value_and_grad(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=0, out_axes=(0, 0))

    chains, n = state.x.shape
    dtype = state.x.dtype
    mass_b, chol_u = _mass_setup(mass, n, dtype)
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def leapfrog_step(x, p, g, eps_d, mass_d):
        """One leapfrog step; eps_d: (chains,) signed. Returns the new
        (x, p, g, f) — ONE value_and_grad per leaf."""
        e = eps_d[:, None]
        p_half = p + 0.5 * e * g
        x2 = x + e * _apply_mass(mass_d, p_half)
        f2, g2 = vag_b(x2)
        p2 = p_half + 0.5 * e * g2
        return x2, p2, g2, f2

    def no_uturn(dx, p_a, p_b, mass_d):
        """True where NOT turning: dx oriented forward-time."""
        va = _apply_mass(mass_d, p_a)
        vb = _apply_mass(mass_d, p_b)
        return (jnp.sum(dx * va, axis=1) >= 0.0) & (
            jnp.sum(dx * vb, axis=1) >= 0.0
        )

    max_e = jnp.asarray(max_energy_change, dtype)

    def build_subtree(x_s, p_s, g_s, d, n_leaf, eps, h0, k, alive, mass_d):
        """Integrate n_leaf leaves from (x_s, p_s) in direction d (+-1),
        multinomial-sampling a proposal and checking U-turns iteratively.

        Checkpoint scheme (derived in-line): leaf i (0-based) stores its
        state at stack slot popcount(i) when i is even; when i is odd,
        the subtrees ending at i span [i - 2^k + 1, i] for k = 1..t
        (t = trailing one-bits of i) and their start states sit at slots
        popcount(i) - k — no slot is overwritten before its check
        because any store between start s and end i adds set bits."""
        eps_d = d.astype(dtype) * eps

        stack_x = jnp.zeros((max_depth + 1, chains, n), dtype)
        stack_p = jnp.zeros((max_depth + 1, chains, n), dtype)

        def cond(c):
            (i, x, p, g, lw, xp, fp, gp, turn, div, sa, na, sx, sp) = c
            ok = alive & ~turn & ~div
            return jnp.logical_and(i < n_leaf, jnp.any(ok))

        def body(c):
            (i, x, p, g, lw, xp, fp, gp, turn, div, sa, na, sx, sp) = c
            act = alive & ~turn & ~div
            x2, p2, g2, f2 = leapfrog_step(x, p, g, eps_d, mass_d)
            lw_leaf = f2 - _kinetic(p2, mass_d) - h0
            bad = ~jnp.isfinite(lw_leaf) | (lw_leaf < -max_e)
            div = div | (act & bad)
            ok = act & ~bad
            alpha = jnp.exp(jnp.minimum(lw_leaf, 0.0))
            alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
            # progressive multinomial: take the new leaf w.p. w/W
            lw_new = jnp.logaddexp(lw, lw_leaf)
            u = jax.random.uniform(jax.random.fold_in(k, i), (chains,), dtype)
            take = ok & (u < jnp.exp(lw_leaf - lw_new))
            xp = jnp.where(take[:, None], x2, xp)
            fp = jnp.where(take, f2, fp)
            gp = jnp.where(take[:, None], g2, gp)
            lw = jnp.where(ok, lw_new, lw)

            slot = lax.population_count(i)
            even = (i % 2) == 0

            def store(sx_sp):
                sx, sp = sx_sp
                cur_x = lax.dynamic_index_in_dim(sx, slot, keepdims=False)
                cur_p = lax.dynamic_index_in_dim(sp, slot, keepdims=False)
                new_x = jnp.where(ok[:, None], x2, cur_x)
                new_p = jnp.where(ok[:, None], p2, cur_p)
                sx = lax.dynamic_update_index_in_dim(sx, new_x, slot, 0)
                sp = lax.dynamic_update_index_in_dim(sp, new_p, slot, 0)
                return sx, sp

            def check(sx_sp):
                sx, sp = sx_sp
                t_ones = lax.population_count(i ^ (i + 1)) - 1

                def chk(kk, turn_acc):
                    do = kk <= t_ones
                    ck = jnp.maximum(slot - kk, 0)
                    x_ck = lax.dynamic_index_in_dim(sx, ck, keepdims=False)
                    p_ck = lax.dynamic_index_in_dim(sp, ck, keepdims=False)
                    dx = d.astype(dtype)[:, None] * (x2 - x_ck)
                    good = no_uturn(dx, p_ck, p2, mass_d)
                    return turn_acc | (do & ok & ~good)

                # traced upper bound: average trailing-ones of an odd
                # leaf is ~2, so sweeping to max_depth with a mask wastes
                # ~4x the checkpoint reads on the per-leaf hot path
                turn_new = lax.fori_loop(1, t_ones + 1, chk,
                                         jnp.zeros_like(turn))
                return turn_new

            sx, sp = lax.cond(even, store, lambda s: s, (sx, sp))
            turn = turn | lax.cond(
                even, lambda s: jnp.zeros_like(turn), check, (sx, sp)
            )

            sa = sa + jnp.where(act, alpha, 0.0)
            na = na + act.astype(jnp.int32)
            # frozen lanes keep their previous endpoint state
            m = ok[:, None]
            return (i + 1, jnp.where(m, x2, x), jnp.where(m, p2, p),
                    jnp.where(m, g2, g), lw, xp, fp, gp, turn, div, sa, na,
                    sx, sp)

        c0 = (
            jnp.zeros((), jnp.int32), x_s, p_s, g_s,
            jnp.full((chains,), neg_inf), x_s,
            jnp.zeros((chains,), dtype), g_s,
            jnp.zeros((chains,), bool), jnp.zeros((chains,), bool),
            jnp.zeros((chains,), dtype), jnp.zeros((chains,), jnp.int32),
            stack_x, stack_p,
        )
        (_, x_e, p_e, g_e, lw, xp, fp, gp, turn, div, sa, na, _, _) = (
            lax.while_loop(cond, body, c0)
        )
        return x_e, p_e, g_e, lw, xp, fp, gp, turn, div, sa, na

    def one_draw(x, f, g, eps, mass_d, k, chol_d=None):
        """One NUTS transition for all chains. Returns the new (x, f, g),
        the mean leaf-acceptance surrogate, the tree depth, the
        start-of-trajectory Hamiltonian (for E-BFMI — the multinomial
        proposal's own momentum is never materialized; trajectories
        conserve H to integrator error, so the post-momentum-refresh
        energy carries the same marginal/transition content), and the
        per-chain divergence flag. ``chol_d`` as in chees's round_:
        precomputed for a static dense mass, None for the fleet-adapted
        dense EMA (factored per draw)."""
        kp, kd = jax.random.split(k)
        p0 = _draw_momentum(kp, chains, n, dtype, mass_d, chol_d)
        h0 = f - _kinetic(p0, mass_d)

        def cond(c):
            return jnp.logical_and(c[0] < max_depth, jnp.any(~c[-1]))

        def body(c):
            (j, x_l, p_l, g_l, x_r, p_r, g_r, xp, fp, gp, lw_tot,
             sa, na, depth, divflag, done) = c
            kj = jax.random.fold_in(kd, j)
            d = jax.random.rademacher(
                jax.random.fold_in(kj, 0), (chains,), jnp.int32
            )
            fwd = d > 0
            x_s = jnp.where(fwd[:, None], x_r, x_l)
            p_s = jnp.where(fwd[:, None], p_r, p_l)
            g_s = jnp.where(fwd[:, None], g_r, g_l)
            (x_e, p_e, g_e, st_lw, st_xp, st_fp, st_gp, st_turn, st_div,
             st_sa, st_na) = build_subtree(
                x_s, p_s, g_s, d, jnp.int32(2) ** j, eps, h0,
                jax.random.fold_in(kj, 1), ~done, mass_d,
            )
            ok = ~done & ~st_turn & ~st_div
            # biased progressive between subtrees: favor the new one
            u = jax.random.uniform(
                jax.random.fold_in(kj, 2), (chains,), dtype
            )
            take = ok & (u < jnp.exp(jnp.minimum(st_lw - lw_tot, 0.0)))
            xp = jnp.where(take[:, None], st_xp, xp)
            fp = jnp.where(take, st_fp, fp)
            gp = jnp.where(take[:, None], st_gp, gp)
            lw_tot = jnp.where(ok, jnp.logaddexp(lw_tot, st_lw), lw_tot)

            okm = (ok & fwd)[:, None]
            x_r = jnp.where(okm, x_e, x_r)
            p_r = jnp.where(okm, p_e, p_r)
            g_r = jnp.where(okm, g_e, g_r)
            okm = (ok & ~fwd)[:, None]
            x_l = jnp.where(okm, x_e, x_l)
            p_l = jnp.where(okm, p_e, p_l)
            g_l = jnp.where(okm, g_e, g_l)

            # global U-turn across the merged tree's true-time ends
            turn_g = ~no_uturn(x_r - x_l, p_l, p_r, mass_d)
            depth = depth + ok.astype(jnp.int32)
            sa = sa + jnp.where(~done, st_sa, 0.0)
            na = na + jnp.where(~done, st_na, 0)
            divflag = divflag | st_div
            done = done | st_turn | st_div | (ok & turn_g)
            return (j + 1, x_l, p_l, g_l, x_r, p_r, g_r, xp, fp, gp,
                    lw_tot, sa, na, depth, divflag, done)

        c0 = (
            jnp.zeros((), jnp.int32), x, p0, g, x, p0, g, x, f, g,
            jnp.zeros((chains,), dtype),  # initial leaf weight exp(0)
            jnp.zeros((chains,), dtype), jnp.zeros((chains,), jnp.int32),
            jnp.zeros((chains,), jnp.int32), jnp.zeros((chains,), bool),
            jnp.zeros((chains,), bool),
        )
        (_, _xl, _pl, _gl, _xr, _pr, _gr, xp, fp, gp, _lw, sa, na,
         depth, divflag, _done) = lax.while_loop(cond, body, c0)
        alpha = sa / jnp.maximum(na, 1).astype(dtype)
        return xp, fp, gp, alpha, depth, -h0, divflag

    # first-ever call: populate the cached (logdensity, gradient)
    if i_warm0 == 0 and i_samp0 == 0:
        f0, g0 = vag_b(state.x)
    else:
        f0, g0 = state.f, state.g
    k_warm = jax.random.fold_in(state.key, 0)
    k_samp = jax.random.fold_in(state.key, 1)

    # ---- warmup: per-chain dual averaging + fleet mass ----
    w1s, w2s, w2e, _W = _warm_depth_windows(warm_total)

    def make_warm_body(frozen_chol=None, frozen=False):
      def warm_body(carry, i):
        (x, f, g, log_eps, log_eps_bar, h_bar, t, var_ema, lr_Q, lr_sig,
         wds) = carry
        k = jax.random.fold_in(k_warm, i)
        if adapt_mass == "lowrank":
            # diag-EMA outer scale x standardized low-rank core;
            # closed-form roots via LowRankMass — see _lowrank_metric
            mass_d = _lowrank_metric(var_ema, lr_Q, lr_sig)
            chol_d = None
        elif adapt_mass:
            mass_d, chol_d = var_ema, frozen_chol
        else:
            mass_d, chol_d = mass_b, chol_u
        x, f, g, alpha, depth, _e, _d = one_draw(
            x, f, g, jnp.exp(log_eps), mass_d, k, chol_d
        )
        # depth telemetry over the plan's two tail windows — free probe
        # data for nuts_sample_depth_sorted (post-freeze rounds, so eps
        # is near-final and depths match the sampling phase)
        df = depth.astype(dtype)
        wds = wds + jnp.stack([
            jnp.where((i >= w1s) & (i < w2s), df, 0.0),
            jnp.where((i >= w2s) & (i < w2e), df, 0.0),
        ])
        log_eps, log_eps_bar, h_bar, t = _da_update(
            h_bar, log_eps_bar, t, target_accept - alpha, state.mu
        )
        if frozen_chol is None and adapt_mass == "dense":
            # full across-chain covariance EMA (fleet-as-estimator);
            # PD: mixes the PD carry with a ridged PSD sample covariance
            xc = x - jnp.mean(x, axis=0, keepdims=True)
            cov_now = xc.T @ xc / (chains - 1)
            cov_now = cov_now + 1e-8 * jnp.eye(n, dtype=dtype) * (
                1.0 + jnp.trace(cov_now) / n
            )
            upd = i < mass_freeze
            var_ema = jnp.where(upd, 0.9 * var_ema + 0.1 * cov_now, var_ema)
        elif (not frozen) and adapt_mass == "lowrank":
            upd = i < mass_freeze
            lr_Q, lr_sig, var_ema = _lowrank_mass_step(
                x, var_ema, lr_Q, lr_sig, upd, chains
            )
        elif frozen_chol is None and adapt_mass and adapt_mass != "lowrank":
            # same fleet estimator as chees_sample: across-chain variance
            # EMA, frozen at warmup/2 so eps re-adapts to the final metric
            var_now = jnp.maximum(jnp.var(x, axis=0), 1e-10)
            upd = i < mass_freeze
            var_ema = jnp.where(upd, 0.9 * var_ema + 0.1 * var_now, var_ema)
        return (
            (x, f, g, log_eps, log_eps_bar, h_bar, t, var_ema,
             lr_Q, lr_sig, wds),
            None,
        )

      return warm_body

    wds0 = (
        jnp.zeros((2, chains), dtype)
        if state.warm_dsum is None
        else state.warm_dsum
    )
    carry_w = (state.x, f0, g0, state.log_eps, state.log_eps_bar,
               state.h_bar, state.t_da, state.var_ema,
               state.lr_Q, state.lr_sig, wds0)
    if n_warmup > 0:
        # split at the (static) freeze step — see _chees_core
        n_a = max(0, min(n_warmup, int(mass_freeze) - i_warm0))
        n_b = n_warmup - n_a
        if n_a > 0:
            carry_w, _ = lax.scan(
                make_warm_body(None), carry_w, i_warm0 + jnp.arange(n_a)
            )
        if n_b > 0:
            frozen = (
                jnp.linalg.cholesky(carry_w[7]).T
                if adapt_mass == "dense"
                else None
            )
            carry_w, _ = lax.scan(
                make_warm_body(frozen, frozen=True), carry_w,
                i_warm0 + n_a + jnp.arange(n_b),
            )
    (x, f, g, log_eps, log_eps_bar, h_bar, t_da, var_ema,
     lr_Q, lr_sig, warm_dsum) = carry_w
    eps_final = jnp.exp(log_eps_bar)
    if adapt_mass == "lowrank":
        mass_final = _lowrank_metric(var_ema, lr_Q, lr_sig)
    else:
        mass_final = var_ema if adapt_mass else mass_b
    chol_final = (
        jnp.linalg.cholesky(mass_final).T
        if adapt_mass == "dense"
        else (chol_u if not adapt_mass else None)
    )

    # ---- sampling at the adapted (eps, mass) ----
    def sample_body(carry, j):
        x, f, g = carry
        x, f, g, alpha, depth, e, dv = one_draw(
            x, f, g, eps_final, mass_final, jax.random.fold_in(k_samp, j),
            chol_final,
        )
        return (x, f, g), (x, alpha, depth, e, dv)

    (x, f, g), (samples, alphas, depths, energies, divs) = lax.scan(
        sample_body, (x, f, g), i_samp0 + jnp.arange(n_samples)
    )
    out_state = NUTSState(
        x=x, f=f, g=g, log_eps=log_eps, log_eps_bar=log_eps_bar,
        h_bar=h_bar, t_da=t_da, mu=state.mu, var_ema=var_ema,
        key=state.key,
        i_warm=jnp.asarray(i_warm0 + n_warmup, jnp.int32),
        i_samp=jnp.asarray(i_samp0 + n_samples, jnp.int32),
        n_warmup_total=state.n_warmup_total,
        mass_freeze=jnp.asarray(mass_freeze, jnp.int32),
        lr_Q=lr_Q, lr_sig=lr_sig, warm_dsum=warm_dsum,
    )
    return NUTSResult(
        samples=samples,
        accept_prob=jnp.mean(alphas, axis=0),
        step_size=eps_final,
        mean_tree_depth=jnp.mean(depths.astype(dtype), axis=0),
        mass_diag=_mass_diag(mass_final),
        energies=energies,
        divergences=jnp.sum(divs.astype(jnp.int32), axis=0),
        final_x=x,
        state=out_state,
    )


def nuts_sample(
    obj,
    key: jax.Array,
    x0s: jax.Array,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass: Optional[jax.Array] = None,  # (n,n) dense / (n,) diag ~ cov
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
    total_warmup: Optional[int] = None,
    mass_rank: int = 16,
) -> NUTSResult:
    """Batched multinomial NUTS over lockstep chains — see `_nuts_core`
    for the full algorithm notes (iterative tree building, checkpoint
    stack, fleet-diagonal mass adaptation, fleet shape discipline).

    ``adapt_mass`` accepts the same modes as `chees_sample`: True/diag,
    'dense' (full across-chain covariance EMA), and 'lowrank' (round 4:
    top-``mass_rank`` eigenspace via per-round subspace iteration,
    sampling through the closed-form `LowRankMass` metric — the
    large-n answer where dense is O(n²)/round). Correlation-aware mass
    is a direct NUTS throughput lever: each doubling costs 2^depth
    gradients, and a better metric is what shrinks the depth.

    The result carries a resumable `state`; `nuts_sample_from_state`
    continues the run trajectory-identically. For CHUNKED warmup announce
    the plan with ``total_warmup`` (pins the mass-freeze step) and run
    ``n_warmup <= total_warmup`` steps now, the rest via the resume entry
    point.
    """
    x0s = jnp.asarray(x0s)
    chains, n = x0s.shape
    dtype = x0s.dtype
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
            "n_samples=0 and finish warmup via nuts_sample_from_state"
        )
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    var0 = (
        jnp.eye(n, dtype=dtype)
        if adapt_mass == "dense"
        else jnp.ones((n,), dtype)
    )
    if adapt_mass == "lowrank":
        lr_Q0, lr_sig0 = _lowrank_mass_init(mass_rank, n, chains, dtype)
    else:
        lr_Q0 = lr_sig0 = None
    log_eps0 = jnp.full((chains,), jnp.log(jnp.asarray(step_size, dtype)))
    state0 = NUTSState(
        x=x0s,
        f=jnp.full((chains,), jnp.nan, dtype),
        g=jnp.zeros_like(x0s),
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=jnp.zeros((chains,), dtype),
        t_da=jnp.zeros((), dtype),
        mu=jnp.log(10.0 * jnp.asarray(step_size, dtype)),
        var_ema=var0,
        key=key,
        i_warm=jnp.zeros((), jnp.int32),
        i_samp=jnp.zeros((), jnp.int32),
        n_warmup_total=jnp.asarray(total_warmup, jnp.int32),
        mass_freeze=jnp.asarray(max(total_warmup // 2, 1), jnp.int32),
        lr_Q=lr_Q0,
        lr_sig=lr_sig0,
        warm_dsum=jnp.zeros((2, chains), dtype),
    )
    return _nuts_core(
        obj, state0, mass, n_samples, n_warmup, max_depth, target_accept,
        max_energy_change, adapt_mass, value_and_grad_fn, 0, 0,
        max(total_warmup // 2, 1), total_warmup,
    )


def nuts_sample_from_state(
    obj,
    state: NUTSState,
    mass: Optional[jax.Array] = None,
    n_samples: int = 0,
    n_warmup: int = 0,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
) -> NUTSResult:
    """Continue a `nuts_sample` run from its saved state; same chunking
    contract as `chees_sample_from_state` (config args re-passed, phases
    monotone, warmup plan pinned by the first call)."""
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
    chains = state.x.shape[0]
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    _check_resume_mass_mode(adapt_mass, state.var_ema, state.lr_Q)
    return _nuts_core(
        obj, state, mass, n_samples, n_warmup, max_depth, target_accept,
        max_energy_change, adapt_mass, value_and_grad_fn, i_warm0, i_samp0,
        int(state.mass_freeze), n_total,
    )


# ---------------------------------------------------------------------------
# Depth-sorted NUTS sub-fleets (round-4 measured win on heterogeneous targets)
# ---------------------------------------------------------------------------

_NUTS_CHAIN_FIELDS = ("x", "f", "g", "log_eps", "log_eps_bar", "h_bar")


def _warm_depth_windows(total: int):
    """The two tail windows of a warmup plan used for depth telemetry:
    W rounds each (W = min(32, total // 4), >= 1), ending at the plan's
    last round — post-freeze, so the step size is near-final and tree
    depths are representative of the sampling phase."""
    W = max(1, min(32, total // 4))
    return total - 2 * W, total - W, total, W


class DepthSortInfo(NamedTuple):
    """What `nuts_sample_depth_sorted` decided and why.

    sorted: whether the sub-fleet path ran (False = persistence or spread
        below threshold; the draws are then bitwise-identical to a plain
        `nuts_sample_from_state` run of the same length)
    persistence: leg-to-leg Pearson r of per-chain mean tree depth across
        the two probe legs (nan when the fleet has no depth spread)
    depth_spread: max - min per-chain mean depth on the second probe leg
    group_sizes: chains per sub-fleet (empty when not sorted)
    group_mean_depths: mean tree depth per sub-fleet over the main leg
    """

    sorted: bool
    persistence: float
    depth_spread: float
    group_sizes: tuple
    group_mean_depths: tuple


def _nuts_take_chains(state: NUTSState, idx) -> NUTSState:
    """Sub-fleet view of a NUTS state: per-chain fields gathered at
    ``idx``; the fleet-shared fields (mass EMA, DA clock, key, phase
    counters) ride along unchanged."""
    out = state._replace(
        **{k: getattr(state, k)[idx] for k in _NUTS_CHAIN_FIELDS}
    )
    if state.warm_dsum is not None:
        out = out._replace(warm_dsum=state.warm_dsum[:, idx])
    return out


def nuts_sample_depth_sorted(
    obj,
    state: NUTSState,
    n_samples: int,
    mass: Optional[jax.Array] = None,
    groups: int = 4,
    probe_draws: int = 16,
    min_persistence: float = 0.5,
    min_depth_spread: float = 0.25,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
):
    """Post-warmup NUTS sampling with depth-homogeneous sub-fleets.

    Lockstep NUTS charges every chain the FLEET-MAX tree work per draw.
    When per-chain tree depth is *recurringly* predictable — chains in
    tighter regions of the target keep needing deeper trees — sorting
    chains by recent mean depth into ``groups`` sub-fleets cuts
    sum(group_size x group_max_work) below fleet_size x fleet_max_work.
    It can pay on Neal's funnel (depth spread [1, 9], leg-to-leg
    persistence r = 0.90) and loses on a depth-homogeneous correlated
    Gaussian (spread [3.0, 3.3]), where the split only adds dispatch
    cost — which is why this entry point probes first and only sorts
    when the geometry can pay.

    Probe data: the NUTS warmup records per-chain tree-depth telemetry
    over the plan's two tail windows (``NUTSState.warm_dsum`` — free:
    those rounds run anyway, post-freeze, at near-final step size), so
    by default NO probe draws are spent — all ``n_samples`` draws run
    sorted. States from pre-telemetry checkpoints (``warm_dsum=None``)
    fall back to the explicit protocol: two full-fleet probe legs of
    ``probe_draws`` each (real post-warmup draws, counted toward
    ``n_samples``). Either way, two per-chain mean-depth vectors d1/d2
    are measured; if their across-chain Pearson r reaches
    ``min_persistence`` AND the depth spread reaches ``min_depth_spread``
    doublings, chains sort into ``groups`` contiguous depth classes and
    the remaining draws run per sub-fleet, scattered back to the
    original chain order.

    RNG: the fleet key stream is position-indexed, so sub-fleets must
    NOT share the parent stream (chains at the same position would draw
    identical momenta). Each sub-fleet continues under
    ``fold_in(state.key, 2 + group)``; the sorted path is therefore
    distributionally equivalent but not bitwise-identical to the
    unsorted run. The fallback (unsorted) path IS bitwise-identical to
    a plain ``nuts_sample_from_state`` run of the same length.

    Returns ``(NUTSResult, DepthSortInfo)``. The result's ``state`` is
    merged back to the original chain order under the parent key and is
    resumable by any NUTS entry point (a plain resume continues on the
    parent stream; draws already taken on group streams do not overlap
    it).

    Requires a completed warmup plan (mass and DA schedules are fleet-
    shared and frozen; sorting during adaptation would bias the
    across-chain estimators).
    """
    if int(state.i_warm) < int(state.n_warmup_total):
        raise ValueError(
            "nuts_sample_depth_sorted requires a completed warmup plan "
            f"(state has {int(state.i_warm)} of "
            f"{int(state.n_warmup_total)} steps); finish warmup via "
            "nuts_sample / nuts_sample_from_state first"
        )
    chains = state.x.shape[0]
    if groups < 1:
        raise ValueError(f"groups must be >= 1 (got {groups})")
    if groups > chains:
        raise ValueError(
            f"groups ({groups}) exceeds the chain count ({chains})"
        )
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0 (got {n_samples})")

    kw = dict(
        mass=mass, max_depth=max_depth, target_accept=target_accept,
        max_energy_change=max_energy_change, adapt_mass=adapt_mass,
        value_and_grad_fn=value_and_grad_fn,
    )

    def plain(st, n):
        return nuts_sample_from_state(obj, st, n_samples=n, **kw)

    import numpy as np

    have_telemetry = state.warm_dsum is not None and bool(
        np.asarray(jnp.sum(state.warm_dsum[1])) > 0
    )
    if groups == 1 or n_samples <= 0 or (
        not have_telemetry and (probe_draws <= 0
                                or n_samples <= 2 * probe_draws)
    ):
        res = plain(state, n_samples)
        info = DepthSortInfo(
            sorted=False, persistence=float("nan"),
            depth_spread=float("nan"), group_sizes=(),
            group_mean_depths=(),
        )
        return res, info

    if have_telemetry:
        # free probe data from the warmup's tail windows
        _w1s, _w2s, _w2e, W = _warm_depth_windows(
            int(state.n_warmup_total)
        )
        wds = np.asarray(state.warm_dsum, dtype=np.float64)
        d1, d2 = wds[0] / W, wds[1] / W
        pre = []  # no probe legs spent
        st = state
        remaining = n_samples
    else:
        p1 = plain(state, probe_draws)
        p2 = plain(p1.state, probe_draws)
        d1 = np.asarray(p1.mean_tree_depth, dtype=np.float64)
        d2 = np.asarray(p2.mean_tree_depth, dtype=np.float64)
        pre = [(probe_draws, p1), (probe_draws, p2)]
        st = p2.state
        remaining = n_samples - 2 * probe_draws

    spread = float(d2.max() - d2.min())
    if d1.std() > 0.0 and d2.std() > 0.0:
        persistence = float(np.corrcoef(d1, d2)[0, 1])
    else:
        persistence = float("nan")

    def merge_legs(legs):
        """Concatenate (n_draws, result) legs in original chain order."""
        samples = jnp.concatenate([r.samples for _, r in legs])
        tot = sum(w for w, _ in legs)
        acc = sum(w * r.accept_prob for w, r in legs) / tot
        dep = sum(w * r.mean_tree_depth for w, r in legs) / tot
        return legs[-1][1]._replace(
            samples=samples, accept_prob=acc, mean_tree_depth=dep,
            energies=jnp.concatenate([r.energies for _, r in legs]),
            divergences=sum(r.divergences for _, r in legs),
        )

    if not (persistence >= min_persistence and spread >= min_depth_spread):
        # geometry can't pay: run unsorted — with telemetry this is
        # bitwise ONE plain call; with probe legs, the chunked-identity
        # contract makes legs+tail bitwise one plain run of n_samples
        tail = plain(st, remaining)
        res = merge_legs(pre + [(remaining, tail)])
        info = DepthSortInfo(
            sorted=False, persistence=persistence, depth_spread=spread,
            group_sizes=(), group_mean_depths=(),
        )
        return res, info

    order = np.argsort(d2, kind="stable")
    group_idx = np.array_split(order, groups)
    sub_results = []
    for gi, idx in enumerate(group_idx):
        sub = _nuts_take_chains(st, jnp.asarray(idx))
        # decorrelate: the parent stream is position-indexed (momenta
        # are drawn (chains, n) from one fleet key)
        sub = sub._replace(key=jax.random.fold_in(st.key, 2 + gi))
        sub_results.append(plain(sub, remaining))

    inv = np.empty_like(order)
    inv[order] = np.arange(chains)

    def scatter(parts, axis):
        cat = jnp.concatenate(parts, axis=axis)
        return jnp.take(cat, jnp.asarray(inv), axis=axis)

    samples_main = scatter([r.samples for r in sub_results], 1)
    acc_main = scatter([r.accept_prob for r in sub_results], 0)
    dep_main = scatter([r.mean_tree_depth for r in sub_results], 0)
    final_x = scatter([r.final_x for r in sub_results], 0)
    energies = jnp.concatenate(
        [r.energies for _, r in pre]
        + [scatter([r.energies for r in sub_results], 1)]
    )
    divergences = sum(r.divergences for _, r in pre) + scatter(
        [r.divergences for r in sub_results], 0
    )

    samples = jnp.concatenate(
        [r.samples for _, r in pre] + [samples_main]
    )
    acc = (
        sum(w * r.accept_prob for w, r in pre) + remaining * acc_main
    ) / n_samples
    dep = (
        sum(w * r.mean_tree_depth for w, r in pre) + remaining * dep_main
    ) / n_samples

    merged = st._replace(
        key=st.key,  # parent stream; group streams were fold_in(key, 2+g)
        i_samp=sub_results[0].state.i_samp,
        t_da=sub_results[0].state.t_da,
        var_ema=sub_results[0].state.var_ema,
        **{
            k: scatter([getattr(r.state, k) for r in sub_results], 0)
            for k in _NUTS_CHAIN_FIELDS
        },
    )
    if st.warm_dsum is not None:
        merged = merged._replace(
            warm_dsum=scatter(
                [r.state.warm_dsum for r in sub_results], 1
            )
        )
    res = NUTSResult(
        samples=samples,
        accept_prob=acc,
        step_size=scatter([r.step_size for r in sub_results], 0),
        mean_tree_depth=dep,
        mass_diag=sub_results[0].mass_diag,
        energies=energies,
        divergences=divergences,
        final_x=final_x,
        state=merged,
    )
    info = DepthSortInfo(
        sorted=True, persistence=persistence, depth_spread=spread,
        group_sizes=tuple(len(ix) for ix in group_idx),
        group_mean_depths=tuple(
            float(jnp.mean(r.mean_tree_depth)) for r in sub_results
        ),
    )
    return res, info
