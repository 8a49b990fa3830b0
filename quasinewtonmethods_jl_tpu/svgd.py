"""Stein variational gradient descent: deterministic particle inference.

The MCMC-free member of the MAP→posterior toolbox (net-new capability;
the reference stops at the MAP engine, SURVEY.md §1 L4): a fleet of
particles descends the KL divergence to the posterior along the kernel
Stein direction

    φ(x_i) = (1/B) Σ_j [ k(x_j, x_i) ∇log p(x_j) + ∇_{x_j} k(x_j, x_i) ]

— the first term transports particles toward probability mass, the
second repulses them apart so the FLEET approximates the posterior
instead of collapsing onto the mode (Liu & Wang 2016).

accelerator-first shape: the entire interaction is dense (B, B) linear algebra —
the pairwise squared distances and both φ terms are matmuls
(‖xi−xj‖² via the xxᵀ expansion; K@G and K@X contractions), the gradient
fleet is one vmapped sweep, and the step loop is a fixed-length
`lax.scan` (no data-dependent control flow anywhere — SVGD is
deterministic given the particles, there is no accept/reject). O(B²·n)
per step, exactly the arithmetic-intensity profile matmul units want.

Median-heuristic bandwidth is recomputed on device each step; steps use
the paper's AdaGrad rule (per-coordinate, with the fudge factor) so one
`step_size` works across scales. Resumable `SVGDState` with the
chunked == long-run identity contract (everything is deterministic), and
the usual checkpoint registry.

Use it where chains struggle to be worth their warmup: moderate-n
posteriors needing a few hundred representative points, initialization
of chain fleets, or quick posterior visualisation. For exact asymptotics
use the HMC family; for evidence use laplace/AIS/bridge.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .api import as_value_and_grad

SVGD_STEPS_DEFAULT = 500


class SVGDState(NamedTuple):
    """Resumable SVGD carry: particles + AdaGrad accumulator + step count."""

    x: jax.Array  # (B, n) particles
    acc: jax.Array  # (B, n) AdaGrad squared-gradient accumulator
    k: jax.Array  # () int32 steps executed


class SVGDResult(NamedTuple):
    """particles ~ posterior; logp/grad are the final fleet evaluations
    (diagnostics — NaN lanes mean the objective failed at that particle)."""

    particles: jax.Array  # (B, n)
    logp: jax.Array  # (B,)
    grad: jax.Array  # (B, n) ∇log p at the particles
    bandwidth: jax.Array  # () final median-heuristic h
    n_steps: jax.Array  # () int32 total steps
    state: SVGDState  # resumable via svgd_from_state


def _pairwise_sq(X):
    """(B, B) squared distances via the xxᵀ expansion — one matmul."""
    sq = jnp.sum(X * X, axis=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    return jnp.maximum(d2, 0.0)


def _phi(X, G, d2, h):
    """Kernel Stein direction for the whole fleet — all matmul contractions.

    K_ij = exp(−‖x_i − x_j‖² / h);
    φ_i = (1/B)[ (KᵀG)_i + (2/h)(x_i·Σ_j K_ij − (KᵀX)_i ) ]  (K symmetric).
    """
    B = X.shape[0]
    K = jnp.exp(-d2 / h)
    ksum = jnp.sum(K, axis=-1)
    drive = K @ G
    repulse = (2.0 / h) * (X * ksum[:, None] - K @ X)
    return (drive + repulse) / B


_MEDIAN_CAP = 65536  # elements fed to the per-step median sort


def _median_bandwidth(d2, B, dtype):
    """med(‖xi−xj‖²)/log(B+1), floored away from zero (a collapsed fleet
    must not divide by 0 — the floor re-inflates it via the repulsion).

    The median is a SORT — sorting the full (B, B) matrix dominates the
    whole step at large B, while the actual Stein matmuls are cheap.
    Above _MEDIAN_CAP elements the median runs on a fixed-stride
    subsample (deterministic, static shapes — resume identity holds);
    the bandwidth is a heuristic, the subsampled estimate is within the
    heuristic's own noise."""
    flat = d2.reshape(-1)
    m = flat.shape[0]
    if m > _MEDIAN_CAP:  # static at trace time
        stride = m // _MEDIAN_CAP
        flat = flat[:: stride][:_MEDIAN_CAP]
    med = jnp.median(flat)
    h = med / jnp.log(jnp.asarray(B + 1.0, dtype))
    return jnp.maximum(h, jnp.asarray(1e-10, dtype))


def _svgd_scan(vag_fleet, X0, acc0, k0, n_steps, step_size, alpha, fudge):
    B = X0.shape[0]
    dtype = X0.dtype

    def body(carry, _):
        X, acc, k = carry
        f, G = vag_fleet(X)
        # failed particles (NaN objective/gradient) freeze in place and
        # stop influencing the fleet: their kernel row still exists but
        # their gradient contribution is zeroed — in-band, no conds
        bad = ~(jnp.isfinite(f) & jnp.all(jnp.isfinite(G), axis=-1))
        G = jnp.where(bad[:, None], 0.0, G)
        d2 = _pairwise_sq(X)
        h = _median_bandwidth(d2, B, dtype)
        phi = _phi(X, G, d2, h)
        # AdaGrad (Liu & Wang 2016, alg. 1): per-coordinate step with a
        # momentum-smoothed accumulator
        acc_new = jnp.where(
            k == 0, phi * phi, alpha * acc + (1.0 - alpha) * phi * phi
        )
        step = step_size * phi / (fudge + jnp.sqrt(acc_new))
        step = jnp.where(bad[:, None], 0.0, step)
        return (X + step, acc_new, k + 1), None

    (X, acc, k), _ = lax.scan(body, (X0, acc0, k0), None, length=n_steps)
    return X, acc, k


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "value_and_grad_fn", "n_steps", "step_size", "alpha", "fudge",
    ),
)
def _svgd_impl(obj, X0, acc0, k0, value_and_grad_fn, n_steps, step_size,
               alpha, fudge):
    vag_fleet = jax.vmap(as_value_and_grad(obj, value_and_grad_fn))
    X, acc, k = _svgd_scan(
        vag_fleet, X0, acc0, k0, n_steps, step_size, alpha, fudge
    )
    f, G = vag_fleet(X)
    h = _median_bandwidth(_pairwise_sq(X), X.shape[0], X.dtype)
    return SVGDResult(
        particles=X,
        logp=f,
        grad=G,
        bandwidth=h,
        n_steps=k,
        state=SVGDState(x=X, acc=acc, k=k),
    )


def svgd_sample(
    obj,
    x0s: jax.Array,
    *,
    n_steps: int = SVGD_STEPS_DEFAULT,
    step_size: float = 0.1,
    alpha: float = 0.9,
    fudge: float = 1e-6,
    value_and_grad_fn: Optional[Callable] = None,
) -> SVGDResult:
    """Transport a particle fleet toward the posterior of ``obj`` by SVGD.

    ``x0s``: (B, n) initial particles (spread them — e.g. MAP-jittered or
    prior draws; SVGD is DETERMINISTIC, all the randomness you will ever
    get is in the starts). Runs exactly ``n_steps`` kernel-Stein steps
    (fixed-length `lax.scan`; there is no convergence test because there
    is no accept/reject — monitor moments across a resume if needed).

    Bandwidth: the median heuristic med‖xi−xj‖²/log(B+1), recomputed on
    device every step. Steps: the SVGD paper's AdaGrad rule
    (per-coordinate; ``step_size``/``alpha``/``fudge`` are its knobs).

    Particles whose objective evaluates non-finite freeze in place and
    stop contributing gradient drive (in-band — inspect ``result.logp``
    for NaN lanes). Composes with `transforms.transform_objective` for
    constrained posteriors the same way every sampler here does.

    Honest accuracy guidance (measured, n=60 correlated Gaussian):
    SVGD nails locations (max|mean error| ~0.1 at 300 steps) but
    UNDERESTIMATES covariance in higher dimensions (~0.6-0.7 relative
    at n=60 — the known variance-collapse behavior; it shrinks slowly
    with more particles). Use it for representative points, chain
    initialization, and visualisation; for calibrated posterior
    moments use the HMC family, which is asymptotically exact.
    """
    X0 = jnp.asarray(x0s)
    if X0.ndim != 2:
        raise ValueError(f"x0s must be (particles, n), got {X0.shape}")
    if X0.shape[0] < 2:
        raise ValueError(
            "SVGD needs >= 2 particles (the repulsion term is pairwise)"
        )
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not float(step_size) > 0.0:
        raise ValueError(f"step_size must be > 0, got {step_size}")
    acc0 = jnp.zeros_like(X0)
    k0 = jnp.zeros((), jnp.int32)
    return _svgd_impl(
        obj, X0, acc0, k0,
        value_and_grad_fn=value_and_grad_fn,
        n_steps=int(n_steps),
        step_size=float(step_size),
        alpha=float(alpha),
        fudge=float(fudge),
    )


def svgd_sample_from_state(
    obj,
    state: SVGDState,
    *,
    n_steps: int = SVGD_STEPS_DEFAULT,
    step_size: float = 0.1,
    alpha: float = 0.9,
    fudge: float = 1e-6,
    value_and_grad_fn: Optional[Callable] = None,
) -> SVGDResult:
    """Continue an SVGD run for ``n_steps`` MORE steps.

    Chunked == long-run EXACTLY: the carry (particles, AdaGrad
    accumulator, step count) is the whole algorithm memory and every
    step is deterministic. step knobs must match the original run (the
    accumulator is a quantity of that schedule)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    return _svgd_impl(
        obj, state.x, state.acc, state.k,
        value_and_grad_fn=value_and_grad_fn,
        n_steps=int(n_steps),
        step_size=float(step_size),
        alpha=float(alpha),
        fudge=float(fudge),
    )
