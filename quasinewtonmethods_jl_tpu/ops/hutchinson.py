"""Shared Hutchinson |diag(H)| estimator for the Jacobi preconditioners.

One implementation serves both consumers (review finding, round 5 —
two hand-mirrored copies had already diverged on layout):

* the TR engine (`trust_region._jacobi_diag`): batch-major (B, n),
  returns the positive diagonal itself (the M-norm scaling);
* the CG engine (`cg_solve._jacobi_precond_cg`): lane-minor (n, batch),
  returns the INVERSE (P = 1/|diag H|) applied to gradients.

diag(H) ≈ mean_j v_j ⊙ (H v_j) over Rademacher probes — EXACT (any
single probe) when H is diagonal, variance ∝ off-diagonal row mass
otherwise (Bekas–Kokiopoulou–Saad 2007). Probes are drawn (n,) along
the parameter axis and broadcast across lanes, so a fleet lane sees the
same probe sequence as a solo solve, and the key folds the caller's
lifetime iteration count so chunked resume replays the exact stream.

Positivity guard — the flush-safe form (`jnp.maximum(x, finfo.tiny)`
is wrong on any backend that flushes denormal-range constants to 0, where
a tiny-floored denominator becomes 1/0): coordinates below the per-lane
relative floor take the floor; a fully-degenerate lane (every estimate
exactly zero — a locally affine region) takes 1.0, i.e. the identity
scaling, which is the benign no-op rescale rather than an inf/NaN.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["hutchinson_abs_diag"]


def hutchinson_abs_diag(hvp_fleet, x, k, probes: int, seed: int,
                        param_axis: int):
    """Positive |diag(H)| estimate at ``x`` (guarded; see module doc).

    ``hvp_fleet(x, v) -> Hv`` with ``v`` shaped like ``x``; ``k`` a
    traced scalar (the lifetime iteration count) keying the probe
    stream; ``param_axis`` the axis of ``x`` holding the parameter
    dimension (-1 for batch-major fleets, 0 for lane-minor)."""
    dtype = x.dtype
    ax = param_axis % x.ndim
    key = jax.random.fold_in(jax.random.PRNGKey(seed), k)
    est = jnp.zeros_like(x)
    for jp in range(probes):
        v1 = jax.random.rademacher(
            jax.random.fold_in(key, jp), (x.shape[ax],), dtype
        )
        shape = [1] * x.ndim
        shape[ax] = x.shape[ax]
        v = jnp.broadcast_to(v1.reshape(shape), x.shape)
        est = est + v * hvp_fleet(x, v)
    d_abs = jnp.abs(est) / probes
    rel = 1e-6 * jnp.max(d_abs, axis=ax, keepdims=True)
    return jnp.where(
        d_abs > rel,
        d_abs,
        jnp.where(rel > 0, rel, jnp.ones_like(d_abs)),
    )
