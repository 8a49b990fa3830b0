"""Constrained MAP with KKT shadow prices — scalar and fleet.

A small portfolio-style posterior: Gaussian beliefs over d asset
log-returns, maximize the posterior log-density of the weight vector
subject to the budget equality sum(w) = 1 and a long-only floor
w_i >= 0. The augmented-Lagrangian solver returns the KKT multipliers —
`lam` is the budget's shadow price (how much the optimum improves per
unit of budget relaxation) and `mu` the prices of the active floors —
which this example verifies against the analytic KKT system.

The fleet half restarts the same constrained problem from a batch of
random points in ONE compiled program (`optimize_auglag` with a rank-2
x0 — the masked-lockstep constrained fleet, round 5) and checks every
lane lands on the same KKT point.

Run: python examples/constrained_map.py   (CPU or GPU)
"""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator

if not on_accelerator():
    jax.config.update("jax_enable_x64", True)


def main():
    rng = np.random.default_rng(11)
    d = 8
    dtype = default_dtype()
    tol = 1e-3 if dtype == jnp.float32 else 1e-8

    mu_r = jnp.asarray(rng.normal(0.05, 0.04, d), dtype)  # expected returns
    A = rng.standard_normal((d, d))
    Sigma = jnp.asarray(A @ A.T / d + 0.5 * np.eye(d), dtype)  # risk

    def logdensity(w):
        # Gaussian posterior over weights: mean-variance form
        return mu_r @ w - 0.5 * w @ Sigma @ w

    def budget(w):
        return jnp.sum(w) - 1.0

    def long_only(w):
        return w  # w_i >= 0 elementwise

    w0 = jnp.full((d,), 1.0 / d, dtype)
    res = qnm.optimize_auglag(
        logdensity, w0, eq=budget, ineq=long_only, tol=tol, ctol=tol
    )
    assert bool(res.converged), res.status
    w = res.x
    print("weights:", np.asarray(w).round(4))
    print("budget residual:", float(jnp.sum(w) - 1.0))
    print("budget shadow price lam:", float(res.lam[0]))
    print("active floors (mu > 0):", np.nonzero(np.asarray(res.mu) > tol)[0])

    # KKT verification (maximization convention, see constrained.py:
    # grad F = grad f − λ∇h + μ∇c = 0 at the solution): with ∇h = 1 and
    # ∇c = I here, stationarity is grad f − λ + μ = 0 per coordinate
    g = np.asarray(res.grad)
    lam = float(res.lam[0])
    mu = np.asarray(res.mu)
    stationarity = g - lam + mu
    print("max |KKT stationarity residual|:",
          float(np.abs(stationarity).max()))
    assert np.abs(stationarity).max() < 50 * tol

    # ---- fleet: the same constrained problem from 16 random restarts,
    # one compiled program, every lane must agree on the KKT point ----
    W0 = jnp.asarray(rng.dirichlet(np.ones(d), size=16), dtype)
    fleet = qnm.optimize_auglag(
        logdensity, W0, eq=budget, ineq=long_only, tol=tol, ctol=tol
    )
    conv = np.asarray(fleet.converged)
    print(f"fleet: {conv.sum()}/16 converged; "
          f"outer rounds {np.asarray(fleet.n_outer).tolist()}")
    assert conv.all()
    spread = np.abs(np.asarray(fleet.x) - np.asarray(w)[None, :]).max()
    print("max |fleet lane - scalar solution|:", float(spread))
    assert spread < 100 * tol


if __name__ == "__main__":
    main()
