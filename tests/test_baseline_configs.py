"""End-to-end coverage of every BASELINE.md config on the CPU backend.

Config 1 (Rosenbrock n=60) is covered exhaustively in test_solve_rosenbrock;
this file pins the remaining four so the benchmark workloads always have a
correctness test behind them.
"""

import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import (
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)


def test_config2_ill_conditioned_quadratic_bfgs(rng):
    """n=256, condition 1e4, dense BFGS (stresses line search + update)."""
    model = IllConditionedQuadratic(256, condition=1e4)
    x0 = jnp.asarray(rng.standard_normal(256))
    res = qnm.optimize(model, x0, max_iterations=5000)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(model.x_star), atol=2e-4
    )


def test_config3_logistic_map_bfgs(rng):
    """n=100 logistic-regression MAP through the autodiff callback path."""
    model = LogisticRegressionMAP(dimension=100, n_obs=400)
    res = qnm.optimize(model, jnp.zeros(100))
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    # MAP of a strictly concave posterior: rerunning from elsewhere lands on
    # the same mode.
    res2 = qnm.optimize(model, jnp.asarray(rng.standard_normal(100)) * 0.1)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res2.x), atol=1e-6)


def test_config4_batched_rosenbrock_fleet(rng):
    """Batched fleet (scaled down for CPU CI: 128 lanes instead of 4096)."""
    X0 = jnp.asarray(rng.standard_normal((128, 16)))
    res = qnm.optimize_batched(rosenbrock_logdensity, X0, backend="fused")
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)


def test_config5_lbfgs_high_dim(rng):
    """L-BFGS(10) in the high-dimensional regime (scaled: n=1024 for CI)."""
    n = 1024
    diag = jnp.asarray(np.linspace(0.1, 4.0, n))
    x_star = jnp.asarray(rng.standard_normal(n))

    def f(x):
        r = x - x_star
        return -0.5 * jnp.sum(diag * r * r)

    res = qnm.optimize_lbfgs(f, jnp.zeros(n), history=10, max_iterations=1000)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_star), atol=1e-6)


def test_poisson_glm_map(rng):
    """Count-data GLM: exp() overflow on wild iterates exercises the
    finite-halving line-search robustness on a realistic model."""
    from quasinewtonmethods_jl_tpu.models import PoissonRegressionMAP

    from quasinewtonmethods_jl_tpu.utils import practically_converged

    model = PoissonRegressionMAP(dimension=50, n_obs=400)
    # Scale-aware tolerance: with |f*| ~ 342 in f64 the line search can only
    # certify objective increases above ~eps*|f| ~ 8e-14, which bounds the
    # reachable gradient norm at ~sqrt(eps*|f|) ~ 3e-7 — tolerances below
    # that stall in-band (BFGS exits LINESEARCH_FAILURE; L-BFGS crawls).
    # Solve to a reachable tol; start far out so early trial points overflow
    # exp() and exercise the finite-halving recovery.
    tol = 1e-6
    res = qnm.optimize(model, jnp.asarray(rng.standard_normal(50)) * 5.0, tol=tol)
    assert practically_converged(res, tol=tol)
    assert float(jnp.max(jnp.abs(res.grad))) < 10 * tol
    res_l = qnm.optimize_lbfgs(model, jnp.zeros(50), tol=tol)
    assert bool(res_l.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_l.x), atol=1e-4)
