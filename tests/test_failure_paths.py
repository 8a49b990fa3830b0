"""Failure-path and restart-path tests.

The reference leaves its failure handling untested (SURVEY.md §4): NaN
return, line-search exhaustion, non-finite logdensity, the m<=0 identity
reset. These pin the in-band status contract of the driver.
"""

import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity


def test_nonfinite_at_start_returns_nan():
    f = lambda x: jnp.where(jnp.sum(x) > -jnp.inf, jnp.nan, 0.0) * jnp.sum(x)
    res = qnm.optimize(f, jnp.zeros(3))
    assert int(res.status) == qnm.Status.NONFINITE_VALUE
    assert np.isnan(float(res.fun))


def test_max_iterations_returns_nan():
    res = qnm.optimize(rosenbrock_logdensity, jnp.full(6, -1.5), max_iterations=2)
    assert int(res.status) == qnm.Status.MAX_ITERATIONS
    assert np.isnan(float(res.fun))
    assert int(res.iterations) == 2
    # Diagnostic value is still available in-band.
    assert np.isfinite(float(res.last_value))


def test_linesearch_failure_status():
    # A trap region: f finite only near x0; the solver keeps ascending until
    # it walks off the cliff and must terminate with a well-defined status
    # (never loop forever, never raise).
    def trap(x):
        moved = jnp.sum(jnp.abs(x - 1.0)) < 0.5  # x0=1: finite; steps leave region fast
        val = jnp.sum(x)  # gradient = 1 everywhere
        return jnp.where(moved, val, -jnp.inf)

    res = qnm.optimize(trap, jnp.ones(4), ls=qnm.BackTracking(iterations=30))
    assert int(res.status) in (
        qnm.Status.LINESEARCH_FAILURE,
        qnm.Status.MAX_ITERATIONS,
        qnm.Status.NONFINITE_VALUE,
        qnm.Status.CONVERGED,
    )


def test_linesearch_failure_deterministic():
    # Every trial point away from x0 is NaN, so the Armijo condition can
    # never hold. x0 = 0 matters: no trial step is absorbed bitwise
    # (0 + a*1 != 0 for any a > 0), so the search cannot "succeed" at the
    # unmoved point and failure is deterministic.
    def cliff(x):
        at_start = jnp.all(x == 0.0)
        return jnp.where(at_start, jnp.sum(x) + 1.0, jnp.nan)

    res = qnm.optimize(cliff, jnp.zeros(3), ls=qnm.BackTracking(iterations=20))
    assert int(res.status) == qnm.Status.LINESEARCH_FAILURE
    assert np.isnan(float(res.fun))
    # x must be unchanged (alpha=0 step), like the reference's break-without-
    # update (src/QuasiNewtonMethods.jl:284).
    np.testing.assert_array_equal(np.asarray(res.x), np.zeros(3))


def test_reset_path_on_indefinite_curvature():
    """Feed a concave-then-convex objective whose BFGS pair yields m <= 0 at
    some iteration; the driver must reset to steepest ascent (n_resets >= 2:
    the first iteration always resets via the m=-1 sentinel) and still
    converge."""
    # Non-convex in log space but with a single max at 0: f = -|x|^3 sum.
    f = lambda x: -jnp.sum(jnp.abs(x) ** 3)
    res = qnm.optimize(f, jnp.asarray([2.0, -3.0, 0.5]), tol=1e-6)
    assert bool(res.converged)
    assert int(res.n_resets) >= 1
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-2)


def test_first_iteration_is_steepest_ascent():
    """Iteration 1 must take d = grad (sentinel m=-1 path, reference
    :263-264, :272-280): for a pure quadratic -0.5||x||^2 from x0, the first
    accepted step with alpha=1 lands exactly at 0 (gradient -x0, d=-x0...
    maximization: grad = -x, direction = grad, x1 = x0 + 1*(-x0) = 0)."""
    f = lambda x: -0.5 * jnp.sum(x * x)
    res = qnm.optimize(f, jnp.asarray([3.0, -2.0, 1.0]))
    assert bool(res.converged)
    assert int(res.iterations) <= 2
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-12)


def test_status_codes_stable():
    """Status enum values are part of the serialized-state contract."""
    assert qnm.Status.RUNNING == 0
    assert qnm.Status.CONVERGED == 1
    assert qnm.Status.MAX_ITERATIONS == 2
    assert qnm.Status.LINESEARCH_FAILURE == 3
    assert qnm.Status.NONFINITE_VALUE == 4


def test_nan_direction_preserves_iterate(rng):
    """A degenerate update (sty == 0 -> NaN direction) followed by
    line-search failure must leave x at the last good iterate, never NaN
    (the reference breaks before update_state!, :284-285; 0 * NaN = NaN
    would otherwise poison x through the masked-step arithmetic)."""
    import jax.numpy as jnp

    # Objective engineered so the solver stalls: a plateau reached after one
    # step. At the plateau the gradient is tiny-but-above-tol and y ~ 0, so
    # the update degenerates and the line search eventually fails in-band.
    def plateau(x):
        r = jnp.sum(x * x)
        return -jnp.minimum(r, 1e-3) - 1e-12 * r

    res = qnm.optimize(plateau, jnp.asarray([2.0, -1.0]), tol=1e-9,
                       ls=qnm.BackTracking(iterations=30), max_iterations=50)
    assert np.all(np.isfinite(np.asarray(res.x)))
    # whatever the status, the iterate and diagnostics stay usable
    assert np.isfinite(float(res.last_value))


def test_batched_stall_lane_keeps_finite_iterate(rng):
    """Regression for the HMC-example bug: lanes stalling at the f64 noise
    floor (LINESEARCH_FAILURE one step from convergence) must retain their
    last good iterate, not NaN."""
    import jax
    from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP

    model = LogisticRegressionMAP(dimension=32, n_obs=300)
    starts = jax.random.normal(jax.random.PRNGKey(0), (64, 32), jnp.float64)
    res = qnm.optimize_batched(model, starts, tol=1e-8, backend="vmap")
    st = np.asarray(res.status)
    assert np.all(
        (st == qnm.Status.CONVERGED) | (st == qnm.Status.LINESEARCH_FAILURE)
    )
    assert np.all(np.isfinite(np.asarray(res.x))), "stalled lane lost its iterate"
    # stalled lanes are still at near-tolerance quality
    gradmax = np.abs(np.asarray(res.grad)).max(axis=1)
    assert gradmax[st == qnm.Status.LINESEARCH_FAILURE].max() < 1e-6
