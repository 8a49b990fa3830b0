"""Edge-case and fuzz coverage: tiny dimensions, random spectra, dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity


def test_n_equals_1():
    f = lambda x: -((x[0] - 2.0) ** 2)
    res = qnm.optimize(f, jnp.zeros(1))
    assert bool(res.converged)
    np.testing.assert_allclose(float(res.x[0]), 2.0, atol=1e-8)

    res_l = qnm.optimize_lbfgs(f, jnp.zeros(1))
    assert bool(res_l.converged)

    res_b = qnm.optimize_batched(f, jnp.zeros((4, 1)), backend="fused")
    assert np.all(np.asarray(res_b.status) == qnm.Status.CONVERGED)


def test_rosenbrock_n1_odd_tail_only():
    # n=1: the objective is just the odd tail -(1 - x)^2
    res = qnm.optimize(rosenbrock_logdensity, jnp.asarray([-3.0]))
    assert bool(res.converged)
    np.testing.assert_allclose(float(res.x[0]), 1.0, atol=1e-8)


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_random_concave_quadratics(seed):
    """Random SPD quadratics across dims/conditioning: every engine must
    converge to the known optimum."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    Araw = rng.standard_normal((n, n))
    cond_boost = 10.0 ** rng.uniform(0, 3)
    Q = Araw @ Araw.T + np.eye(n) / cond_boost
    x_star = rng.standard_normal(n)
    Qj = jnp.asarray(Q)
    xs = jnp.asarray(x_star)

    def f(x):
        r = x - xs
        return -0.5 * r @ Qj @ r

    x0 = jnp.asarray(rng.standard_normal(n) * 3)
    res = qnm.optimize(f, x0, max_iterations=5000)
    assert bool(res.converged), f"seed={seed} n={n}"
    lam_min = np.linalg.eigvalsh(Q).min()
    np.testing.assert_allclose(
        np.asarray(res.x), x_star, atol=max(1e-6, 1e-8 * np.sqrt(n) / lam_min)
    )

    res_l = qnm.optimize_lbfgs(f, x0, max_iterations=5000)
    assert bool(res_l.converged), f"lbfgs seed={seed} n={n}"


def test_fuzz_batched_fused_random_dims(rng):
    for n in (3, 9, 17, 33):
        X0 = jnp.asarray(rng.standard_normal((16, n)))
        res = qnm.optimize_batched(
            rosenbrock_logdensity, X0, backend="fused"
        )
        assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED), n


def test_float32_default_dtype_flow(rng):
    """f32 in -> f32 out on every result leaf that is float."""
    x0 = jnp.asarray(rng.standard_normal(6), jnp.float32)
    res = qnm.optimize(rosenbrock_logdensity, x0, tol=1e-3)
    assert res.x.dtype == jnp.float32
    assert res.fun.dtype == jnp.float32
    assert res.state.B.dtype == jnp.float32


def test_huge_start_triggers_finite_phase(rng):
    """Start far enough out that f overflows to -inf at alpha=1 trials:
    the finite-halving phase must recover (reference :176-184)."""
    x0 = jnp.full(4, 1e80)
    res = qnm.optimize(lambda x: -jnp.sum(x**4), x0, tol=1e-3,
                       max_iterations=2000)
    # |x|^4 at 1e80 overflows; solver must survive and make progress
    assert int(res.status) in (qnm.Status.CONVERGED, qnm.Status.MAX_ITERATIONS,
                               qnm.Status.NONFINITE_VALUE)
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_funnel_map_extreme_curvature():
    """Neal's funnel has an exact MAP at (v* = -4.5(n-1), x = 0) where the
    Hessian spans ~6 orders of magnitude (x-curvature e^{-v*} vs
    v-curvature 1/9). Both drivers must hit it at the reference-grade
    gradient bar."""
    from quasinewtonmethods_jl_tpu.models import funnel_logdensity

    x0 = jnp.asarray([0.5, 0.1, 0.1, 0.1])
    v_star = -4.5 * 3
    for res in (
        qnm.optimize(funnel_logdensity, x0),
        qnm.optimize_lbfgs(funnel_logdensity, x0),
    ):
        assert int(res.status) == int(qnm.Status.CONVERGED)
        np.testing.assert_allclose(float(res.x[0]), v_star, atol=1e-6)
        np.testing.assert_allclose(np.asarray(res.x[1:]), 0.0, atol=1e-8)
        assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
