"""Weak-Wolfe line search: conditions, failure handling, driver integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu.ops.wolfe import Wolfe, wolfe_linesearch


def make_phi_vag(f, x, d):
    vag = jax.value_and_grad(f)

    def phi_vag(a):
        fv, gv = vag(x + a * d)
        return fv, jnp.dot(gv, d)

    return phi_vag


def test_accepts_step_satisfying_both_conditions(rng):
    # concave quadratic along the ray: phi(a) = a - 0.5 a^2, m = 1
    f = lambda x: x[0] - 0.5 * x[0] ** 2
    x = jnp.zeros(1)
    d = jnp.ones(1)
    res = wolfe_linesearch(make_phi_vag(f, x, d), jnp.float64(0.0), jnp.float64(1.0))
    a = float(res.alpha)
    assert not bool(res.failed)
    # conditions hold at the accepted point
    assert float(res.f_final) >= 0.0 + 1e-4 * a * 1.0
    assert float(res.slope_final) <= 0.9 * 1.0


def test_expands_bracket_for_long_steps():
    # maximum far out at a = 100: phi(a) = a - a^2/200, slope at 1 ~ 0.99 > c2*m
    f = lambda x: x[0] - x[0] ** 2 / 200.0
    res = wolfe_linesearch(
        make_phi_vag(f, jnp.zeros(1), jnp.ones(1)), jnp.float64(0.0), jnp.float64(1.0)
    )
    assert not bool(res.failed)
    assert float(res.alpha) > 1.0  # grew past the unit step


def test_shrinks_on_overshoot():
    f = lambda x: x[0] - 50.0 * x[0] ** 2
    res = wolfe_linesearch(
        make_phi_vag(f, jnp.zeros(1), jnp.ones(1)), jnp.float64(0.0), jnp.float64(1.0)
    )
    assert not bool(res.failed)
    assert 0.0 < float(res.alpha) < 1.0


def test_failure_on_nan_objective():
    def f(x):
        return jnp.where(jnp.sum(jnp.abs(x)) > 0, jnp.nan, 0.0) + 0.0 * jnp.sum(x)

    res = wolfe_linesearch(
        make_phi_vag(f, jnp.zeros(2), jnp.ones(2)),
        jnp.float64(0.0),
        jnp.float64(1.0),
        Wolfe(iterations=20),
    )
    assert bool(res.failed)
    assert float(res.alpha) == 0.0


def test_invalid_config_rejected():
    with pytest.raises(ValueError):
        Wolfe(c1=0.9, c2=0.1)


@pytest.mark.parametrize("driver", ["bfgs", "lbfgs"])
def test_drivers_with_wolfe(driver, rng):
    x0 = jnp.asarray(rng.standard_normal(12))
    kw = dict(ls=qnm.Wolfe(), tol=1e-8)
    if driver == "bfgs":
        res = qnm.optimize(rosenbrock_logdensity, x0, **kw)
    else:
        res = qnm.optimize_lbfgs(rosenbrock_logdensity, x0, history=10, **kw)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    assert int(res.n_gev) > int(res.iterations)  # wolfe evals count as gev


def test_wolfe_guarantees_positive_curvature_pairs(rng):
    """With Wolfe, every accepted L-BFGS pair has s'y > 0, so the cautious
    rejection never fires: history fills to min(k, m)."""
    x0 = jnp.asarray(rng.standard_normal(16))
    res = qnm.optimize_lbfgs(
        rosenbrock_logdensity, x0, history=8, ls=qnm.Wolfe()
    )
    assert bool(res.converged)
    assert int(res.state.hist) == 8  # ring full


def test_batched_wolfe_fleet(rng):
    X0 = jnp.asarray(rng.standard_normal((24, 10)))
    res = qnm.optimize_batched(
        rosenbrock_logdensity, X0, ls=qnm.Wolfe(), backend="fused"
    )
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)


def test_batched_wolfe_matches_scalar_on_quadratic(rng):
    def quad(x):
        diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
        return -0.5 * jnp.sum(diag * x * x)

    X0 = jnp.asarray(rng.standard_normal((6, 5)))
    res_b = qnm.optimize_batched(quad, X0, ls=qnm.Wolfe(), backend="fused")
    for b in range(6):
        res_s = qnm.optimize(quad, X0[b], ls=qnm.Wolfe())
        assert int(res_b.status[b]) == int(res_s.status) == qnm.Status.CONVERGED
        np.testing.assert_allclose(
            np.asarray(res_b.x[b]), np.asarray(res_s.x), atol=1e-8
        )
        assert int(res_b.iterations[b]) == int(res_s.iterations)


def test_cubic_interp_beats_bisection_on_model_zoo(rng):
    """Round-2 upgrade bar: safeguarded-cubic Wolfe proposals must need
    strictly fewer evaluations than pure bisection across the model zoo at
    the same acceptance conditions (every Wolfe trial pays value+grad, so
    evals are the real currency)."""
    from quasinewtonmethods_jl_tpu.models import (
        IllConditionedQuadratic,
        LogisticRegressionMAP,
    )

    zoo = [
        (rosenbrock_logdensity, jnp.asarray(rng.standard_normal((12, 10)))),
        (
            IllConditionedQuadratic(16, condition=1e4, dtype=jnp.float64),
            jnp.asarray(rng.standard_normal((12, 16))),
        ),
        (
            LogisticRegressionMAP(dimension=12, n_obs=200, dtype=jnp.float64),
            jnp.asarray(rng.standard_normal((12, 12))),
        ),
    ]
    tot = {"cubic": 0, "bisection": 0}
    for obj, X0 in zoo:
        for interp in ("cubic", "bisection"):
            res = qnm.optimize_batched(
                obj, X0, ls=qnm.Wolfe(interp=interp), backend="fused", tol=1e-6,
            )
            st = np.asarray(res.status)
            assert np.all(
                (st == qnm.Status.CONVERGED)
                | (st == qnm.Status.LINESEARCH_FAILURE)
            ), f"{obj} {interp}: {st}"
            # s'y > 0 guarantee intact: no steepest-ascent resets beyond
            # the first-iteration one
            assert np.all(np.asarray(res.n_resets) <= 1)
            tot[interp] += int(np.asarray(res.n_fev).sum())
    assert tot["cubic"] < tot["bisection"], tot
