"""Every fleet engine against a plain float64 reference solution.

Three problems, each with an optimum computed independently of the
library: the extended Rosenbrock n=60 (optimum 1⃗), a rotated quadratic
n=128 (optimum x* by construction) and the logistic-regression MAP n=100
(optimum from scipy's BFGS on a numpy transcription of the posterior).
Each engine — fused BFGS, vmap BFGS, CG, L-BFGS, trust region and
Levenberg–Marquardt on the residual form of the same objective — solves a
three-lane fleet in float64 and must certify every lane at the optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import (
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)

TOL = 1e-7
LANES = 3


def _rosenbrock():
    n = 60

    def residual(x):
        half = n // 2
        a, b = x[:half], x[half:]
        return jnp.sqrt(2.0) * jnp.concatenate([10.0 * (b - a * a), 1.0 - a])

    rng = np.random.default_rng(60)
    return dict(obj=rosenbrock_logdensity, residual=residual,
                x0=rng.standard_normal((LANES, n)), x_star=np.ones(n),
                atol=1e-5)


def _quadratic():
    n = 128
    rng = np.random.default_rng(128)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 100.0, n)) @ Q.T
    x_star = rng.standard_normal(n)
    L = np.linalg.cholesky(A)
    A_j, Lt_j, xs_j = jnp.asarray(A), jnp.asarray(L.T), jnp.asarray(x_star)

    def obj(x):
        d = x - xs_j
        return -0.5 * d @ (A_j @ d)

    def residual(x):
        return Lt_j @ (x - xs_j)

    return dict(obj=obj, residual=residual,
                x0=rng.standard_normal((LANES, n)), x_star=x_star, atol=1e-6)


def _logistic():
    model = LogisticRegressionMAP(dimension=100, n_obs=500, seed=0)
    X, y = np.asarray(model.X), np.asarray(model.y)
    s2 = model.prior_scale**2

    def neg_logpost(w):  # numpy float64, independent of the package
        z = X @ w
        f = np.sum(y * np.logaddexp(0.0, -z) + (1 - y) * np.logaddexp(0.0, z))
        p = 0.5 * (1.0 + np.tanh(0.5 * z))
        return f + 0.5 * w @ w / s2, X.T @ (p - y) + w / s2

    ref = scipy.optimize.minimize(neg_logpost, np.zeros(100), jac=True,
                                  method="BFGS", options={"gtol": 1e-12})
    X_j, sgn = jnp.asarray(X), jnp.asarray(2.0 * y - 1.0)

    def residual(w):
        # ½‖r‖² = Σ softplus(−(2y−1)z) + ½‖w‖²/s² = −logdensity
        nll = jax.nn.softplus(-sgn * (X_j @ w))
        return jnp.concatenate([jnp.sqrt(2.0 * nll), w / model.prior_scale])

    rng = np.random.default_rng(100)
    return dict(obj=model, residual=residual,
                x0=rng.standard_normal((LANES, 100)), x_star=ref.x, atol=1e-4)


PROBLEMS = {"rosenbrock60": _rosenbrock, "quadratic128": _quadratic,
            "logistic100": _logistic}

ENGINES = {
    "fused_bfgs": lambda p, X: qnm.optimize_batched_fused(p["obj"], X, tol=TOL),
    "vmap_bfgs": lambda p, X: qnm.optimize_batched(
        p["obj"], X, backend="vmap", tol=TOL),
    "cg": lambda p, X: qnm.optimize_cg(p["obj"], X, tol=TOL),
    "lbfgs": lambda p, X: qnm.optimize_lbfgs_batched(p["obj"], X, tol=TOL),
    "tr": lambda p, X: qnm.optimize_tr(p["obj"], X, tol=TOL),
    "lm": lambda p, X: qnm.least_squares(p["residual"], X, tol=TOL),
}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_matches_f64_reference(engine, problem):
    p = PROBLEMS[problem]()
    X0 = jnp.asarray(p["x0"], jnp.float64)
    res = ENGINES[engine](p, X0)
    status = np.asarray(res.status)
    assert np.all(status == qnm.Status.CONVERGED), (engine, problem, status)
    x = np.asarray(res.x)
    assert x.dtype == np.float64 and x.shape == X0.shape
    np.testing.assert_allclose(
        x, np.broadcast_to(p["x_star"], x.shape), rtol=0, atol=p["atol"],
        err_msg=f"{engine} on {problem}",
    )
