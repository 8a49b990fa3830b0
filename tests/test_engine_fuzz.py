"""Cross-engine agreement fuzz: every execution engine, same problem.

Random SPD quadratics with analytically known optima (x* = A^-1 b), swept
over seeds/dimensions/parities: the scalar JAX driver, the vmap engine,
the fused batch-minor engine (plain and fold_eval), the compacted driver,
and the native C++ runtime must all converge to the same optimum — and on
quadratics the drivers take the same iteration counts (same algorithm,
same line search, trajectories too short for fp drift to change counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
)
# deferred: the native host runtime needs a C++ toolchain; the Windows CI
# leg runs the pure-JAX suite with test_host.py deselected, and this module
# must stay importable there (the host comparison skips itself below)
try:
    from quasinewtonmethods_jl_tpu.host import optimize_host

    _HOST_ERR = None
except Exception as _e:  # pragma: no cover - toolchain-less platforms
    optimize_host = None
    _HOST_ERR = _e


def _make_quadratic(rng, n, cond):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.geomspace(1.0, cond, n)
    A = (Q * eigs) @ Q.T
    b = rng.standard_normal(n)
    x_star = np.linalg.solve(A, b)
    A_j, b_j = jnp.asarray(A), jnp.asarray(b)

    def logdensity(x):
        return -0.5 * x @ (A_j @ x) + b_j @ x

    return logdensity, x_star, A, b


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_all_engines_agree_on_random_quadratics(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(3, 25))  # both parities over the sweep
    cond = float(rng.choice([10.0, 1e2, 1e3]))
    logdensity, x_star, A, b = _make_quadratic(rng, n, cond)
    x0 = jnp.asarray(rng.standard_normal(n))

    # tol 1e-7: at cond ~1e3 / f64, tol=1e-8 can stall in-band at the
    # floating-point noise floor one step short (a documented legit exit);
    # the fuzz pins ENGINE AGREEMENT, not tolerance frontiers.
    tol = 1e-7
    scalar = qnm.optimize(logdensity, x0, tol=tol)
    assert int(scalar.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(scalar.x), x_star, atol=1e-6)

    X0 = jnp.broadcast_to(x0, (4, n))
    engines = {
        "vmap": qnm.optimize_batched(logdensity, X0, backend="vmap", tol=tol),
        "fused": optimize_batched_fused(logdensity, X0, tol=tol),
        "fused+fold": optimize_batched_fused(
            logdensity, X0, fold_eval=True, tol=tol
        ),
        "compacted": optimize_batched_compacted(
            logdensity, X0, chunk=7, min_width=4, tol=tol
        ),
    }
    for name, res in engines.items():
        assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED), name
        np.testing.assert_allclose(
            np.asarray(res.x), np.broadcast_to(x_star, (4, n)), atol=1e-6,
            err_msg=name,
        )
        # engines order their arithmetic differently; on a quadratic the
        # trajectories agree to an iteration or so (the reference-parity
        # exactness tests live in test_batched/test_host)
        assert np.all(
            np.abs(np.asarray(res.iterations) - int(scalar.iterations)) <= 1
        ), f"{name}: iterations {res.iterations} vs scalar {scalar.iterations}"

    # the round-4 engine families land on the same optimum: trust-region
    # Newton-Krylov on the logdensity, LM on the Cholesky residual form
    # r = Lᵀ(x − x*) of the SAME quadratic (½‖r‖² = ½(x−x*)ᵀA(x−x*), so
    # the gradient certificate max|A(x−x*)| < tol is shared)
    tr = qnm.optimize_tr(logdensity, x0, tol=tol)
    assert int(tr.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(tr.x), x_star, atol=1e-6)
    LT = jnp.asarray(np.linalg.cholesky(A).T)
    xs_j = jnp.asarray(x_star)
    lm = qnm.least_squares(lambda x: LT @ (x - xs_j), x0, tol=tol)
    assert int(lm.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(lm.x), x_star, atol=1e-6)
    cg = qnm.optimize_cg(logdensity, x0, tol=tol, max_iterations=20_000)
    assert int(cg.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(cg.x), x_star, atol=1e-6)

    # native C++ via numpy callbacks (f64 end to end)
    if optimize_host is None:
        pytest.skip(f"native host runtime unavailable: {_HOST_ERR}")

    def value_and_grad(x):
        return float(-0.5 * x @ (A @ x) + b @ x), -(A @ x) + b

    host = optimize_host(value_and_grad, np.asarray(x0), tol=tol)
    assert host.status == qnm.Status.CONVERGED
    np.testing.assert_allclose(host.x, x_star, atol=1e-6)
    assert abs(host.iterations - int(scalar.iterations)) <= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constrained_engines_agree_on_random_equality_quadratics(seed):
    """Constrained fuzz (round 5): random SPD quadratics with random
    linear equality constraints have an exact KKT solution
    [[Q, A'], [A, 0]][x; lam] = [b; d] — every auglag inner engine, at
    scalar AND fleet rank, must recover the same (x*, lam*)."""
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(4, 12))
    m = int(rng.integers(1, min(4, n)))
    logdensity, _x_un, A, b = _make_quadratic(rng, n, 10.0)
    C = rng.standard_normal((m, n))
    d = rng.standard_normal(m)
    kkt = np.block([[A, C.T], [C, np.zeros((m, m))]])
    sol = np.linalg.solve(kkt, np.concatenate([b, d]))
    x_true, lam_true = sol[:n], sol[n:]
    Cj, dj = jnp.asarray(C), jnp.asarray(d)

    def eq(x):
        return Cj @ x - dj

    x0 = jnp.asarray(rng.standard_normal(n) * 0.5)
    X0 = jnp.stack([x0, x0 + 0.3])
    for engine in ("bfgs", "lbfgs", "cg", "tr"):
        r = qnm.optimize_auglag(logdensity, x0, eq=eq, engine=engine)
        assert bool(r.converged), (engine, seed)
        np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-6,
                                   err_msg=f"{engine} seed={seed}")
        np.testing.assert_allclose(np.asarray(r.lam), lam_true, atol=1e-4,
                                   err_msg=f"{engine} seed={seed}")
        rf = qnm.optimize_auglag(logdensity, X0, eq=eq, engine=engine)
        assert bool(rf.converged.all()), (engine, seed)
        for i in (0, 1):
            np.testing.assert_allclose(np.asarray(rf.x[i]), x_true,
                                       atol=1e-6)
