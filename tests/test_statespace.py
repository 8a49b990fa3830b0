"""AR(1)-with-drift state-space MAP fixture: the named representative of
the scan-shaped log-density class (round 5). Closed-form optimum via the
normal equations; solved by the scalar driver and the fleet engines."""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import AR1DriftMAP


def test_ar1_closed_form_is_stationary():
    m = AR1DriftMAP(dimension=6, n_steps=24)
    w_map = m.map_solution()
    g = jax.grad(m.logdensity)(w_map)
    assert float(jnp.max(jnp.abs(g))) < 1e-8


def test_ar1_solved_by_scalar_and_fleet_engines(rng):
    m = AR1DriftMAP(dimension=6, n_steps=24)
    w_map = np.asarray(m.map_solution())
    # approximate Wolfe: |f*| is a large sum of log-lik terms, the
    # documented Armijo value-test fp-floor class at tight tol
    r = qnm.optimize(m, jnp.zeros(6), ls=qnm.Wolfe(approx=True))
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), w_map, atol=1e-7)
    X0 = jnp.asarray(rng.standard_normal((8, 6)))
    # tol 1e-7 (the engine-fuzz convention) and approximate Wolfe for
    # the BFGS fleet: |f*| is large here (a sum of T log-lik terms), so
    # the Armijo VALUE test can hit the fp floor one step short of the
    # gradient certificate — the documented stall class the HZ slope
    # acceptance exists for
    for solve in (
        lambda: qnm.optimize_batched(m, X0, tol=1e-7,
                                     ls=qnm.Wolfe(approx=True)),
        lambda: qnm.optimize_cg(m, X0, tol=1e-7),
        lambda: qnm.optimize_tr(m, X0, tol=1e-7),
    ):
        rb = solve()
        assert bool((np.asarray(rb.status) == 1).all())
        np.testing.assert_allclose(
            np.asarray(rb.x), np.broadcast_to(w_map, (8, 6)), atol=1e-5
        )
