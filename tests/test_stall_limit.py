"""stall_limit plumbing: every public entry point can disable the stall
detector (stall_limit=0 = exact reference behavior: crawl to the iteration
cap, reference src/QuasiNewtonMethods.jl:250 hardcodes N=10_000 and has no
stall exit).

Fixture: value pinned at the f64 absorption level (every improvement is
rounded away by ``1e20 + tiny``, so the Armijo test accepts steps that the
stall detector sees as non-improving) with a unit-norm rotating "gradient"
field (no fixed point, |grad| = 1 everywhere) and tol = 0.0 (max|grad| < 0
is never true). The solver keeps accepting real steps forever without ever
improving or converging — the exact stall the detector exists for. With the
detector on it exits LINESEARCH_FAILURE after ~stall_limit iterations; with
stall_limit=0 it crawls to max_iterations exactly like the reference would
(which has no stall exit at all).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
    optimize_lbfgs_batched_fused,
)

CAP = 120


_TH = np.deg2rad(150.0)
_ROT = np.asarray([[np.cos(_TH), -np.sin(_TH)], [np.sin(_TH), np.cos(_TH)]])


def absorbed_value(x):
    # 1e20 + (x-dependent term far below eps(1e20) ~ 2e4): the value is
    # bitwise constant, but keep the trace x-dependent.
    return jnp.asarray(1e20, x.dtype) - 1e-30 * jnp.sum(x * x)


def absorbed_vag(x):
    g = jnp.asarray(_ROT, x.dtype) @ x
    g = g / jnp.sqrt(jnp.sum(g * g))  # unit norm: never converges, no NaN
    return absorbed_value(x), g


TOL = 0.0  # max|grad| < 0 is never true -> the convergence exit never fires


def _assert_stalls_then_crawls(run):
    res_stall = run(stall_limit=50)
    assert int(np.max(res_stall.iterations)) < CAP
    assert np.all(
        np.asarray(res_stall.status) == qnm.Status.LINESEARCH_FAILURE
    )
    res_ref = run(stall_limit=0)
    assert np.all(np.asarray(res_ref.status) == qnm.Status.MAX_ITERATIONS)
    assert np.all(np.asarray(res_ref.iterations) == CAP)


def test_optimize_stall_limit():
    x0 = jnp.asarray([3.0, -2.0])
    _assert_stalls_then_crawls(
        lambda stall_limit: qnm.optimize(
            absorbed_value, x0, tol=TOL, max_iterations=CAP,
            value_and_grad_fn=absorbed_vag, h0_scale=False,
            stall_limit=stall_limit,
        )
    )


def test_optimize_lbfgs_stall_limit():
    x0 = jnp.asarray([3.0, -2.0])
    _assert_stalls_then_crawls(
        lambda stall_limit: qnm.optimize_lbfgs(
            absorbed_value, x0, tol=TOL, max_iterations=CAP,
            value_and_grad_fn=absorbed_vag, stall_limit=stall_limit,
        )
    )


@pytest.mark.parametrize("backend", ["vmap", "fused"])
def test_optimize_batched_stall_limit(backend):
    X0 = jnp.asarray([[3.0, -2.0], [1.0, 2.0], [0.5, -0.5]])
    _assert_stalls_then_crawls(
        lambda stall_limit: qnm.optimize_batched(
            absorbed_value, X0, tol=TOL, max_iterations=CAP,
            value_and_grad_fn=absorbed_vag, backend=backend,
            stall_limit=stall_limit,
        )
    )


def test_batched_fused_resume_stall_limit():
    X0 = jnp.asarray([[3.0, -2.0], [1.0, 2.0]])
    first = optimize_batched_fused(
        absorbed_value, X0, tol=TOL, max_iterations=10,
        value_and_grad_fn=absorbed_vag, stall_limit=0,
    )
    resumed = optimize_batched_fused_from_state(
        absorbed_value, first.state, tol=TOL, max_iterations=CAP,
        value_and_grad_fn=absorbed_vag, stall_limit=0,
    )
    assert np.all(np.asarray(resumed.status) == qnm.Status.MAX_ITERATIONS)
    assert np.all(np.asarray(resumed.iterations) == 10 + CAP)


def test_lbfgs_batched_fused_stall_limit():
    X0 = jnp.asarray([[3.0, -2.0], [1.0, 2.0]])
    _assert_stalls_then_crawls(
        lambda stall_limit: optimize_lbfgs_batched_fused(
            absorbed_value, X0, tol=TOL, max_iterations=CAP,
            value_and_grad_fn=absorbed_vag, stall_limit=stall_limit,
        )
    )
