"""Nonlinear-CG engine: convergence bars, contracts, resume, shim.

The CG engine is the O(n)-state member of the optimizer family
(cg_solve.py); these tests pin it to the same library-wide contracts as
the BFGS/L-BFGS/TR/LM engines — reference-parity convergence bars where
the method can certify them, in-band failure semantics
(src/QuasiNewtonMethods.jl:193/:255/:284 analogs), chunked resume == one
long run, and the checkpoint round-trip.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.cg_solve import optimize_cg, optimize_cg_from_state
from quasinewtonmethods_jl_tpu.models.rosenbrock import Rosenbrock
from quasinewtonmethods_jl_tpu.ops.linesearch import BackTracking
from quasinewtonmethods_jl_tpu.ops.wolfe import Wolfe
from quasinewtonmethods_jl_tpu.state import Status


def _quadratic(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
    b = rng.standard_normal(n)
    x_star = np.linalg.solve(A, b)
    A_j, b_j = jnp.asarray(A), jnp.asarray(b)

    def logdensity(x):
        return -0.5 * x @ (A_j @ x) + b_j @ x

    return logdensity, x_star


@pytest.mark.parametrize("method", ["hz", "pr", "fr", "dy"])
def test_cg_certifies_quadratic_all_betas(method):
    logd, x_star = _quadratic(12, 100.0, 0)
    x0 = jnp.asarray(np.random.default_rng(50).standard_normal(12))
    res = optimize_cg(logd, x0, method=method, tol=1e-8)
    assert int(res.status) == Status.CONVERGED
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    assert float(jnp.max(jnp.abs(res.x - x_star))) < 1e-6
    assert bool(res.converged)


def test_cg_certifies_stiff_quadratic():
    # cond 1e3 endgame: the measured regression the approximate-Wolfe +
    # slope-driven bracketing was built for — the ordinary Wolfe search
    # stalls in-band at max|∇| ~ 1e-6 here (the Armijo test becomes
    # unsatisfiable below the fp resolution floor)
    logd, x_star = _quadratic(12, 1e3, 1)
    x0 = jnp.asarray(np.random.default_rng(51).standard_normal(12))
    res = optimize_cg(logd, x0, method="hz", tol=1e-8, max_iterations=5000)
    assert int(res.status) == Status.CONVERGED
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    # and the ordinary-Wolfe variant genuinely cannot (pins the failure
    # mode the approx default exists for — if this starts converging,
    # the approx machinery may be removable)
    res_plain = optimize_cg(
        logd, x0, method="hz", tol=1e-8, max_iterations=5000,
        ls=Wolfe(approx=False),
    )
    assert int(res_plain.status) == Status.LINESEARCH_FAILURE


@pytest.mark.parametrize("n", [2, 8, 24])
def test_cg_rosenbrock_reference_bars(n):
    # the reference's own test function and certificate (max|∇| < 1e-8,
    # runtests.jl sweep); CG takes more iterations than BFGS but reaches
    # the same bar
    model = Rosenbrock(n)
    res = optimize_cg(
        model.logdensity, jnp.full((n,), -1.2), tol=1e-8,
        max_iterations=50_000,
    )
    assert int(res.status) == Status.CONVERGED
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    # |l*| at the optimum: the reference's 2eps bar scaled loosely for a
    # linear-convergence engine arriving along the valley floor
    assert abs(float(res.fun)) < 1e-14


def test_cg_fleet_matches_scalar_lanes():
    logd, _ = _quadratic(10, 50.0, 2)
    X0 = jnp.asarray(np.random.default_rng(52).standard_normal((6, 10)))
    fleet = optimize_cg(logd, X0, tol=1e-8)
    assert int(jnp.sum(fleet.status == Status.CONVERGED)) == 6
    # per-lane agreement with solo runs: statuses identical and the same
    # certified optimum. Iteration counts are NOT pinned — XLA fuses the
    # (n, 1) and (n, 6) reductions differently, and over ~100 linear-rate
    # iterations that fp drift legitimately shifts trip counts by a few.
    for i in range(6):
        solo = optimize_cg(logd, X0[i], tol=1e-8)
        assert int(solo.status) == int(fleet.status[i])
        np.testing.assert_allclose(
            np.asarray(solo.x), np.asarray(fleet.x[i]), rtol=0, atol=1e-6
        )


def test_cg_resume_equals_long_run():
    logd, _ = _quadratic(10, 100.0, 3)
    x0 = jnp.asarray(np.random.default_rng(53).standard_normal(10))
    long = optimize_cg(logd, x0, tol=1e-10, max_iterations=400)
    a = optimize_cg(logd, x0, tol=1e-10, max_iterations=7)
    assert int(a.status) == Status.MAX_ITERATIONS
    b = optimize_cg_from_state(logd, a.state, tol=1e-10, max_iterations=393)
    assert int(b.status) == int(long.status)
    assert int(b.iterations) == int(long.iterations)
    np.testing.assert_array_equal(np.asarray(b.x), np.asarray(long.x))


def test_cg_checkpoint_roundtrip(tmp_path):
    logd, _ = _quadratic(8, 30.0, 4)
    X0 = jnp.asarray(np.random.default_rng(54).standard_normal((4, 8)))
    a = optimize_cg(logd, X0, tol=1e-10, max_iterations=5)
    from quasinewtonmethods_jl_tpu.utils.checkpoint import load_state, save_state

    path = str(tmp_path / "cg_state")
    save_state(path, a.state)
    loaded = load_state(path)
    assert type(loaded).__name__ == "CGState"
    b = optimize_cg_from_state(logd, loaded, tol=1e-10, max_iterations=400)
    long = optimize_cg(logd, X0, tol=1e-10, max_iterations=405)
    np.testing.assert_array_equal(np.asarray(b.x), np.asarray(long.x))


def test_cg_failure_contracts():
    # linear objective: no finite maximizer along any ray — the Wolfe
    # curvature condition is unsatisfiable, budget exhausts, alpha == 0
    # sentinel -> LINESEARCH_FAILURE with the iterate frozen at x0
    lin = lambda x: jnp.sum(x)  # noqa: E731
    res = optimize_cg(lin, jnp.zeros(4))
    assert int(res.status) == Status.LINESEARCH_FAILURE
    assert bool(jnp.isnan(res.fun))
    np.testing.assert_array_equal(np.asarray(res.x), np.zeros(4))

    # non-finite at x0 -> NONFINITE_VALUE, iterate untouched
    nanobj = lambda x: jnp.nan * jnp.sum(x)  # noqa: E731
    res = optimize_cg(nanobj, jnp.ones(4))
    assert int(res.status) == Status.NONFINITE_VALUE
    assert bool(jnp.isnan(res.fun))
    np.testing.assert_array_equal(np.asarray(res.x), np.ones(4))


def test_cg_f32_fleet_stays_f32():
    # the round-2 bug class: an engine silently upcasting an f32 fleet
    # under jax_enable_x64
    rng = np.random.default_rng(5)
    n = 12
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = jnp.asarray((Q * np.geomspace(1.0, 10.0, n)) @ Q.T, jnp.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    def logd(x):
        return -0.5 * x @ (A @ x) + b @ x

    X0 = jnp.asarray(rng.standard_normal((32, n)), jnp.float32)
    res = optimize_cg(logd, X0, tol=1e-3)
    assert res.x.dtype == jnp.float32
    assert res.fun.dtype == jnp.float32
    counts = collections.Counter(np.asarray(res.status).tolist())
    assert counts[int(Status.CONVERGED)] == 32


def test_cg_backtracking_linesearch_supported():
    # value-only trials: documented as the loose-tolerance option (β
    # quality degrades without the curvature condition; the in-band
    # steepest reset keeps it convergent)
    logd, x_star = _quadratic(12, 10.0, 6)
    x0 = jnp.asarray(np.random.default_rng(56).standard_normal(12))
    res = optimize_cg(logd, x0, method="pr", ls=BackTracking(), tol=1e-5)
    assert int(res.status) == Status.CONVERGED
    assert float(jnp.max(jnp.abs(res.x - x_star))) < 1e-3


def test_cg_minimize_shim():
    logd, x_star = _quadratic(8, 20.0, 7)
    fun = lambda x: -logd(x)  # noqa: E731
    x0 = jnp.asarray(np.random.default_rng(57).standard_normal(8))
    res = qnm.minimize(fun, x0, method="cg", tol=1e-8)
    assert int(res.status) == Status.CONVERGED
    # minimization convention on the way out
    assert float(res.fun) == pytest.approx(float(fun(res.x)))
    np.testing.assert_allclose(
        np.asarray(res.grad), np.asarray(jax.grad(fun)(res.x)), atol=1e-12
    )
    # β formula rides cg_method= (method= names the engine in the shim)
    res_pr = qnm.minimize(fun, x0, method="cg", cg_method="pr", tol=1e-6)
    assert int(res_pr.status) == Status.CONVERGED


def test_cg_validation_errors():
    logd, _ = _quadratic(4, 10.0, 8)
    with pytest.raises(ValueError, match="method"):
        optimize_cg(logd, jnp.zeros(4), method="nope")
    with pytest.raises(ValueError, match="rank"):
        optimize_cg(logd, jnp.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="max_iterations"):
        optimize_cg(logd, jnp.zeros(4), max_iterations=0)
    with pytest.raises(ValueError, match="restart_nu"):
        optimize_cg(logd, jnp.zeros(4), restart_nu=-1.0)
    with pytest.raises(ValueError, match="approx_eps"):
        Wolfe(approx_eps=-1.0)


def test_cg_rank1_state_resume():
    # the round-4 TR review regression class: a single-solve result's
    # state is squeezed — resume must re-batch it
    logd, _ = _quadratic(6, 10.0, 9)
    x0 = jnp.asarray(np.random.default_rng(59).standard_normal(6))
    a = optimize_cg(logd, x0, tol=1e-10, max_iterations=3)
    assert a.state.x.ndim == 1
    b = optimize_cg_from_state(logd, a.state, tol=1e-10, max_iterations=400)
    assert b.x.ndim == 1
    assert int(b.status) == Status.CONVERGED


def test_cg_analytic_value_and_grad():
    logd, x_star = _quadratic(10, 50.0, 10)

    def vag(x):
        return logd(x), jax.grad(logd)(x)

    x0 = jnp.asarray(np.random.default_rng(60).standard_normal(10))
    res = optimize_cg(logd, x0, value_and_grad_fn=vag, tol=1e-8)
    ad = optimize_cg(logd, x0, tol=1e-8)
    assert int(res.status) == Status.CONVERGED
    assert int(res.iterations) == int(ad.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ad.x))


def test_cg_fold_eval_off_agrees():
    # fold_eval=True seeds iterations from the accepted trial (default
    # OFF: it can be slower — the (n, batch) gradient
    # carried through the Wolfe loop outweighs the saved eval); both
    # modes must certify and land on the same optimum
    logd, x_star = _quadratic(10, 50.0, 11)
    x0 = jnp.asarray(np.random.default_rng(61).standard_normal(10))
    on = optimize_cg(logd, x0, tol=1e-8, fold_eval=True)
    off = optimize_cg(logd, x0, tol=1e-8)
    assert int(on.status) == int(off.status) == Status.CONVERGED
    # both at the same max|grad| < 1e-8 certificate; the trajectories
    # drift at the ulp level, so the endpoints agree at certificate
    # resolution, not bitwise
    np.testing.assert_allclose(np.asarray(on.x), np.asarray(off.x),
                               rtol=0, atol=1e-6)
    # fold saves the top-of-iteration evaluation: strictly fewer evals
    assert int(on.n_fev) < int(off.n_fev)


# ---------------------------------------------------------------------------
# Preconditioned nonlinear CG (round 5)
# ---------------------------------------------------------------------------


def test_cg_precondition_stiff_quadratic_win():
    """The motivating case: a cond-1e4 diagonal quadratic. Plain CG pays
    O(sqrt(cond)) iterations; Jacobi preconditioning (per-iteration
    Hutchinson 1/|diag H|) and a FIXED exact diagonal both collapse it to
    O(1) — the CG analog of the BFGS engine's H0/BB scaling and the TR
    engine's Jacobi-CG (which measured 25-37x fewer HVPs on the same
    fixture family)."""
    n, B = 64, 16
    d = jnp.logspace(0, 4, n)

    def f(x):
        return -0.5 * jnp.sum(d * x * x)

    rng = np.random.default_rng(1)
    X0 = jnp.asarray(rng.standard_normal((B, n)))
    plain = optimize_cg(f, X0, tol=1e-8, max_iterations=5000)
    jac = optimize_cg(f, X0, tol=1e-8, max_iterations=5000,
                      precondition="jacobi")
    fix = optimize_cg(f, X0, tol=1e-8, max_iterations=5000, precondition=d)
    assert bool(plain.converged.all())
    assert bool(jac.converged.all())
    assert bool(fix.converged.all())
    # the measured gap is ~500x (3157 -> 6 median); pin an order of
    # magnitude with slack
    assert int(np.median(np.asarray(jac.iterations))) * 20 < int(
        np.median(np.asarray(plain.iterations))
    )
    assert int(np.asarray(fix.iterations).max()) <= 15
    np.testing.assert_allclose(np.asarray(jac.x), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(fix.x), 0.0, atol=1e-8)
    # probes are accounted: jacobi pays precond_probes extra gev per iter
    assert int(jac.n_gev.max()) > 2 * int(jac.iterations.max())


def test_cg_precondition_identity_is_noop():
    """precondition=ones must reproduce the plain trajectory bitwise —
    the preconditioned algebra with P = 1 IS the plain algebra."""
    n = 12
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.standard_normal(n) * 0.5)
    obj = Rosenbrock(n)
    plain = optimize_cg(obj, x0, tol=1e-8)
    unit = optimize_cg(obj, x0, tol=1e-8, precondition=jnp.ones(n))
    assert int(plain.iterations) == int(unit.iterations)
    np.testing.assert_array_equal(np.asarray(plain.x), np.asarray(unit.x))


def test_cg_precondition_chunked_resume_parity():
    """Chunked == one long run under precondition='jacobi': the probe
    stream keys off the saved lifetime iteration count."""
    n = 16
    d = jnp.logspace(0, 3, n)

    def f(x):
        return -0.5 * jnp.sum(d * x * x)

    rng = np.random.default_rng(3)
    x0 = jnp.asarray(rng.standard_normal(n))
    full = optimize_cg(f, x0, tol=1e-10, precondition="jacobi")
    leg1 = optimize_cg(f, x0, tol=1e-10, max_iterations=3,
                       precondition="jacobi")
    leg2 = optimize_cg_from_state(f, leg1.state, tol=1e-10,
                                  precondition="jacobi")
    assert int(leg2.iterations) == int(full.iterations)
    np.testing.assert_allclose(np.asarray(leg2.x), np.asarray(full.x),
                               atol=1e-12)


def test_cg_precondition_nonquadratic_safe_and_validated():
    """On coupled-curvature objectives (Rosenbrock) jacobi measured
    SLOWER (580 vs 199 median iterations — the diagonal is a poor model
    and the per-iteration re-estimate churns the metric), which is why
    the knob defaults OFF; it must still CONVERGE. Bad diagonals raise
    eagerly (shared validation with the TR engine)."""
    rng = np.random.default_rng(4)
    X0 = jnp.asarray(rng.standard_normal((4, 8)) * 0.5)
    obj = Rosenbrock(8)
    r = optimize_cg(obj, X0, tol=1e-8, max_iterations=5000,
                    precondition="jacobi")
    assert bool(r.converged.all())
    np.testing.assert_allclose(np.asarray(r.x), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="precondition"):
        optimize_cg(obj, X0, precondition="ssor")
    with pytest.raises(ValueError, match="finite and > 0"):
        optimize_cg(obj, X0, precondition=-jnp.ones(8))
    with pytest.raises(ValueError, match="last axis"):
        optimize_cg(obj, X0, precondition=jnp.ones(5))
    with pytest.raises(ValueError, match="precond_probes"):
        optimize_cg(obj, X0, precondition="jacobi", precond_probes=0)


def test_cg_precondition_per_lane_fixed_diag():
    """A (batch, n) fixed diagonal preconditions each lane with its own
    scaling — lanes with the RIGHT diagonal converge in O(1) iterations,
    the identity-scaled lane pays the full stiff count."""
    n = 48
    d = jnp.logspace(0, 3, n)

    def f(x):
        return -0.5 * jnp.sum(d * x * x)

    rng = np.random.default_rng(5)
    X0 = jnp.asarray(rng.standard_normal((2, n)))
    diags = jnp.stack([d, jnp.ones(n)])  # lane 0 exact, lane 1 unscaled
    r = optimize_cg(f, X0, tol=1e-8, max_iterations=5000,
                    precondition=diags)
    assert bool(r.converged.all())
    assert int(r.iterations[0]) * 10 < int(r.iterations[1])


def test_cg_jacobi_degenerate_diagonal_is_identity_scaling():
    """Review finding (round 5): a locally-affine region estimates an
    all-zero |diag H|; the old tiny-constant floor is a flush-to-zero
    hazard (1/tiny -> inf on a backend that flushes tiny constants). The shared
    estimator's guard must return the IDENTITY scaling there (P = 1) —
    the benign no-op — so the solve proceeds as plain CG."""
    from quasinewtonmethods_jl_tpu.ops.hutchinson import hutchinson_abs_diag

    # hvp of an affine objective is exactly zero
    def hvp_zero(X, V):
        return jnp.zeros_like(V)

    X = jnp.ones((6, 3))
    d = hutchinson_abs_diag(hvp_zero, X, jnp.zeros((), jnp.int32), 2,
                            0x7453, param_axis=0)
    np.testing.assert_array_equal(np.asarray(d), 1.0)

    # end-to-end: piecewise-affine-ish objective with jacobi must not
    # produce inf/NaN directions (linear objective + tiny curvature)
    def f(x):
        return jnp.sum(x) - 1e-30 * jnp.sum(x * x)

    r = optimize_cg(f, jnp.zeros(4), precondition="jacobi",
                    max_iterations=5)
    # unbounded objective: exhausts iterations in-band, but every
    # iterate must stay finite (no inf preconditioner ever applied)
    assert np.isfinite(np.asarray(r.x)).all()
