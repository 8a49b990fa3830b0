"""Augmented-Lagrangian constrained solves: KKT parity vs analytic
solutions, multiplier recovery, in-band failure, validation.

The certificate under test: result.converged iff the inner engine
certified max|grad L| < tol AND the violation max(|eq|, |min(ineq,
mu/rho)|) <= ctol; fun is f(x) then and NaN in-band otherwise; lam/mu
converge to the true KKT multipliers (first-order updates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.state import Status


def _quad(z):
    """maximize -(x-2)^2 - (y-1)^2; with x+y=1 the KKT solution is
    x = (1, 0), lam = 2, f* = -2 (stationarity: -2(x-2) = lam = -2(y-1))."""
    return -((z[0] - 2.0) ** 2) - ((z[1] - 1.0) ** 2)


def _h(z):
    return z[0] + z[1] - 1.0


@pytest.mark.parametrize("engine", ["bfgs", "lbfgs", "cg", "tr"])
def test_equality_kkt_all_engines(engine):
    r = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h, engine=engine)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(r.fun), -2.0, atol=1e-6)
    np.testing.assert_allclose(float(r.lam[0]), 2.0, atol=1e-5)
    assert float(r.viol) <= 1e-8
    assert int(r.n_outer) >= 1 and int(r.iterations) > 0


def test_random_equality_quadratic_vs_kkt_solve():
    """maximize -0.5 x'Qx + b'x s.t. Ax = d against the exact KKT linear
    system [[Q, A'], [A, 0]] [x; lam] = [b; d]."""
    rng = np.random.default_rng(3)
    n, m = 8, 3
    M = rng.standard_normal((n, n))
    Q = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    d = rng.standard_normal(m)
    kkt = np.block([[Q, A.T], [A, np.zeros((m, m))]])
    sol = np.linalg.solve(kkt, np.concatenate([b, d]))
    x_true, lam_true = sol[:n], sol[n:]

    Qj, bj, Aj, dj = map(jnp.asarray, (Q, b, A, d))

    def f(x):
        return -0.5 * x @ Qj @ x + bj @ x

    def eq(x):
        return Aj @ x - dj

    r = qnm.optimize_auglag(f, jnp.zeros(n), eq=eq)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-6)
    # the augmented-Lagrangian lam converges to the TRUE multiplier of
    # the maximization KKT system (sign convention: grad f = A' lam)
    np.testing.assert_allclose(np.asarray(r.lam), lam_true, atol=1e-5)


def test_inequality_active_and_inactive():
    def f(z):
        return -jnp.sum(z * z)

    # active: optimum pulled onto the boundary x+y = 1, mu = 1
    r = qnm.optimize_auglag(f, jnp.zeros(2),
                            ineq=lambda z: z[0] + z[1] - 1.0)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(float(r.mu[0]), 1.0, atol=1e-5)
    assert float(r.ineq[0]) >= -1e-8

    # inactive: unconstrained optimum feasible, mu stays exactly 0
    r2 = qnm.optimize_auglag(f, jnp.ones(2),
                             ineq=lambda z: z[0] + z[1] + 5.0)
    assert bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r2.x), [0.0, 0.0], atol=1e-7)
    assert float(r2.mu[0]) == 0.0


def test_mixed_eq_ineq():
    """maximize -(x² + y² + z²) s.t. x + y + z = 3 (eq) and x >= 1.5
    (ineq). Without the ineq: x = y = z = 1; the bound is active, so
    x = 1.5, y = z = 0.75 by symmetry of the remaining problem."""

    def f(v):
        return -jnp.sum(v * v)

    r = qnm.optimize_auglag(
        f, jnp.zeros(3),
        eq=lambda v: jnp.sum(v) - 3.0,
        ineq=lambda v: v[0] - 1.5,
    )
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [1.5, 0.75, 0.75],
                               atol=1e-6)
    assert float(r.mu[0]) > 0.0  # active bound carries a positive price


def test_vector_constraints_and_scalar_promotion():
    # rank-0 constraint returns are promoted to (1,)
    r = qnm.optimize_auglag(lambda z: -jnp.sum(z * z), jnp.ones(2),
                            eq=lambda z: z[0] - 0.3)
    assert r.lam.shape == (1,)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [0.3, 0.0], atol=1e-7)
    # (2,) vector equality pins both coordinates
    r2 = qnm.optimize_auglag(
        lambda z: -jnp.sum((z - 5.0) ** 2), jnp.zeros(2),
        eq=lambda z: jnp.asarray([z[0] - 1.0, z[1] + 2.0]),
    )
    assert bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r2.x), [1.0, -2.0], atol=1e-7)


def test_infeasible_reports_in_band():
    """x = 1 and x = 2 simultaneously: no feasible point exists — the
    outer budget exhausts with fun NaN in-band and a nonzero viol."""
    r = qnm.optimize_auglag(
        lambda z: -jnp.sum(z * z), jnp.zeros(1),
        eq=lambda z: jnp.asarray([z[0] - 1.0, z[0] - 2.0]),
        max_outer=6,
    )
    assert not bool(r.converged)
    assert int(r.status) == int(Status.MAX_ITERATIONS)
    assert np.isnan(float(r.fun))
    assert float(r.viol) > 0.1
    assert int(r.n_outer) == 6


def test_hard_inner_failure_propagates():
    """Objective non-finite at x0: the inner engine reports
    NONFINITE_VALUE; the outer loop must stop immediately (not burn
    max_outer rounds) and surface that status, fun NaN."""

    def bad(z):
        return jnp.where(jnp.any(z > -jnp.inf), jnp.nan, 0.0)

    r = qnm.optimize_auglag(bad, jnp.zeros(2), eq=lambda z: z[0] - 1.0,
                            max_outer=9)
    assert not bool(r.converged)
    assert int(r.status) == int(Status.NONFINITE_VALUE)
    assert int(r.inner_status) == int(Status.NONFINITE_VALUE)
    assert np.isnan(float(r.fun))
    assert int(r.n_outer) == 1


def test_analytic_value_and_grad_path():
    def f(z):
        return -jnp.sum((z - 1.0) ** 2)

    def vag(z):
        return -jnp.sum((z - 1.0) ** 2), -2.0 * (z - 1.0)

    r_ad = qnm.optimize_auglag(f, jnp.zeros(3), eq=lambda z: jnp.sum(z))
    r_an = qnm.optimize_auglag(f, jnp.zeros(3), eq=lambda z: jnp.sum(z),
                               value_and_grad_fn=vag)
    assert bool(r_ad.converged) and bool(r_an.converged)
    np.testing.assert_allclose(np.asarray(r_ad.x), np.asarray(r_an.x),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(r_ad.x), np.zeros(3), atol=1e-7)


def test_warm_start_multipliers():
    """Starting lam at the true multiplier solves in fewer outer rounds
    than cold (the first round is already the exact Lagrangian)."""
    cold = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h)
    warm = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h,
                               lam0=jnp.asarray([2.0]))
    assert bool(cold.converged) and bool(warm.converged)
    assert int(warm.n_outer) < int(cold.n_outer)
    np.testing.assert_allclose(np.asarray(warm.x), [1.0, 0.0], atol=1e-7)


def test_f32_stays_f32():
    r = qnm.optimize_auglag(
        lambda z: -jnp.sum(z * z), jnp.ones(2, jnp.float32),
        ineq=lambda z: z[0] + z[1] - 1.0, tol=1e-3, ctol=1e-3,
    )
    assert r.x.dtype == jnp.float32
    assert r.lam.dtype == jnp.float32 and r.mu.dtype == jnp.float32
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [0.5, 0.5], atol=1e-3)


def test_validation_errors():
    f = lambda z: -jnp.sum(z * z)  # noqa: E731
    h = lambda z: z[0] - 1.0  # noqa: E731
    with pytest.raises(ValueError, match="rank 1 .*or rank 2"):
        qnm.optimize_auglag(f, jnp.zeros((4, 2, 2)), eq=h)
    with pytest.raises(ValueError, match="at least one of"):
        qnm.optimize_auglag(f, jnp.zeros(2))
    with pytest.raises(ValueError, match="engine must be"):
        qnm.optimize_auglag(f, jnp.zeros(2), eq=h, engine="newton")
    with pytest.raises(TypeError, match="eq must be callable"):
        qnm.optimize_auglag(f, jnp.zeros(2), eq=3.0)
    with pytest.raises(ValueError, match="lam0 given without"):
        qnm.optimize_auglag(f, jnp.zeros(2), ineq=h, lam0=jnp.ones(1))
    with pytest.raises(ValueError, match="mu0 must be elementwise"):
        qnm.optimize_auglag(f, jnp.zeros(2), ineq=h,
                            mu0=jnp.asarray([-1.0]))
    with pytest.raises(ValueError, match="shape"):
        qnm.optimize_auglag(f, jnp.zeros(2), eq=h, lam0=jnp.ones(3))
    with pytest.raises(ValueError, match="rank-0/1"):
        qnm.optimize_auglag(f, jnp.zeros(2),
                            eq=lambda z: jnp.outer(z, z))
    with pytest.raises(ValueError, match="max_outer"):
        qnm.optimize_auglag(f, jnp.zeros(2), eq=h, max_outer=0)
    with pytest.raises(ValueError, match="rho0"):
        qnm.optimize_auglag(f, jnp.zeros(2), eq=h, rho0=-1.0)


def test_minimize_constrained_route():
    """The scipy-shaped surface: minimize (x-2)² + (y-1)² s.t. x+y=1.
    Solution (1, 0), min value 2; the minimization-Lagrangian multiplier
    of L = g + λ·h is λ = 2 (∇g(1,0) = (-2,-2) = -λ∇h). lam/mu pass
    through UNCHANGED from the max-form solve (convention-invariant,
    see minimize docstring); fun/grad flip."""

    def g(z):
        return (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2

    r = qnm.minimize(g, jnp.zeros(2), eq=lambda z: z[0] + z[1] - 1.0)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(r.fun), 2.0, atol=1e-6)  # minimized
    np.testing.assert_allclose(float(r.lam[0]), 2.0, atol=1e-5)
    # r.grad is the gradient of g (the MINIMIZED function) at x
    np.testing.assert_allclose(np.asarray(r.grad), [-2.0, -2.0],
                               atol=1e-5)

    # inequality via minimize: min x²+y² s.t. x+y >= 1 -> (.5,.5), mu=1
    r2 = qnm.minimize(lambda z: jnp.sum(z * z), jnp.zeros(2),
                      ineq=lambda z: z[0] + z[1] - 1.0, method="cg")
    assert bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r2.x), [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(float(r2.mu[0]), 1.0, atol=1e-5)

    # auglag knobs ride kwargs; bad method refuses
    r3 = qnm.minimize(g, jnp.zeros(2), eq=lambda z: z[0] + z[1] - 1.0,
                      lam0=jnp.asarray([2.0]), max_outer=4)
    assert bool(r3.converged) and int(r3.n_outer) <= 4
    with pytest.raises(ValueError, match="constrained minimize"):
        qnm.minimize(g, jnp.zeros((2,)), eq=lambda z: z[0],
                     method="nelder-mead")


def test_rosenbrock_on_a_disk():
    """The scipy-docs classic, in maximization form: maximize
    -rosenbrock(x, y) s.t. x² + y² <= 2. The unconstrained optimum
    (1, 1) sits exactly ON the boundary and remains the solution."""

    def f(z):
        return -(100.0 * (z[1] - z[0] ** 2) ** 2 + (1.0 - z[0]) ** 2)

    r = qnm.optimize_auglag(
        f, jnp.zeros(2), ineq=lambda z: 2.0 - jnp.sum(z * z),
        engine="tr",
    )
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [1.0, 1.0], atol=1e-5)


# ---------------------------------------------------------------------------
# Constrained fleets (round 5): masked-lockstep batched auglag
# ---------------------------------------------------------------------------


def _disk_ineq(z):
    return 1.5**2 - jnp.sum(z * z)


@pytest.mark.parametrize("engine", ["bfgs", "lbfgs", "cg", "tr"])
def test_fleet_scalar_parity_all_engines(engine):
    """Every engine's constrained fleet must agree lane-by-lane with the
    scalar auglag: same status, same KKT point / value / multipliers at
    certificate resolution, same outer-round count (the masking must not
    perturb a lane's own trajectory through the multiplier updates)."""
    from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity

    rng = np.random.default_rng(0)
    X0 = jnp.asarray(rng.standard_normal((5, 6)) * 0.3)
    fleet = qnm.optimize_auglag(
        rosenbrock_logdensity, X0, ineq=_disk_ineq, engine=engine
    )
    assert fleet.x.shape == X0.shape
    for i in range(X0.shape[0]):
        s = qnm.optimize_auglag(
            rosenbrock_logdensity, X0[i], ineq=_disk_ineq, engine=engine
        )
        assert int(fleet.status[i]) == int(s.status)
        assert int(fleet.n_outer[i]) == int(s.n_outer)
        if bool(s.converged):
            np.testing.assert_allclose(
                np.asarray(fleet.x[i]), np.asarray(s.x), rtol=1e-6,
                atol=1e-8,
            )
            np.testing.assert_allclose(
                float(fleet.fun[i]), float(s.fun), rtol=1e-8, atol=1e-12
            )
            np.testing.assert_allclose(
                np.asarray(fleet.mu[i]), np.asarray(s.mu), rtol=1e-5,
                atol=1e-8,
            )


def test_fleet_heterogeneous_outer_counts():
    """Warm-started lanes certify in fewer outer rounds than cold lanes
    in the SAME fleet — per-lane (λ, μ, ρ) state and per-lane freezing,
    not a shared outer schedule. The frozen lane's multipliers must not
    move after its success round (parity with its own scalar solve)."""
    X0 = jnp.zeros((2, 2))
    lam0 = jnp.asarray([[2.0], [0.0]])  # lane 0 starts at the true lam
    fleet = qnm.optimize_auglag(_quad, X0, eq=_h, lam0=lam0)
    assert bool(fleet.converged.all())
    assert int(fleet.n_outer[0]) < int(fleet.n_outer[1])
    warm = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h,
                               lam0=jnp.asarray([2.0]))
    cold = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h)
    assert int(fleet.n_outer[0]) == int(warm.n_outer)
    assert int(fleet.n_outer[1]) == int(cold.n_outer)
    np.testing.assert_allclose(float(fleet.lam[0, 0]), float(warm.lam[0]),
                               rtol=1e-8)
    np.testing.assert_allclose(float(fleet.lam[1, 0]), float(cold.lam[0]),
                               rtol=1e-8)
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(fleet.x[i]), [1.0, 0.0],
                                   atol=1e-6)


def test_fleet_mixed_eq_ineq():
    """Mixed constraints in a fleet: maximize -(x-2)²-(y-1)² s.t.
    x+y = 1 (eq) and x >= 0.8 / x >= 0 per the shared ineq; lanes from
    different starts land on the same KKT point."""

    def ineq(z):
        return z[0]  # x >= 0 (inactive at the solution x=1)

    X0 = jnp.asarray([[0.0, 0.0], [3.0, -2.0], [-1.0, 2.0]])
    r = qnm.optimize_auglag(_quad, X0, eq=_h, ineq=ineq)
    assert bool(r.converged.all())
    for i in range(3):
        np.testing.assert_allclose(np.asarray(r.x[i]), [1.0, 0.0],
                                   atol=1e-6)
        np.testing.assert_allclose(float(r.lam[i, 0]), 2.0, atol=1e-5)
        # inactive inequality: mu = 0
        np.testing.assert_allclose(float(r.mu[i, 0]), 0.0, atol=1e-8)
    assert r.eq.shape == (3, 1) and r.ineq.shape == (3, 1)


def test_fleet_per_lane_failure_isolation():
    """One lane's objective is non-finite from its start (log of a
    negative coordinate); the other lanes must certify untouched, the bad
    lane reports NONFINITE_VALUE with fun NaN, and NO NaN leaks across
    lanes (the round-1 masking lesson, constrained edition)."""

    def f(z):
        return jnp.log(z[0]) - jnp.sum((z - 1.0) ** 2)

    def ineq(z):
        return 3.0 - jnp.sum(z * z)

    X0 = jnp.asarray([[1.0, 0.5], [-1.0, 0.5], [0.7, 1.2]])
    r = qnm.optimize_auglag(f, X0, ineq=ineq, max_outer=8)
    assert bool(r.converged[0]) and bool(r.converged[2])
    assert int(r.status[1]) == int(Status.NONFINITE_VALUE)
    assert np.isnan(float(r.fun[1]))
    assert int(r.n_outer[1]) == 1  # hard failure freezes immediately
    assert np.isfinite(np.asarray(r.x[0])).all()
    assert np.isfinite(float(r.fun[0])) and np.isfinite(float(r.fun[2]))
    # the failed lane's iterate stays at its start (never took a step)
    np.testing.assert_allclose(np.asarray(r.x[1]), X0[1])


def test_fleet_multiplier_broadcast_and_validation():
    """(m,) warm starts broadcast across lanes; (batch, m) passes
    through; wrong shapes raise."""
    X0 = jnp.zeros((3, 2))
    r_b = qnm.optimize_auglag(_quad, X0, eq=_h, lam0=jnp.asarray([2.0]))
    assert bool(r_b.converged.all())
    assert r_b.lam.shape == (3, 1)
    with pytest.raises(ValueError, match="shape"):
        qnm.optimize_auglag(_quad, X0, eq=_h, lam0=jnp.ones((2, 1)))
    r32 = qnm.optimize_auglag(
        lambda z: -jnp.sum(z * z), jnp.ones((4, 2), jnp.float32),
        ineq=lambda z: z[0] + z[1] - 1.0, tol=1e-3, ctol=1e-3,
    )
    assert r32.x.dtype == jnp.float32 and r32.mu.dtype == jnp.float32
    assert bool(r32.converged.all())
    np.testing.assert_allclose(
        np.asarray(r32.x), np.full((4, 2), 0.5), atol=1e-3
    )


def test_fleet_minimize_routing():
    """minimize with eq/ineq and a rank-2 x0 routes through the
    constrained fleet; fun/grad flip to the minimization convention
    per lane."""

    def g(z):
        return (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2

    X0 = jnp.asarray([[0.0, 0.0], [2.0, 2.0]])
    r = qnm.minimize(g, X0, eq=lambda z: z[0] + z[1] - 1.0)
    assert bool(r.converged.all())
    np.testing.assert_allclose(np.asarray(r.x),
                               [[1.0, 0.0], [1.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(np.asarray(r.fun), [2.0, 2.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(r.lam[:, 0]), [2.0, 2.0],
                               atol=1e-5)


def test_fleet_infeasible_lane_in_band():
    """A fleet mixing a feasible problem with a lane that CANNOT reach
    feasibility... constraints are shared across the fleet, so
    heterogeneous feasibility comes from heterogeneous STARTS on a
    nonconvex feasible set; here every lane shares the infeasible eq
    pair and the whole fleet must exhaust in-band (MAX_ITERATIONS,
    fun NaN, viol > 0) without wedging the while loop."""
    r = qnm.optimize_auglag(
        lambda z: -jnp.sum(z * z), jnp.zeros((3, 1)),
        eq=lambda z: jnp.asarray([z[0] - 1.0, z[0] - 2.0]),
        max_outer=6,
    )
    assert not bool(r.converged.any())
    assert np.all(np.asarray(r.status) == int(Status.MAX_ITERATIONS))
    assert np.isnan(np.asarray(r.fun)).all()
    assert np.all(np.asarray(r.viol) > 0.1)
    assert np.all(np.asarray(r.n_outer) == 6)


def test_fleet_f32_chip_contract_shape():
    """The f32 constrained contract, CPU-pinned at the accelerator
    operating point (tol=ctol=1e-3 on the n=60 disk-constrained
    Rosenbrock, both engines): a smaller fleet of the same problem must certify at f32
    with the violation within ctol and every converged lane ON the
    active sphere (‖x‖² = 30 < 60 makes the unconstrained optimum
    infeasible)."""
    from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity

    R2 = 30.0

    def disk(z):
        return R2 - jnp.sum(z * z)

    rng = np.random.default_rng(7)
    X0 = jnp.asarray(rng.standard_normal((32, 60)), jnp.float32) * 0.5
    for engine in ("bfgs", "cg"):
        r = qnm.optimize_auglag(
            rosenbrock_logdensity, X0, ineq=disk, engine=engine,
            tol=1e-3, ctol=1e-3, max_iterations=2000,
        )
        assert r.x.dtype == jnp.float32
        assert bool(r.converged.all()), engine
        assert float(jnp.max(r.viol)) <= 1e-3
        np.testing.assert_allclose(
            np.asarray(jnp.sum(r.x**2, -1)), R2, atol=1e-2
        )


def test_auglag_warm_restart_resume_recipe():
    """Checkpoint/resume for constrained solves: the outer state IS
    (x, lam, mu, rho) — feeding a truncated run's result back via
    x0/lam0/mu0/rho0 continues the multiplier trajectory (the resume
    recipe documented in the optimize_auglag docstring). The chunked
    run must reach the same KKT point and multipliers as the one-shot
    run, in no more TOTAL outer rounds + 1 (the restart re-solves the
    current inner problem once)."""
    full = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h)
    assert bool(full.converged)
    leg1 = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h, max_outer=2)
    assert not bool(leg1.converged)  # truncated
    leg2 = qnm.optimize_auglag(
        _quad, leg1.x, eq=_h, lam0=leg1.lam, mu0=None,
        rho0=float(leg1.rho),
    )
    assert bool(leg2.converged)
    np.testing.assert_allclose(np.asarray(leg2.x), np.asarray(full.x),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(leg2.lam), np.asarray(full.lam),
                               rtol=1e-6)
    assert int(leg1.n_outer) + int(leg2.n_outer) <= int(full.n_outer) + 1


def test_fleet_analytic_value_and_grad_path():
    """The analytic-gradient override threads through the FLEET core
    (the scalar path already covers it): trajectory parity with AD."""

    def f(z):
        return -jnp.sum((z - 1.0) ** 2)

    def vag(z):
        return -jnp.sum((z - 1.0) ** 2), -2.0 * (z - 1.0)

    X0 = jnp.asarray([[0.0, 0.0, 0.0], [0.5, -0.5, 0.2]])
    r_ad = qnm.optimize_auglag(f, X0, eq=lambda z: jnp.sum(z))
    r_an = qnm.optimize_auglag(f, X0, eq=lambda z: jnp.sum(z),
                               value_and_grad_fn=vag)
    assert bool(r_ad.converged.all()) and bool(r_an.converged.all())
    np.testing.assert_allclose(np.asarray(r_an.x), np.asarray(r_ad.x),
                               atol=1e-10)
    np.testing.assert_array_equal(np.asarray(r_an.n_outer),
                                  np.asarray(r_ad.n_outer))


def test_fleet_warm_restart_resume_recipe():
    """The (x, lam, mu, rho) warm-restart recipe works at fleet rank too
    — per-lane multipliers feed back as (batch, m) arrays."""
    X0 = jnp.zeros((3, 2))
    full = qnm.optimize_auglag(_quad, X0, eq=_h)
    leg1 = qnm.optimize_auglag(_quad, X0, eq=_h, max_outer=2)
    assert not bool(leg1.converged.any())
    leg2 = qnm.optimize_auglag(
        _quad, leg1.x, eq=_h, lam0=leg1.lam,
        rho0=float(leg1.rho[0]),
    )
    assert bool(leg2.converged.all())
    np.testing.assert_allclose(np.asarray(leg2.x), np.asarray(full.x),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(leg2.lam), np.asarray(full.lam),
                               rtol=1e-6)


def test_fleet_per_lane_constraint_data():
    """constraint_data (the least_squares data= analog): one compiled
    program, per-lane feasible sets. Fleet of disk constraints with
    per-lane radii: maximize -||x - 2||^2 s.t. ||x||^2 <= r_i^2 — the
    analytic solution is x = 2*min(1, r_i/(2*sqrt(n)))... with x uniform:
    unconstrained optimum x = 2*ones has norm 2*sqrt(n); lanes with
    r_i < 2*sqrt(n) land ON their own sphere, larger-r lanes interior."""
    n = 4

    def f(z):
        return -jnp.sum((z - 2.0) ** 2)

    def disk(z, r2):
        return r2 - jnp.sum(z * z)

    r2s = jnp.asarray([1.0, 4.0, 100.0])  # last: unconstrained optimum OK
    X0 = jnp.full((3, n), 0.1)
    r = qnm.optimize_auglag(
        f, X0, ineq=disk, constraint_data=r2s, engine="bfgs",
    )
    assert bool(r.converged.all())
    norms2 = np.asarray(jnp.sum(r.x**2, -1))
    # active lanes sit on their own spheres
    np.testing.assert_allclose(norms2[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(norms2[1], 4.0, atol=1e-6)
    # inactive lane reaches the unconstrained optimum with mu = 0
    np.testing.assert_allclose(np.asarray(r.x[2]), 2.0, atol=1e-7)
    assert float(r.mu[2, 0]) == 0.0
    # per-lane scalar parity: each lane equals its own scalar solve
    for i in range(3):
        s = qnm.optimize_auglag(
            f, X0[i], ineq=disk, constraint_data=r2s[i], engine="bfgs",
        )
        assert int(s.status) == int(r.status[i])
        np.testing.assert_allclose(np.asarray(r.x[i]), np.asarray(s.x),
                                   rtol=1e-7, atol=1e-9)
    # all four engines accept data (smoke, 2 lanes)
    for engine in ("lbfgs", "cg", "tr"):
        re = qnm.optimize_auglag(
            f, X0[:2], ineq=disk, constraint_data=r2s[:2], engine=engine,
        )
        assert bool(re.converged.all()), engine
    # validation: missing batch axis
    import pytest as _pytest

    with _pytest.raises(ValueError, match="leading batch axis"):
        qnm.optimize_auglag(
            f, X0, ineq=disk, constraint_data=jnp.zeros(()),
        )


def test_auglag_last_value_contract():
    """last_value is f(x) at the final iterate regardless of status —
    the library-wide result convention (finite where fun is NaN on an
    exhausted budget; equal to fun on the certificate)."""
    ok = qnm.optimize_auglag(_quad, jnp.zeros(2), eq=_h)
    assert bool(ok.converged)
    np.testing.assert_allclose(float(ok.last_value), float(ok.fun))
    bad = qnm.optimize_auglag(
        lambda z: -jnp.sum(z * z), jnp.zeros(1),
        eq=lambda z: jnp.asarray([z[0] - 1.0, z[0] - 2.0]), max_outer=3,
    )
    assert np.isnan(float(bad.fun)) and np.isfinite(float(bad.last_value))
    # fleet rank + minimize sign flip
    fl = qnm.optimize_auglag(_quad, jnp.zeros((2, 2)), eq=_h)
    np.testing.assert_allclose(np.asarray(fl.last_value),
                               np.asarray(fl.fun))
    mn = qnm.minimize(lambda z: (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2,
                      jnp.zeros(2), eq=lambda z: z[0] + z[1] - 1.0)
    np.testing.assert_allclose(float(mn.last_value), float(mn.fun))
