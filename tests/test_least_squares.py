"""Levenberg–Marquardt nonlinear least squares (least_squares.py).

Family extension beyond the reference (the Gauss–Newton branch next to the
reference's secant branch, src/QuasiNewtonMethods.jl:34-69) — tested to the
same standards as the quasi-Newton engines: analytic fixtures with known
solutions, the in-band failure contract (fun NaN unless CONVERGED, iterate
frozen at the last good point), chunked-resume identity, checkpoint
round-trip, and an external-oracle parity check (scipy's MINPACK-style LM).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.state import Status


def rosen_res(x):
    # the classic Rosenbrock residual form: f(x) = 0.5*||r||^2 equals the
    # (chained) Rosenbrock function up to the usual 0.5/2 scaling
    return jnp.concatenate([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])


def test_linear_residuals_exact():
    # r = Ax - b: LM must land on the normal-equation solution and report
    # the exact Gauss-Newton matrix A^T A
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(12, 5)))
    b = jnp.asarray(rng.normal(size=12))
    res = qnm.least_squares(lambda x: A @ x - b, jnp.zeros(5))
    assert res.status == Status.CONVERGED
    x_ref = np.linalg.lstsq(np.asarray(A), np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(res.JTJ), np.asarray(A).T @ np.asarray(A), atol=1e-10
    )
    r_star = np.asarray(A) @ x_ref - np.asarray(b)
    np.testing.assert_allclose(float(res.fun), 0.5 * r_star @ r_star, rtol=1e-12)
    # quadratic objective: one accepted GN step (plus damping warmup) only
    assert int(res.iterations) <= 6


def test_rosenbrock_nls_converges():
    res = qnm.least_squares(rosen_res, jnp.full(10, -1.2))
    assert res.status == Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)
    assert float(res.fun) < 1e-16
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    # LM exploits the least-squares structure: far fewer iterations than
    # the secant engines need on the same function
    assert int(res.iterations) < 60


def test_scipy_lm_parity():
    scipy_opt = pytest.importorskip("scipy.optimize")

    def f_np(x):
        return np.concatenate([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])

    ours = qnm.least_squares(rosen_res, jnp.full(10, -1.2))
    ref = scipy_opt.least_squares(f_np, np.full(10, -1.2), method="lm")
    np.testing.assert_allclose(np.asarray(ours.x), ref.x, atol=1e-8)


def test_fleet_curve_fit_with_per_lane_data():
    # the headline shape: B independent exponential-decay fits, each lane
    # with its own observations, one compiled lockstep program
    rng = np.random.default_rng(1)
    B, m = 64, 50
    t = jnp.linspace(0.0, 3.0, m)
    true = rng.uniform(0.5, 2.0, size=(B, 2))
    Y = true[:, :1] * np.exp(-true[:, 1:] * np.asarray(t)[None])
    Y = Y + 0.001 * rng.normal(size=(B, m))

    def expres(p, y):
        return p[0] * jnp.exp(-p[1] * t) - y

    res = qnm.least_squares(expres, jnp.ones((B, 2)), data=jnp.asarray(Y), tol=1e-8)
    assert (np.asarray(res.status) == int(Status.CONVERGED)).all()
    assert np.abs(np.asarray(res.x) - true).max() < 0.01
    # every result leaf carries the fleet axis
    assert res.x.shape == (B, 2) and res.JTJ.shape == (B, 2, 2)
    assert np.isfinite(np.asarray(res.fun)).all()


def test_jac_modes_agree():
    # fwd and rev jacobians are the same matrix -> identical trajectories
    x0 = jnp.full(6, -1.2)
    r_fwd = qnm.least_squares(rosen_res, x0, jac_mode="fwd")
    r_rev = qnm.least_squares(rosen_res, x0, jac_mode="rev")
    np.testing.assert_array_equal(np.asarray(r_fwd.x), np.asarray(r_rev.x))
    assert int(r_fwd.iterations) == int(r_rev.iterations)
    with pytest.raises(ValueError, match="jac_mode"):
        qnm.least_squares(rosen_res, x0, jac_mode="banana")


def test_underdetermined_m_less_than_n():
    # m < n: damped steps still minimize; auto mode picks reverse
    def r(x):
        return jnp.atleast_1d(jnp.sum(x) - 1.0)

    res = qnm.least_squares(r, jnp.zeros(4), tol=1e-10)
    assert res.status == Status.CONVERGED
    assert abs(float(jnp.sum(res.x)) - 1.0) < 1e-8


def test_resume_identity_and_checkpoint(tmp_path):
    x0 = jnp.full(10, -1.2)
    long = qnm.least_squares(rosen_res, x0)

    part = qnm.least_squares(rosen_res, x0, max_iterations=3)
    assert part.status == Status.MAX_ITERATIONS
    assert np.isnan(float(part.fun))  # in-band contract on the cap path
    # checkpoint round-trip through the shared state serializer
    from quasinewtonmethods_jl_tpu.utils import load_state, save_state

    path = tmp_path / "lm_state"
    save_state(path, part.state)
    restored = load_state(path)
    cont = qnm.least_squares_from_state(rosen_res, restored)
    assert cont.status == Status.CONVERGED
    np.testing.assert_array_equal(np.asarray(cont.x), np.asarray(long.x))
    assert int(cont.iterations) == int(long.iterations)
    assert int(cont.n_jev) == int(long.n_jev)


def test_fleet_resume_with_data():
    rng = np.random.default_rng(3)
    B, m = 8, 30
    t = jnp.linspace(0.0, 2.0, m)
    true = rng.uniform(0.5, 2.0, size=(B, 2))
    Y = jnp.asarray(true[:, :1] * np.exp(-true[:, 1:] * np.asarray(t)[None]))

    def expres(p, y):
        return p[0] * jnp.exp(-p[1] * t) - y

    long = qnm.least_squares(expres, jnp.ones((B, 2)), data=Y)
    part = qnm.least_squares(expres, jnp.ones((B, 2)), data=Y, max_iterations=2)
    cont = qnm.least_squares_from_state(expres, part.state, data=Y)
    np.testing.assert_array_equal(np.asarray(cont.x), np.asarray(long.x))
    np.testing.assert_array_equal(
        np.asarray(cont.iterations), np.asarray(long.iterations)
    )


def test_nonfinite_at_start_is_in_band():
    res = qnm.least_squares(lambda x: jnp.sqrt(x) - 1.0, -jnp.ones(3))
    assert res.status == Status.NONFINITE_VALUE
    assert np.isnan(float(res.fun))
    assert int(res.iterations) == 0
    # iterate never moved
    np.testing.assert_array_equal(np.asarray(res.x), -np.ones(3))


def test_nan_wall_freezes_iterate():
    # residuals become NaN away from the start: every trial into the wall
    # is rejected, damping grows, the lane exits in-band with the iterate
    # still at the last good point (the 0*NaN protection class)
    def r(x):
        bad = jnp.max(jnp.abs(x)) > 0.75
        return jnp.where(bad, jnp.nan, 1.0) * jnp.concatenate([x - 2.0, x[:1] * 0])

    x0 = 0.5 * jnp.ones(3)
    res = qnm.least_squares(r, x0, lam_max=1e12)
    assert res.status == Status.LINESEARCH_FAILURE
    assert np.isnan(float(res.fun))
    assert np.isfinite(float(res.last_value))
    assert np.isfinite(np.asarray(res.x)).all()
    assert (np.abs(np.asarray(res.x)) <= 0.75).all()


def test_mixed_fleet_statuses():
    # lane 0 converges; lane 1 starts non-finite; independent in one batch
    def r(x):
        return jnp.concatenate([jnp.sqrt(x[:1]), x - 1.0])

    x0 = jnp.stack([jnp.ones(3), -jnp.ones(3)])
    res = qnm.least_squares(r, x0, tol=1e-8)
    status = np.asarray(res.status)
    assert status[0] == int(Status.CONVERGED)
    assert status[1] == int(Status.NONFINITE_VALUE)
    assert np.isfinite(float(res.fun[0])) and np.isnan(float(res.fun[1]))


def test_f32_fleet_converges_at_relaxed_tol():
    # the f32 numerical contract: f32 engines certify at tol >= ~1e-3
    res = qnm.least_squares(
        rosen_res, jnp.full((4, 8), -1.2, jnp.float32), tol=1e-3
    )
    assert (np.asarray(res.status) == int(Status.CONVERGED)).all()
    assert np.asarray(res.x).dtype == np.float32
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-2)


def test_input_validation():
    with pytest.raises(ValueError, match="rank 1 or 2"):
        qnm.least_squares(rosen_res, jnp.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="batch axis"):
        qnm.least_squares(
            lambda x, d: x - d, jnp.zeros((4, 3)), data=jnp.zeros((5, 3))
        )
    with pytest.raises(ValueError, match="max_iterations"):
        qnm.least_squares(rosen_res, jnp.zeros(3), max_iterations=0)
    with pytest.raises(ValueError, match="rank-1"):
        qnm.least_squares(lambda x: jnp.outer(x, x), jnp.ones(3))


def test_gauss_newton_mass_handoff_orientation():
    # result.JTJ at a Gaussian log-likelihood's MAP is the negative Hessian
    # of the logdensity — the orientation the samplers take a dense metric
    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.normal(size=(9, 4)))
    b = jnp.asarray(rng.normal(size=9))
    res = qnm.least_squares(lambda x: A @ x - b, jnp.zeros(4))

    neg_hess = -jax.hessian(lambda x: -0.5 * jnp.sum((A @ x - b) ** 2))(res.x)
    np.testing.assert_allclose(np.asarray(res.JTJ), np.asarray(neg_hess), atol=1e-9)


def test_vmap_vs_fleet_consistency():
    # the fleet engine's lanes match independent scalar solves (the same
    # cross-engine bar the BFGS fleets are held to); LM has no line-search
    # trip-count coupling so the match is exact
    x0s = jnp.stack([jnp.full(6, -1.2), jnp.zeros(6), jnp.full(6, 0.7)])
    fleet = qnm.least_squares(rosen_res, x0s)
    for i in range(x0s.shape[0]):
        single = qnm.least_squares(rosen_res, x0s[i])
        np.testing.assert_array_equal(np.asarray(fleet.x[i]), np.asarray(single.x))
        assert int(fleet.iterations[i]) == int(single.iterations)
        assert int(fleet.status[i]) == int(single.status)


# --- robust losses (M-estimation) -------------------------------------------


def _robust_objective(residual_fn, loss, f_scale):
    """Analytic robust objective 0.5*C^2*sum(rho(r^2/C^2)) — the ground
    truth the engine's carried (fun, g) must match."""
    from quasinewtonmethods_jl_tpu.least_squares import _rho_derivs

    def F(x):
        r = residual_fn(x)
        z = (r * r) / (f_scale * f_scale)
        rho, _, _ = _rho_derivs(z, loss)
        return 0.5 * f_scale * f_scale * jnp.sum(rho)

    return F


@pytest.mark.parametrize("loss", ["huber", "soft_l1", "cauchy", "arctan"])
def test_robust_fun_and_grad_match_ad(loss):
    # the engine's per-iteration (fun, g) are the exact value/gradient of
    # the robust objective — pinned against jax.grad of the closed form
    from quasinewtonmethods_jl_tpu.least_squares import _make_fun_grad_gn

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=6))
    f_scale = 0.37
    F = _robust_objective(rosen_res, loss, f_scale)

    r = rosen_res(x)[None]
    J = jax.jacfwd(rosen_res)(x)[None]
    fun, g, JTJ = _make_fun_grad_gn(loss, f_scale)(r, J)

    np.testing.assert_allclose(float(fun[0]), float(F(x)), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(g[0]), np.asarray(jax.grad(F)(x)), rtol=1e-10, atol=1e-12
    )
    # model matrix is symmetric PSD (Triggs weights floored at eps)
    np.testing.assert_allclose(
        np.asarray(JTJ[0]), np.asarray(JTJ[0]).T, atol=1e-12
    )
    assert np.linalg.eigvalsh(np.asarray(JTJ[0])).min() > -1e-10


@pytest.mark.parametrize("loss", ["huber", "soft_l1", "cauchy"])
def test_robust_fit_scipy_parity(loss):
    # same loss/f_scale conventions as scipy.optimize.least_squares: the
    # robust exponential fit with outliers lands on scipy's solution
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(11)
    t = np.linspace(0.0, 3.0, 40)
    y = 1.5 * np.exp(-0.8 * t) + 0.01 * rng.normal(size=40)
    y[::8] += rng.choice([-2.0, 3.0], size=y[::8].shape)  # gross outliers

    tj, yj = jnp.asarray(t), jnp.asarray(y)

    def res_j(p):
        return p[0] * jnp.exp(-p[1] * tj) - yj

    def res_np(p):
        return p[0] * np.exp(-p[1] * t) - y

    # tol=1e-8: the robust gradient's f64 rounding floor on this fixture is
    # ~5e-9 (measured — cancellations in the reweighted sums), and scipy's
    # own converged x sits ~1e-6 from ours with BOTH gradients at their
    # floors, so 1e-5 is the honest parity bar
    ours = qnm.least_squares(
        res_j, jnp.ones(2), loss=loss, f_scale=0.1, tol=1e-8
    )
    ref = scipy_opt.least_squares(
        res_np, np.ones(2), loss=loss, f_scale=0.1, method="trf",
        xtol=1e-14, gtol=1e-14,
    )
    assert ours.status == Status.CONVERGED
    np.testing.assert_allclose(np.asarray(ours.x), ref.x, atol=1e-5)
    # and the robust fit actually rejects the outliers (huber/soft_l1 only
    # down-weight them linearly, so ~0.05 residual bias remains; the L2 fit
    # on this fixture is ~0.5 off)
    assert abs(float(ours.x[0]) - 1.5) < 0.08
    assert abs(float(ours.x[1]) - 0.8) < 0.08


def test_linear_loss_pulled_by_outliers_robust_is_not():
    rng = np.random.default_rng(13)
    t = np.linspace(0.0, 3.0, 60)
    y = 1.5 * np.exp(-0.8 * t) + 0.01 * rng.normal(size=60)
    y[5:60:10] += 4.0  # one-sided outliers: the L2 fit must bias upward

    tj, yj = jnp.asarray(t), jnp.asarray(y)

    def res_j(p):
        return p[0] * jnp.exp(-p[1] * tj) - yj

    plain = qnm.least_squares(res_j, jnp.ones(2))
    robust = qnm.least_squares(res_j, jnp.ones(2), loss="cauchy", f_scale=0.1)
    err_plain = abs(float(plain.x[0]) - 1.5) + abs(float(plain.x[1]) - 0.8)
    err_robust = abs(float(robust.x[0]) - 1.5) + abs(float(robust.x[1]) - 0.8)
    assert err_plain > 5 * err_robust
    # fun is the ROBUST objective on the robust path (contract: the value
    # whose gradient certifies convergence)
    F = _robust_objective(res_j, "cauchy", 0.1)
    np.testing.assert_allclose(float(robust.fun), float(F(robust.x)), rtol=1e-10)


def test_robust_fleet_resume_identity():
    rng = np.random.default_rng(17)
    B, m = 6, 30
    t = jnp.linspace(0.0, 2.0, m)
    true = rng.uniform(0.5, 2.0, size=(B, 2))
    Y = np.asarray(true[:, :1] * np.exp(-true[:, 1:] * np.asarray(t)[None]))
    Y[:, ::7] += 1.5
    Y = jnp.asarray(Y)

    def expres(p, y):
        return p[0] * jnp.exp(-p[1] * t) - y

    kw = dict(data=Y, loss="soft_l1", f_scale=0.2)
    long = qnm.least_squares(expres, jnp.ones((B, 2)), **kw)
    part = qnm.least_squares(expres, jnp.ones((B, 2)), max_iterations=2, **kw)
    cont = qnm.least_squares_from_state(expres, part.state, **kw)
    np.testing.assert_array_equal(np.asarray(cont.x), np.asarray(long.x))
    np.testing.assert_array_equal(
        np.asarray(cont.iterations), np.asarray(long.iterations)
    )
    assert (np.asarray(long.status) == int(Status.CONVERGED)).all()


def test_robust_loss_validation():
    with pytest.raises(ValueError, match="loss"):
        qnm.least_squares(rosen_res, jnp.zeros(3), loss="l1")
    with pytest.raises(ValueError, match="f_scale"):
        qnm.least_squares(rosen_res, jnp.zeros(3), loss="huber", f_scale=0.0)
    with pytest.raises(ValueError, match="loss"):
        qnm.least_squares_from_state(
            rosen_res,
            qnm.least_squares(rosen_res, jnp.zeros(3), max_iterations=1).state,
            loss="nope",
        )


# --- box constraints (projected LM) ------------------------------------------


def test_bounds_active_face_scipy_parity():
    # unconstrained optimum of the exponential fit is (1.5, 0.8); cap the
    # rate at 0.5 so the upper bound is active — projected LM must land on
    # scipy TRF's bounded solution
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(19)
    t = np.linspace(0.0, 3.0, 40)
    y = 1.5 * np.exp(-0.8 * t) + 0.01 * rng.normal(size=40)
    tj, yj = jnp.asarray(t), jnp.asarray(y)

    def res_j(p):
        return p[0] * jnp.exp(-p[1] * tj) - yj

    def res_np(p):
        return p[0] * np.exp(-p[1] * t) - y

    lo, hi = np.array([0.0, 0.0]), np.array([10.0, 0.5])
    x0 = np.array([1.0, 0.4])  # scipy requires x0 strictly inside the box
    ours = qnm.least_squares(res_j, jnp.asarray(x0), bounds=(lo, hi), tol=1e-7)
    ref = scipy_opt.least_squares(
        res_np, x0, bounds=(lo, hi), method="trf",
        xtol=1e-14, gtol=1e-14,
    )
    assert ours.status == Status.CONVERGED
    np.testing.assert_allclose(np.asarray(ours.x), ref.x, atol=1e-6)
    assert abs(float(ours.x[1]) - 0.5) < 1e-12  # the bound is active
    # KKT at the upper face: the gradient must push OUT of the box (g <= 0)
    assert float(ours.grad[1]) < 0


def test_bounds_interior_matches_unbounded():
    # loose box: the constrained solve must find the same (interior)
    # solution as the unconstrained engine
    x0 = jnp.full(6, -1.2)
    free = qnm.least_squares(rosen_res, x0)
    boxed = qnm.least_squares(rosen_res, x0, bounds=(-5.0, 5.0))
    assert boxed.status == Status.CONVERGED
    np.testing.assert_allclose(
        np.asarray(boxed.x), np.asarray(free.x), atol=1e-8
    )
    # the certificate reduces to max|g| in the interior
    assert float(jnp.max(jnp.abs(boxed.grad))) < 1e-8


def test_bounds_one_sided_and_infinite():
    # +/-inf entries leave coordinates free / one-sided; constrain only x[0]
    def r(x):
        return x - jnp.asarray([2.0, -3.0, 0.5])

    lo = jnp.asarray([-jnp.inf, -jnp.inf, -jnp.inf])
    hi = jnp.asarray([1.0, jnp.inf, jnp.inf])
    # tol=1e-7, not tighter: f* = 0.5 at the bounded solution, so the f64
    # certificate floor is ~sqrt(eps*f*) ~ 1e-8 (docstring contract)
    res = qnm.least_squares(r, jnp.zeros(3), bounds=(lo, hi), tol=1e-7)
    assert res.status == Status.CONVERGED
    np.testing.assert_allclose(
        np.asarray(res.x), [1.0, -3.0, 0.5], atol=1e-8
    )


def test_bounds_per_lane_and_x0_clipped():
    # per-lane boxes (batch axis on lo/hi); lane 1's x0 starts OUTSIDE its
    # box and must be clipped in before the first evaluation
    def r(x):
        return x - 2.0

    x0 = jnp.stack([jnp.zeros(3), jnp.full(3, 9.0)])
    lo = jnp.zeros((2, 3))
    hi = jnp.stack([jnp.full(3, 5.0), jnp.full(3, 1.0)])
    res = qnm.least_squares(r, x0, bounds=(lo, hi), tol=1e-10)
    assert (np.asarray(res.status) == int(Status.CONVERGED)).all()
    np.testing.assert_allclose(np.asarray(res.x[0]), 2.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.x[1]), 1.0, atol=1e-8)
    # iterate stayed inside each lane's box the whole way (final check)
    assert (np.asarray(res.x) <= np.asarray(hi) + 1e-12).all()
    assert (np.asarray(res.x) >= np.asarray(lo) - 1e-12).all()


def test_bounds_resume_identity():
    rng = np.random.default_rng(23)
    t = jnp.linspace(0.0, 3.0, 40)
    y = jnp.asarray(
        1.5 * np.exp(-0.8 * np.asarray(t)) + 0.01 * rng.normal(size=40)
    )

    def res_j(p):
        return p[0] * jnp.exp(-p[1] * t) - y

    bounds = (jnp.zeros(2), jnp.asarray([10.0, 0.5]))
    long = qnm.least_squares(res_j, jnp.ones(2), bounds=bounds)
    part = qnm.least_squares(res_j, jnp.ones(2), bounds=bounds, max_iterations=2)
    cont = qnm.least_squares_from_state(res_j, part.state, bounds=bounds)
    assert cont.status == Status.CONVERGED
    np.testing.assert_array_equal(np.asarray(cont.x), np.asarray(long.x))
    assert int(cont.iterations) == int(long.iterations)


def test_bounds_compose_with_robust_loss():
    # robust weights and the projected step are orthogonal features; both
    # apply in one solve and the constrained robust optimum matches
    # scipy's TRF with the same bounds + loss
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(29)
    t = np.linspace(0.0, 3.0, 40)
    y = 1.5 * np.exp(-0.8 * t) + 0.01 * rng.normal(size=40)
    y[::8] += 3.0
    tj, yj = jnp.asarray(t), jnp.asarray(y)

    def res_j(p):
        return p[0] * jnp.exp(-p[1] * tj) - yj

    def res_np(p):
        return p[0] * np.exp(-p[1] * t) - y

    res = qnm.least_squares(
        res_j, jnp.asarray([1.0, 0.4]), bounds=(0.0, jnp.asarray([10.0, 0.6])),
        loss="cauchy", f_scale=0.1, tol=1e-7,
    )
    ref = scipy_opt.least_squares(
        res_np, np.array([1.0, 0.4]), bounds=(np.zeros(2), np.array([10.0, 0.6])),
        method="trf", loss="cauchy", f_scale=0.1, xtol=1e-14, gtol=1e-14,
    )
    assert res.status == Status.CONVERGED
    assert float(res.x[1]) <= 0.6 + 1e-12
    np.testing.assert_allclose(np.asarray(res.x), ref.x, atol=1e-5)


def test_bounds_validation():
    with pytest.raises(ValueError, match="pair"):
        qnm.least_squares(rosen_res, jnp.zeros(3), bounds=1.0)
    with pytest.raises(ValueError, match="lower < upper"):
        qnm.least_squares(rosen_res, jnp.zeros(3), bounds=(1.0, -1.0))
