"""Batched-solve tests: vmap path, native fused driver, Pallas kernel oracle.

The key property (SURVEY.md §4 test plan): vmap-batch equivalence vs single
solves, plus equivalence between the two batched execution engines (vmap of
the scalar solver vs the native batch-minor driver) and between the fused
batched update and the single-lane reference update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu.ops.bfgs import (
    bfgs_update,
    fused_bfgs_update_reference,
)


def quad_logdensity(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


def test_vmap_batch_matches_single_solves(rng):
    n, batch = 8, 12
    X0 = jnp.asarray(rng.standard_normal((batch, n)))
    res_b = qnm.optimize_batched(rosenbrock_logdensity, X0, backend="vmap")
    for b in range(batch):
        res_s = qnm.optimize(rosenbrock_logdensity, X0[b])
        assert int(res_b.status[b]) == int(res_s.status)
        # The vmapped and scalar programs compile differently (cond->select,
        # different fusion/reassociation), so trajectories drift at rounding
        # level; both must land on the optimum to solver tolerance.
        np.testing.assert_allclose(
            np.asarray(res_b.x[b]), np.asarray(res_s.x), atol=1e-7
        )
        np.testing.assert_allclose(
            float(res_b.fun[b]), float(res_s.fun), atol=1e-14
        )


def test_fused_driver_converges(rng):
    n, batch = 10, 32
    X0 = jnp.asarray(rng.standard_normal((batch, n)))
    res = optimize_batched_fused(rosenbrock_logdensity, X0)
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8


def test_fused_matches_vmap_on_quadratic(rng):
    """On a strictly concave quadratic the trajectory is numerically stable,
    so the two engines must agree to tight tolerance lane by lane."""
    n, batch = 6, 8
    X0 = jnp.asarray(rng.standard_normal((batch, n)))
    r_vmap = qnm.optimize_batched(quad_logdensity, X0, backend="vmap")
    r_fused = optimize_batched_fused(quad_logdensity, X0)
    assert np.all(np.asarray(r_vmap.status) == np.asarray(r_fused.status))
    np.testing.assert_allclose(
        np.asarray(r_vmap.x), np.asarray(r_fused.x), atol=1e-10
    )
    np.testing.assert_array_equal(
        np.asarray(r_vmap.iterations), np.asarray(r_fused.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(r_vmap.last_value), np.asarray(r_fused.last_value), atol=1e-12
    )


def test_fused_rosenbrock_matches_vmap_quality(rng):
    n, batch = 7, 16
    X0 = jnp.asarray(rng.standard_normal((batch, n)))
    r_vmap = qnm.optimize_batched(rosenbrock_logdensity, X0, backend="vmap")
    r_fused = optimize_batched_fused(rosenbrock_logdensity, X0)
    # fp reassociation differences make trajectories diverge on Rosenbrock;
    # quality invariants must still match exactly.
    assert np.all(np.asarray(r_vmap.status) == qnm.Status.CONVERGED)
    assert np.all(np.asarray(r_fused.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(r_fused.x), np.asarray(r_vmap.x), atol=1e-6)


def test_fused_oracle_matches_single_lane_update(rng):
    """The closed-form fused update must agree with the reference-form
    single-lane bfgs_update (matvec through B_new) to fp tolerance."""
    n, batch = 9, 4
    B = np.zeros((n, n, batch))
    for b in range(batch):
        A = rng.standard_normal((n, n)) * 0.2
        B[:, :, b] = A @ A.T + np.eye(n)
    B = jnp.asarray(B)
    s = jnp.asarray(rng.standard_normal((n, batch)) * 0.1)
    g = jnp.asarray(rng.standard_normal((n, batch)))
    y = s + 0.01 * jnp.asarray(rng.standard_normal((n, batch)))
    gold = g + y
    active = jnp.ones((1, batch))

    Bo, do, mo, ro = fused_bfgs_update_reference(B, s, g, gold, active)
    for b in range(batch):
        B1, d1, m1 = bfgs_update(B[:, :, b], s[:, b], g[:, b], gold[:, b])
        if float(m1) > 0:  # non-reset lane: full update comparison
            np.testing.assert_allclose(np.asarray(Bo[:, :, b]), np.asarray(B1), atol=1e-10)
            np.testing.assert_allclose(np.asarray(do[:, b]), np.asarray(d1), atol=1e-10)
            np.testing.assert_allclose(float(mo[0, b]), float(m1), rtol=1e-9)


def test_fused_reset_and_frozen_lane_semantics(rng):
    n, batch = 5, 8
    eye = np.eye(n)
    B = jnp.asarray(np.tile(eye[:, :, None], (1, 1, batch)))
    # Analytic guaranteed-reset construction: with B = I, g = s and
    # y = g_old - g = -2s, the closed form gives m_pre = -||s||^2/2 < 0,
    # so every active lane must take the steepest-ascent reset.
    s = jnp.asarray(rng.standard_normal((n, batch)) * 0.1)
    g = s
    gold = -s
    active = jnp.ones((1, batch)).at[0, 0].set(0.0)

    Bo, do, mo, ro = fused_bfgs_update_reference(B, s, g, gold, active)
    # frozen lane 0: B unchanged, d = 0, m = 1
    np.testing.assert_array_equal(np.asarray(Bo[:, :, 0]), eye)
    assert np.all(np.asarray(do[:, 0]) == 0.0)
    assert float(mo[0, 0]) == 1.0
    # reset lanes: B = I, d = g, m = ||g||^2
    resets = np.asarray(ro[0]) > 0
    assert resets[1:].all() and not resets[0]
    for b in np.nonzero(resets)[0]:
        np.testing.assert_array_equal(np.asarray(Bo[:, :, b]), eye)
        np.testing.assert_allclose(np.asarray(do[:, b]), np.asarray(g[:, b]), rtol=1e-12)
        np.testing.assert_allclose(
            float(mo[0, b]), float(jnp.sum(g[:, b] ** 2)), rtol=1e-12
        )


def test_bfgs_unroll_is_trajectory_identical(rng):
    """unroll > 1 chains masked bodies per while step; every carry write
    is active-masked and the cap folds into was_active, so it must be
    trajectory-identical — same statuses, per-lane iteration counts
    (NEVER above max_iterations, the regression: trailing chain bodies
    used to re-activate still-RUNNING lanes past the cap), and optima —
    including a cap that is not a multiple of the unroll factor."""
    X0 = jnp.asarray(rng.standard_normal((6, 12)))
    kw = dict(tol=1e-6, max_iterations=50)
    base = optimize_batched_fused(rosenbrock_logdensity, X0, **kw)
    unr = optimize_batched_fused(rosenbrock_logdensity, X0, unroll=3, **kw)
    np.testing.assert_array_equal(
        np.asarray(unr.status), np.asarray(base.status)
    )
    np.testing.assert_array_equal(
        np.asarray(unr.iterations), np.asarray(base.iterations)
    )
    np.testing.assert_array_equal(np.asarray(unr.n_fev), np.asarray(base.n_fev))
    assert int(np.max(np.asarray(unr.iterations))) <= 50
    np.testing.assert_allclose(
        np.asarray(unr.x), np.asarray(base.x), rtol=1e-9, atol=1e-9
    )


def test_batched_failure_lane_isolated(rng):
    """One lane with a non-finite start must not poison the others."""
    n, batch = 6, 8
    X0 = np.asarray(rng.standard_normal((batch, n)))
    X0[3] = np.nan
    res = optimize_batched_fused(quad_logdensity, jnp.asarray(X0))
    status = np.asarray(res.status)
    assert status[3] == qnm.Status.NONFINITE_VALUE
    ok = np.ones(batch, bool)
    ok[3] = False
    assert np.all(status[ok] == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x)[ok], 0.0, atol=1e-8)
    assert np.isnan(float(res.fun[3]))


def test_multistart_picks_best_mode(rng):
    """Bimodal objective: the fleet must find both modes and report the
    better one."""
    # two gaussian bumps, the one at +3 taller
    def bimodal(x):
        a = -0.5 * jnp.sum((x - 3.0) ** 2)
        b = -0.5 * jnp.sum((x + 3.0) ** 2) - 1.0
        return jnp.logaddexp(a, b)

    res = qnm.optimize_multistart(
        bimodal, jax.random.PRNGKey(0), n_starts=64, dim=2, init_scale=4.0,
        tol=1e-6, backend="vmap",
    )
    assert bool(res.converged)
    assert int(res.n_converged) >= 32
    # best mode is the taller one near +3
    np.testing.assert_allclose(np.asarray(res.x), 3.0, atol=1e-2)
    assert float(res.fun) > -0.1


def test_multistart_all_failed_is_inband():
    f = lambda x: jnp.nan * jnp.sum(x)
    res = qnm.optimize_multistart(
        f, jax.random.PRNGKey(0), n_starts=8, dim=3, backend="vmap"
    )
    assert not bool(res.converged)
    assert np.isnan(float(res.fun))


def test_multistart_tr_engine(rng):
    """engine='tr': the TR fleet powers the multistart; saddle-ridden
    double-well geometry where secant updates struggle."""
    def wells(x):
        return -jnp.sum((x * x - 1.0) ** 2) - 0.1 * jnp.sum((x - 1.0) ** 2)

    res = qnm.optimize_multistart(
        wells, jax.random.PRNGKey(3), n_starts=32, dim=3, init_scale=0.3,
        tol=1e-7, engine="tr",
    )
    assert bool(res.converged)
    # the deepest well is the all-ones corner (the -0.1 tilt term)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-5)
    # fleet carries the TR result type (n_hev is TR-only)
    assert hasattr(res.fleet, "n_hev")
    with pytest.raises(ValueError, match="engine"):
        qnm.optimize_multistart(wells, jax.random.PRNGKey(0), n_starts=4,
                                dim=2, engine="newton")


def test_multistart_cg_engine(rng):
    """engine='cg': the O(n)-state fleet powers the multistart; the
    engine's Wolfe(approx=True) default applies (BackTracking() is the
    shim default, not a CG choice)."""
    def wells(x):
        return -jnp.sum((x * x - 1.0) ** 2) - 0.1 * jnp.sum((x - 1.0) ** 2)

    res = qnm.optimize_multistart(
        wells, jax.random.PRNGKey(3), n_starts=32, dim=3, init_scale=0.3,
        tol=1e-7, engine="cg",
    )
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-5)
    # fleet carries the CG result type (n_resets is CG/BFGS-family)
    assert hasattr(res.fleet, "n_resets") and hasattr(res.fleet, "n_gev")


def test_batched_resume_from_state(rng):
    """Stop a fleet early, checkpoint the batched state, resume to
    convergence — the batched analog of optimize_from_state."""
    from quasinewtonmethods_jl_tpu.batched_solve import (
        optimize_batched_fused_from_state,
    )
    from quasinewtonmethods_jl_tpu.utils import load_state, save_state
    import tempfile, os

    X0 = jnp.asarray(rng.standard_normal((16, 8)))
    part = optimize_batched_fused(rosenbrock_logdensity, X0,
                                  max_iterations=4)
    assert np.all(np.asarray(part.status) == qnm.Status.MAX_ITERATIONS)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "fleet.npz")
        save_state(p, part.state)
        restored = load_state(p, qnm.BFGSState)
    res = optimize_batched_fused_from_state(
        rosenbrock_logdensity, restored
    )
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)
    # counters continue
    assert np.all(np.asarray(res.iterations) > 4)


def test_multistart_constrained_route():
    """Round 5: eq/ineq route the fleet through the constrained auglag
    fleet — a two-KKT-point problem (maximize d.x on the unit circle
    has one max and one min; starts clustered near both) must pick the
    TRUE constrained max among KKT-certified lanes only."""
    d = jnp.asarray([1.0, 2.0])

    def f(z):
        return d @ z  # linear — unbounded without the constraint

    def circle(z):
        return jnp.asarray([jnp.sum(z * z) - 1.0])

    x_max = np.asarray([1.0, 2.0]) / np.sqrt(5.0)
    starts = jnp.asarray(np.concatenate([
        x_max[None] + 0.05 * np.random.default_rng(0).standard_normal((4, 2)),
        -x_max[None] + 0.05 * np.random.default_rng(1).standard_normal((4, 2)),
    ]))
    r = qnm.optimize_multistart(
        f, jax.random.PRNGKey(0), 8, 2, x0s=starts, eq=circle,
    )
    assert bool(r.converged)
    assert int(r.n_converged) >= 4
    np.testing.assert_allclose(np.asarray(r.x), x_max, atol=1e-5)
    np.testing.assert_allclose(float(r.fun), np.sqrt(5.0), atol=1e-6)
    # fleet is the full AugLagResult: per-lane multipliers available
    assert r.fleet.lam.shape == (8, 1)
