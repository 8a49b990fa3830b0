"""L-BFGS tests: two-loop recursion correctness + large-n convergence.

The recursion is validated against an explicit dense reconstruction of the
implicit inverse Hessian (the product form H = V'HV + rho ss'), and the
driver against the BASELINE configs (quadratic, logistic MAP, Rosenbrock,
and a large-n run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import (
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)
from quasinewtonmethods_jl_tpu.ops.lbfgs import lbfgs_direction, lbfgs_push


def dense_h_from_history(S, Y, rho, hist, gamma, n):
    """Explicit H from the product form, for oracle comparison."""
    H = gamma * np.eye(n)
    for i in range(hist):
        s = np.asarray(S[i])
        y = np.asarray(Y[i])
        r = float(rho[i])
        V = np.eye(n) - r * np.outer(s, y)
        H = V @ H @ V.T + r * np.outer(s, s)
    return H


def test_two_loop_matches_dense_product_form(rng):
    n, m = 10, 5
    S = jnp.zeros((m, n))
    Y = jnp.zeros((m, n))
    rho = jnp.zeros((m,))
    hist = jnp.zeros((), jnp.int32)
    gamma = jnp.ones(())

    # push 3 positive-curvature pairs
    for _ in range(3):
        s = jnp.asarray(rng.standard_normal(n) * 0.1)
        y = s + 0.01 * jnp.asarray(rng.standard_normal(n))
        S, Y, rho, hist, gamma = lbfgs_push(S, Y, rho, hist, gamma, s, y)
    assert int(hist) == 3

    g = jnp.asarray(rng.standard_normal(n))
    d, m_dir = lbfgs_direction(S, Y, rho, hist, gamma, g)
    H = dense_h_from_history(S, Y, rho, int(hist), float(gamma), n)
    np.testing.assert_allclose(np.asarray(d), H @ np.asarray(g), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(m_dir), float(np.asarray(g) @ H @ np.asarray(g)), rtol=1e-9)
    assert float(m_dir) > 0


def test_ring_overwrites_oldest(rng):
    n, m = 6, 3
    S = jnp.zeros((m, n)); Y = jnp.zeros((m, n)); rho = jnp.zeros((m,))
    hist = jnp.zeros((), jnp.int32); gamma = jnp.ones(())
    pairs = []
    for _ in range(5):
        s = jnp.asarray(rng.standard_normal(n) * 0.1)
        y = s + 0.01 * jnp.asarray(rng.standard_normal(n))
        pairs.append((s, y))
        S, Y, rho, hist, gamma = lbfgs_push(S, Y, rho, hist, gamma, s, y)
    assert int(hist) == m
    # ring must hold the 3 newest pairs, oldest..newest
    for slot, (s, y) in enumerate(pairs[-m:]):
        np.testing.assert_array_equal(np.asarray(S[slot]), np.asarray(s))
        np.testing.assert_array_equal(np.asarray(Y[slot]), np.asarray(y))


def test_negative_curvature_pair_rejected(rng):
    n, m = 5, 3
    S = jnp.zeros((m, n)); Y = jnp.zeros((m, n)); rho = jnp.zeros((m,))
    hist = jnp.zeros((), jnp.int32); gamma = jnp.ones(())
    s = jnp.asarray(rng.standard_normal(n))
    S2, Y2, rho2, hist2, gamma2 = lbfgs_push(S, Y, rho, hist, gamma, s, -s)
    assert int(hist2) == 0
    np.testing.assert_array_equal(np.asarray(S2), np.asarray(S))
    assert float(gamma2) == 1.0


def test_empty_history_is_scaled_steepest_ascent(rng):
    n, m = 7, 4
    g = jnp.asarray(rng.standard_normal(n))
    d, m_dir = lbfgs_direction(
        jnp.zeros((m, n)), jnp.zeros((m, n)), jnp.zeros((m,)),
        jnp.zeros((), jnp.int32), jnp.ones(()), g,
    )
    np.testing.assert_allclose(np.asarray(d), np.asarray(g), rtol=1e-15)
    assert float(m_dir) == pytest.approx(float(jnp.dot(g, g)))


@pytest.mark.parametrize("n", [8, 24, 61])
def test_lbfgs_rosenbrock(n, rng):
    x0 = jnp.asarray(rng.standard_normal(n))
    res = qnm.optimize_lbfgs(rosenbrock_logdensity, x0, history=10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8


def test_lbfgs_ill_conditioned_quadratic(rng):
    model = IllConditionedQuadratic(256, condition=1e4)
    x0 = jnp.asarray(rng.standard_normal(256))
    res = qnm.optimize_lbfgs(model, x0, history=10, max_iterations=5000)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8
    # |x - x*| bounded by grad_tol / lambda_min = 1e-8 / 1e-4
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(model.x_star), atol=2e-4)


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
def test_lbfgs_logistic_map(direction, rng):
    from quasinewtonmethods_jl_tpu.utils import practically_converged

    model = LogisticRegressionMAP(dimension=100, n_obs=400)
    x0 = jnp.zeros(100)
    # With |f*| ~ 233 in f64, tol=1e-8 sits at the certification floor:
    # depending on rounding a run may stall in-band a hair above it (the
    # stall detector exits within ~50 extra iterations instead of crawling
    # to the cap). Accept by the standard near-tolerance rule.
    res = qnm.optimize_lbfgs(model, x0, history=10, direction_method=direction)
    assert practically_converged(res, tol=1e-8)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-7
    assert int(res.iterations) < 200  # crawl protection
    # BFGS and L-BFGS must find the same mode
    res_bfgs = qnm.optimize(model, x0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_bfgs.x), atol=1e-6)


def test_lbfgs_large_n(rng):
    """Config-5 shape (scaled down for CI): high-dimensional quadratic."""
    n = 4096
    diag = jnp.asarray(np.linspace(0.5, 3.0, n))

    def f(x):
        return -0.5 * jnp.sum(diag * x * x)

    x0 = jnp.asarray(rng.standard_normal(n))
    res = qnm.optimize_lbfgs(f, x0, history=10, max_iterations=500)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-7)


def test_lbfgs_resume(rng):
    x0 = jnp.asarray(rng.standard_normal(12))
    part = qnm.optimize_lbfgs(rosenbrock_logdensity, x0, max_iterations=5)
    assert int(part.status) == qnm.Status.MAX_ITERATIONS
    res = qnm.optimize_lbfgs_from_state(rosenbrock_logdensity, part.state)
    assert bool(res.converged)


def test_lbfgs_failure_paths():
    # x0 = 0 so no trial step is ever absorbed bitwise (x + a*1 != x for any
    # a > 0), making line-search failure deterministic: every trial is NaN.
    def cliff(x):
        at_start = jnp.all(x == 0.0)
        return jnp.where(at_start, jnp.sum(x) + 1.0, jnp.nan)

    res = qnm.optimize_lbfgs(cliff, jnp.zeros(3), ls=qnm.BackTracking(iterations=20))
    assert int(res.status) == qnm.Status.LINESEARCH_FAILURE
    assert np.isnan(float(res.fun))

    res2 = qnm.optimize_lbfgs(rosenbrock_logdensity, jnp.full(6, -1.5), max_iterations=2)
    assert int(res2.status) == qnm.Status.MAX_ITERATIONS


def test_lbfgs_batched_fleet(rng):
    import quasinewtonmethods_jl_tpu.parallel as par

    X0 = jnp.asarray(rng.standard_normal((32, 48)))
    res = par.optimize_lbfgs_batched(rosenbrock_logdensity, X0, history=10)
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-5)
    # lane 5 must match a scalar solve to quality tolerance
    single = qnm.optimize_lbfgs(rosenbrock_logdensity, X0[5], history=10)
    np.testing.assert_allclose(
        np.asarray(res.x[5]), np.asarray(single.x), atol=1e-6
    )


def test_lbfgs_batched_rejects_bad_shape():
    import quasinewtonmethods_jl_tpu.parallel as par

    with pytest.raises(ValueError):
        par.optimize_lbfgs_batched(rosenbrock_logdensity, jnp.zeros(8))


def test_compact_direction_matches_two_loop(rng):
    """BNS compact form must equal the two-loop recursion to machine
    precision across fill levels (incl. ring wraparound)."""
    from quasinewtonmethods_jl_tpu.ops.lbfgs_compact import lbfgs_direction_compact

    n, m = 11, 4
    S = jnp.zeros((m, n)); Y = jnp.zeros((m, n)); rho = jnp.zeros((m,))
    hist = jnp.zeros((), jnp.int32); gamma = jnp.ones(())
    for _ in range(7):
        g = jnp.asarray(rng.standard_normal(n))
        d1, m1 = lbfgs_direction(S, Y, rho, hist, gamma, g)
        d2, m2 = lbfgs_direction_compact(S, Y, rho, hist, gamma, g)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-12)
        np.testing.assert_allclose(float(m1), float(m2), rtol=1e-12)
        s = jnp.asarray(rng.standard_normal(n) * 0.1)
        y = s * rng.uniform(0.5, 2.0) + 0.01 * jnp.asarray(rng.standard_normal(n))
        S, Y, rho, hist, gamma = lbfgs_push(S, Y, rho, hist, gamma, s, y)


def test_circular_direction_matches_shift_direction(rng):
    """Unit A/B of the two ring layouts' compact directions: for every
    (hist, head) configuration — partial window, full ring, wrapped head,
    empty history — the circular form (raw-ring contractions + one-hot
    rotation of the smalls, stale slots holding garbage) must reproduce
    the canonical shift form to fp roundoff."""
    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        _batched_compact_direction,
        _batched_compact_direction_shift,
    )

    m, n, batch = 4, 8, 3
    for hist_val, head_val in [(2, 2), (4, 0), (4, 2), (3, 1), (0, 0)]:
        S_can = np.zeros((m, n, batch))
        Y_can = np.zeros((m, n, batch))
        S_circ = rng.standard_normal((m, n, batch))  # stale garbage
        Y_circ = rng.standard_normal((m, n, batch))
        for t in range(hist_val):
            s_ = rng.standard_normal((n, batch))
            y_ = rng.standard_normal((n, batch))
            y_ += s_ * (
                np.abs((s_ * y_).sum(0)) / (s_ * s_).sum(0) + 1.0
            )  # sty > 0
            S_can[t], Y_can[t] = s_, y_
            p = (t + head_val - hist_val) % m
            S_circ[p], Y_circ[p] = s_, y_
        g = jnp.asarray(rng.standard_normal((n, batch)))
        gamma = jnp.asarray(np.abs(rng.standard_normal(batch)) + 0.5)
        hist = jnp.full((batch,), hist_val, jnp.int32)
        head = jnp.full((batch,), head_val, jnp.int32)
        d_s, m_s = _batched_compact_direction_shift(
            jnp.asarray(S_can), jnp.asarray(Y_can), hist, gamma, g
        )
        d_c, m_c = _batched_compact_direction(
            jnp.asarray(S_circ), jnp.asarray(Y_circ), hist, head, gamma, g
        )
        np.testing.assert_allclose(
            np.asarray(d_c), np.asarray(d_s), rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(m_c), np.asarray(m_s), rtol=1e-12, atol=1e-12
        )


def test_incremental_gram_matches_recompute(rng):
    """Unit A/B of the incremental-Gram push (the large-n bandwidth
    optimization): carrying SY/YY in the loop state and writing only the
    pushed row/column must reproduce the full einsum recompute exactly —
    Gram entries to machine eps (each entry is the same dot, computed
    once), directions/slopes to solve-amplified roundoff. Covers partial
    windows, wraparound, and rejected pushes (inactive lanes and sᵀy <= 0
    pairs leave the Grams untouched)."""
    from jax.lax import Precision

    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        _batched_compact_direction,
        _batched_push_circular,
        _batched_push_incr,
        _compact_direction_from_grams,
    )

    HI = Precision.HIGHEST
    m, n, batch = 5, 9, 6
    S = jnp.zeros((m, n, batch))
    Y = jnp.zeros((m, n, batch))
    rho = jnp.zeros((m, batch))
    hist = jnp.zeros((batch,), jnp.int32)
    head = jnp.zeros((batch,), jnp.int32)
    gamma = jnp.ones((batch,))
    SY = jnp.zeros((m, m, batch))
    YY = jnp.zeros((m, m, batch))
    S2, Y2, rho2, hist2, head2, gamma2 = S, Y, rho, hist, head, gamma
    for it in range(2 * m + 3):  # past wraparound twice
        step = jnp.asarray(rng.standard_normal((n, batch)))
        y = jnp.asarray(rng.standard_normal((n, batch)))
        if it % 3 == 2:
            y = -step  # sᵀy < 0 on every lane: cautious-push rejection
        g = jnp.asarray(rng.standard_normal((n, batch)))
        active = jnp.asarray(rng.random(batch) > 0.25)
        (S, Y, rho, hist, head, gamma, SY, YY, Sg, Yg) = _batched_push_incr(
            S, Y, rho, hist, head, gamma, SY, YY, step, y, g, active, HI
        )
        d_i, m_i = _compact_direction_from_grams(
            SY, YY, Sg, Yg, S, Y, hist, head, gamma, g, HI
        )
        S2, Y2, rho2, hist2, head2, gamma2 = _batched_push_circular(
            S2, Y2, rho2, hist2, head2, gamma2, step, y, active
        )
        d_r, m_r = _batched_compact_direction(
            S2, Y2, hist2, head2, gamma2, g, HI
        )
        np.testing.assert_array_equal(np.asarray(hist), np.asarray(hist2))
        np.testing.assert_array_equal(np.asarray(head), np.asarray(head2))
        np.testing.assert_allclose(np.asarray(S), np.asarray(S2))
        SY_r = jnp.einsum("inb,jnb->ijb", S2, Y2, precision=HI)
        YY_r = jnp.einsum("inb,jnb->ijb", Y2, Y2, precision=HI)
        np.testing.assert_allclose(
            np.asarray(SY), np.asarray(SY_r), atol=1e-13
        )
        np.testing.assert_allclose(
            np.asarray(YY), np.asarray(YY_r), atol=1e-13
        )
        np.testing.assert_allclose(
            np.asarray(d_i), np.asarray(d_r), rtol=1e-9, atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(m_i), np.asarray(m_r), rtol=1e-9, atol=1e-9
        )


@pytest.mark.parametrize("n", [16, 256])  # shift ring / circular ring
def test_lbfgs_unroll_is_trajectory_identical(n, rng):
    """unroll > 1 chains k masked bodies per while step to amortize the
    per-step control cost; since every carry write is active-masked
    and the cap folds into was_active, it must be trajectory-identical —
    same statuses, same per-lane iteration counts, same optima — for both
    ring implementations, including a cap that is NOT a multiple of the
    unroll factor."""
    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        optimize_lbfgs_batched_fused,
    )

    X0 = jnp.asarray(rng.standard_normal((6, n)))
    kw = dict(history=5, tol=1e-6, max_iterations=50)
    base = optimize_lbfgs_batched_fused(rosenbrock_logdensity, X0, **kw)
    unr = optimize_lbfgs_batched_fused(
        rosenbrock_logdensity, X0, unroll=3, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(unr.status), np.asarray(base.status)
    )
    np.testing.assert_array_equal(
        np.asarray(unr.iterations), np.asarray(base.iterations)
    )
    np.testing.assert_array_equal(np.asarray(unr.n_fev), np.asarray(base.n_fev))
    np.testing.assert_allclose(
        np.asarray(unr.x), np.asarray(base.x), rtol=1e-9, atol=1e-9
    )


def test_incremental_gram_engine_matches_default(rng):
    """Whole-solve A/B of the incremental_gram static kwarg: the
    carried-Gram engine must converge the same lanes in ~the same
    iterations as the recompute engine (trajectories round differently —
    the Grams come from differently-shaped contractions — so
    statuses/optima are compared, not bits)."""
    import quasinewtonmethods_jl_tpu.lbfgs_batched_solve as lbs

    n = 256
    X0 = jnp.asarray(rng.standard_normal((4, n)))
    base = lbs.optimize_lbfgs_batched_fused(
        rosenbrock_logdensity, X0, history=5, tol=1e-6
    )
    incr = lbs.optimize_lbfgs_batched_fused(
        rosenbrock_logdensity, X0, history=5, tol=1e-6,
        incremental_gram=True,
    )
    np.testing.assert_array_equal(
        np.asarray(incr.status), np.asarray(base.status)
    )
    assert np.all(np.asarray(incr.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(incr.x), 1.0, atol=1e-5)


def test_fused_circular_ring_equals_shift_engine(rng, monkeypatch):
    """Whole-solve invariant of the round-2 ring refactor: the circular
    engine (selected for n >= 192) must be bit-for-bit equal in statuses
    and iteration counts to the shift engine, including ring wraparound
    (history=3, hundreds of iterations) — and converge. (The fused engines
    are NOT iteration-identical to the scalar driver at this scale: its
    differently-ordered contractions round differently and trajectories
    drift over ~200 chaotic Rosenbrock iterations; both reach the optimum.)
    """
    import quasinewtonmethods_jl_tpu.lbfgs_batched_solve as lbs

    n = 256
    assert n >= lbs._RING_CIRCULAR_MIN_N
    X0 = jnp.asarray(rng.standard_normal((4, n)))
    circ = lbs.optimize_lbfgs_batched_fused(
        rosenbrock_logdensity, X0, history=3, tol=1e-6
    )
    monkeypatch.setattr(lbs, "_RING_CIRCULAR_MIN_N", 10**9)
    lbs._optimize_lbfgs_batched_fused_jit._clear_cache()
    shift = lbs.optimize_lbfgs_batched_fused(
        rosenbrock_logdensity, X0, history=3, tol=1e-6
    )
    lbs._optimize_lbfgs_batched_fused_jit._clear_cache()
    np.testing.assert_array_equal(
        np.asarray(circ.status), np.asarray(shift.status)
    )
    np.testing.assert_array_equal(
        np.asarray(circ.iterations), np.asarray(shift.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(circ.x), np.asarray(shift.x), rtol=1e-10, atol=1e-10
    )
    assert np.all(np.asarray(circ.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(circ.x), 1.0, atol=1e-5)
    # exported state is in the canonical time order: resuming the scalar
    # engine from a fused lane's state must work
    lane_state = jax.tree_util.tree_map(lambda a: a[0], circ.state)
    res = qnm.optimize_lbfgs_from_state(
        rosenbrock_logdensity, lane_state, tol=1e-9
    )
    assert int(res.status) == qnm.Status.CONVERGED


@pytest.mark.parametrize("n", [16, 200])  # shift ring / circular ring
def test_lbfgs_batched_resume_from_state(n, rng):
    """Stop an L-BFGS fleet early, checkpoint the batched state (rings
    included), resume to convergence — the L-BFGS analog of
    optimize_batched_fused_from_state, over BOTH ring implementations
    (the engine dispatches on n at _RING_CIRCULAR_MIN_N = 192)."""
    import os
    import tempfile

    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        optimize_lbfgs_batched_fused,
        optimize_lbfgs_batched_fused_from_state,
    )
    from quasinewtonmethods_jl_tpu.utils import load_state, save_state

    def quad(x):
        diag = jnp.linspace(1.0, 4.0, x.shape[0]).astype(x.dtype)
        return -0.5 * jnp.sum(diag * x * x)

    X0 = jnp.asarray(rng.standard_normal((6, n)))
    part = optimize_lbfgs_batched_fused(quad, X0, history=5, max_iterations=4)
    assert np.all(np.asarray(part.status) == qnm.Status.MAX_ITERATIONS)
    assert int(jnp.max(part.state.hist)) > 0  # rings genuinely populated
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "fleet.npz")
        save_state(p, part.state)
        restored = load_state(p, qnm.LBFGSState)
    res = optimize_lbfgs_batched_fused_from_state(quad, restored)
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-7)
    # counters continue across the legs
    assert np.all(np.asarray(res.iterations) > 4)

    # chunked resume must match one long solve (same problem is stable
    # enough that reassociation drift stays at rounding level)
    full = optimize_lbfgs_batched_fused(quad, X0, history=5)
    np.testing.assert_array_equal(
        np.asarray(res.iterations), np.asarray(full.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(full.x), atol=1e-10
    )


def test_lbfgs_batched_resume_never_stepped_lane(rng):
    """A saved state whose lanes never stepped (step = 0, empty ring) must
    resume cleanly: the cautious push skips the degenerate pair and the
    empty-ring direction is steepest/H0."""
    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        optimize_lbfgs_batched_fused,
        optimize_lbfgs_batched_fused_from_state,
    )

    def quad(x):
        return -0.5 * jnp.sum(x * x)

    X0 = jnp.asarray(rng.standard_normal((4, 12)))
    part = optimize_lbfgs_batched_fused(quad, X0, history=4, max_iterations=0)
    assert np.all(np.asarray(part.state.k) == 0)
    res = optimize_lbfgs_batched_fused_from_state(quad, part.state)
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-8)


def test_lbfgs_batched_resume_rejects_scalar_state(rng):
    from quasinewtonmethods_jl_tpu.lbfgs_batched_solve import (
        optimize_lbfgs_batched_fused_from_state,
    )

    def quad(x):
        return -0.5 * jnp.sum(x * x)

    res = qnm.optimize_lbfgs(quad, jnp.asarray(rng.standard_normal(6)))
    with pytest.raises(ValueError, match="batched"):
        optimize_lbfgs_batched_fused_from_state(quad, res.state)


def test_lbfgs_diag_inv_hessian_matches_dense(rng):
    """diag(H) from the compact form must equal the diagonal of the dense
    product-form H, including partial windows and masked stale slots."""
    from quasinewtonmethods_jl_tpu.ops.lbfgs_compact import (
        lbfgs_diag_inv_hessian,
    )

    n, m = 9, 5
    S = jnp.zeros((m, n)); Y = jnp.zeros((m, n)); rho = jnp.zeros((m,))
    hist = jnp.zeros((), jnp.int32); gamma = jnp.ones(())
    for k in range(4):
        s = jnp.asarray(rng.standard_normal(n) * 0.1)
        y = s * rng.uniform(0.5, 2.0) + 0.01 * jnp.asarray(
            rng.standard_normal(n)
        )
        S, Y, rho, hist, gamma = lbfgs_push(S, Y, rho, hist, gamma, s, y)
        H = dense_h_from_history(S, Y, rho, int(hist), float(gamma), n)
        d = lbfgs_diag_inv_hessian(S, Y, hist, gamma)
        np.testing.assert_allclose(
            np.asarray(d), np.diagonal(H), rtol=1e-9, atol=1e-12
        )
    # stale-slot masking: poison the slots above hist, answer must not move
    S_bad = S.at[int(hist):].set(99.0)
    Y_bad = Y.at[int(hist):].set(-99.0)
    d2 = lbfgs_diag_inv_hessian(S_bad, Y_bad, hist, gamma)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d), rtol=1e-12)


def test_chain_init_from_lbfgs_fleet(rng):
    """The large-n MAP->sampler handoff: an L-BFGS fleet's compact-form
    diag(H) approximates the posterior's diagonal covariance and feeds
    the samplers as a diagonal mass — no n×n matrix anywhere."""
    scales = jnp.asarray(np.geomspace(0.5, 8.0, 24))

    def logdensity(x):
        return -0.5 * jnp.sum(x * x / scales)

    X0 = jnp.asarray(rng.standard_normal((16, 24)) * 2.0)
    fleet = qnm.optimize_lbfgs_batched(logdensity, X0, history=10,
                                       tol=1e-8)
    assert np.all(np.asarray(fleet.status) == qnm.Status.CONVERGED)
    x0s, mass = qnm.chain_init_from_map(fleet)
    assert mass.ndim == 1 and mass.shape == (24,)
    # secant-subspace estimate: right to within a factor ~4 per dim
    ratio = np.asarray(mass) / np.asarray(scales)
    assert np.all(ratio > 0.25) and np.all(ratio < 4.0), ratio
    # and it is a valid sampler mass
    res = qnm.hmc_sample(logdensity, jax.random.PRNGKey(0), x0s,
                         mass=mass, n_samples=300, n_warmup=150,
                         n_leapfrog=8)
    draws = np.asarray(res.samples).reshape(-1, 24)
    np.testing.assert_allclose(draws.var(axis=0), np.asarray(scales),
                               rtol=0.5)
