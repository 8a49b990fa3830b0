"""fold_eval + compaction (throughput options).

fold_eval: trajectories must be unchanged (same trial points, same accepted
alphas, gradient evaluated at the same points) while n_fev drops by ~the
iteration count (the separate top-of-iteration evaluation disappears —
the redundancy the reference also has, src/QuasiNewtonMethods.jl:254
re-evaluating where :283's linesearch! just evaluated).

compaction: `optimize_batched_compacted` must be lane-for-lane identical to
one long `optimize_batched_fused` run (iterates, counters, statuses) — only
wall time may differ. This rests on the resume path CONTINUING a lane's
BFGS trajectory, which is pinned here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity


def test_fold_eval_same_trajectory_fewer_evals(rng):
    X0 = jnp.asarray(rng.standard_normal((24, 8)))
    base = optimize_batched_fused(rosenbrock_logdensity, X0)
    fold = optimize_batched_fused(
        rosenbrock_logdensity, X0, fold_eval=True
    )
    assert np.all(np.asarray(fold.status) == np.asarray(base.status))
    np.testing.assert_array_equal(
        np.asarray(fold.iterations), np.asarray(base.iterations)
    )
    # identical trajectories (same trial points; value_and_grad's forward
    # and differently-fused bodies may round differently, so allclose)
    np.testing.assert_allclose(
        np.asarray(fold.x), np.asarray(base.x), rtol=1e-9, atol=1e-9
    )
    # the separate top-of-iteration evaluation is gone: n_fev drops by
    # exactly the iteration count (the peeled first iteration still pays a
    # fresh eval, and the exit iteration — which `iterations` does not
    # count — no longer pays one)
    nfe_b = np.asarray(base.n_fev)
    nfe_f = np.asarray(fold.n_fev)
    iters = np.asarray(base.iterations)
    np.testing.assert_array_equal(nfe_b - nfe_f, iters)
    # every fold line-search trial pays the gradient too
    assert np.all(np.asarray(fold.n_gev) >= np.asarray(base.n_gev))


def test_fold_eval_wolfe_same_trajectory(rng):
    X0 = jnp.asarray(rng.standard_normal((8, 6)))
    base = optimize_batched_fused(
        rosenbrock_logdensity, X0, ls=qnm.Wolfe()
    )
    fold = optimize_batched_fused(
        rosenbrock_logdensity, X0, ls=qnm.Wolfe(), fold_eval=True
    )
    assert np.all(np.asarray(fold.status) == np.asarray(base.status))
    np.testing.assert_array_equal(
        np.asarray(fold.iterations), np.asarray(base.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(fold.x), np.asarray(base.x), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(base.n_fev) - np.asarray(fold.n_fev),
        np.asarray(base.iterations),
    )


def test_resume_continues_trajectory(rng):
    """A chunked solve (stop at k, resume) must equal one long solve
    lane-for-lane — the resume path continues the BFGS trajectory instead
    of restarting with steepest ascent."""
    X0 = jnp.asarray(rng.standard_normal((16, 8)))
    long = optimize_batched_fused(rosenbrock_logdensity, X0)
    part = optimize_batched_fused(
        rosenbrock_logdensity, X0, max_iterations=7
    )
    res = optimize_batched_fused_from_state(
        rosenbrock_logdensity, part.state
    )
    np.testing.assert_array_equal(
        np.asarray(res.status), np.asarray(long.status)
    )
    np.testing.assert_array_equal(
        np.asarray(res.iterations), np.asarray(long.iterations)
    )
    np.testing.assert_array_equal(np.asarray(res.n_fev), np.asarray(long.n_fev))
    np.testing.assert_array_equal(
        np.asarray(res.n_resets), np.asarray(long.n_resets)
    )
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(long.x), rtol=0, atol=1e-9
    )


def test_resume_fresh_state_takes_steepest_first_step(rng):
    """Resuming a never-stepped state (k == 0) must behave like a fresh
    solve (per-lane steepest first step), not NaN out via sty = 0."""
    from quasinewtonmethods_jl_tpu.state import init_bfgs_state
    import jax

    X0 = jnp.asarray(rng.standard_normal((6, 5)))
    fresh_state = jax.vmap(init_bfgs_state)(X0)
    res = optimize_batched_fused_from_state(
        rosenbrock_logdensity, fresh_state
    )
    direct = optimize_batched_fused(rosenbrock_logdensity, X0)
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    np.testing.assert_array_equal(
        np.asarray(res.iterations), np.asarray(direct.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(direct.x), rtol=0, atol=1e-9
    )


@pytest.mark.parametrize("fold", [False, True])
def test_compacted_matches_fused(rng, fold):
    X0 = jnp.asarray(rng.standard_normal((64, 8)))
    long = optimize_batched_fused(
        rosenbrock_logdensity, X0, fold_eval=fold
    )
    comp = optimize_batched_compacted(
        rosenbrock_logdensity, X0, fold_eval=fold,
        chunk=9, min_width=8,
    )
    np.testing.assert_array_equal(
        np.asarray(comp.status), np.asarray(long.status)
    )
    if not fold:
        np.testing.assert_array_equal(
            np.asarray(comp.iterations), np.asarray(long.iterations)
        )
        np.testing.assert_array_equal(
            np.asarray(comp.n_fev), np.asarray(long.n_fev)
        )
    else:
        # each resume leg re-evaluates once at its start (the carried pair
        # cannot be trusted across a checkpoint boundary), so a lane pays
        # one extra eval per extra leg it participates in
        extra = np.asarray(comp.n_fev) - np.asarray(long.n_fev)
        legs_ub = np.asarray(long.iterations) // 9 + 1
        assert np.all(extra >= -2) and np.all(extra <= legs_ub + 2)
        # a leg boundary re-evaluates fresh, so a borderline convergence
        # test can flip by an ulp and shift a lane by an iteration or two
        it_diff = np.abs(
            np.asarray(comp.iterations) - np.asarray(long.iterations)
        )
        assert np.all(it_diff <= 2)
    np.testing.assert_allclose(
        np.asarray(comp.x), np.asarray(long.x), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(comp.fun), np.asarray(long.fun), rtol=0, atol=1e-9
    )


def test_compacted_respects_max_iterations(rng):
    X0 = jnp.asarray(rng.standard_normal((16, 12)))
    comp = optimize_batched_compacted(
        rosenbrock_logdensity, X0, chunk=5, min_width=8,
        max_iterations=11,
    )
    long = optimize_batched_fused(
        rosenbrock_logdensity, X0, max_iterations=11
    )
    np.testing.assert_array_equal(
        np.asarray(comp.status), np.asarray(long.status)
    )
    np.testing.assert_array_equal(
        np.asarray(comp.iterations), np.asarray(long.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(comp.x), np.asarray(long.x), rtol=0, atol=1e-9
    )


def test_compacted_terminal_failures_not_resumed(rng):
    """LINESEARCH_FAILURE / NONFINITE lanes are terminal: compaction must
    not re-arm them (their counters would keep growing)."""
    def sometimes_bad(x):
        # lanes starting far out hit a -inf cliff and fail in-band
        r = jnp.sum(x * x)
        return jnp.where(r > 1e4, -jnp.inf, -r)

    X0 = jnp.concatenate(
        [jnp.full((4, 4), 200.0), jnp.asarray(rng.standard_normal((12, 4)))]
    )
    comp = optimize_batched_compacted(
        sometimes_bad, X0, chunk=4, min_width=8
    )
    long = optimize_batched_fused(sometimes_bad, X0)
    np.testing.assert_array_equal(
        np.asarray(comp.status), np.asarray(long.status)
    )
    np.testing.assert_array_equal(np.asarray(comp.n_fev), np.asarray(long.n_fev))


