"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The standard JAX way to test shard_map/collectives without accelerators
(SURVEY.md §4): conftest forces 8 host devices. These pin the two
parallelism strategies: DP solve fleets and psum-sharded L-BFGS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu.parallel import (
    make_mesh,
    optimize_batched_sharded,
    optimize_lbfgs_sharded,
)


def quad_logdensity(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


def test_eight_virtual_devices_present():
    assert len(jax.devices()) >= 8


def test_make_mesh_validation():
    mesh = make_mesh({"data": 4, "model": 2})
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_mesh({"data": 1024})


def test_batched_sharded_matches_unsharded(rng):
    n, batch = 6, 32
    X0 = jnp.asarray(rng.standard_normal((batch, n)))
    mesh = make_mesh({"data": 8})
    res_sh = optimize_batched_sharded(
        rosenbrock_logdensity, X0, mesh
    )
    res_un = qnm.optimize_batched(rosenbrock_logdensity, X0, backend="fused")
    assert np.all(np.asarray(res_sh.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res_sh.x), np.asarray(res_un.x), atol=1e-9)
    np.testing.assert_array_equal(
        np.asarray(res_sh.iterations), np.asarray(res_un.iterations)
    )


def test_batched_sharded_rejects_uneven_batch(rng):
    mesh = make_mesh({"data": 8})
    with pytest.raises(ValueError):
        optimize_batched_sharded(
            rosenbrock_logdensity, jnp.zeros((12, 4)), mesh
        )


def test_lbfgs_sharded_matches_unsharded_quadratic(rng):
    n = 64
    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 8})
    res_sh = optimize_lbfgs_sharded(quad_logdensity, x0, mesh, history=10)
    res_un = qnm.optimize_lbfgs(quad_logdensity, x0, history=10)
    assert int(res_sh.status) == qnm.Status.CONVERGED
    # psum-of-local-dots reassociates fp summation, so trajectories drift at
    # rounding level; both engines must land on the same optimum to the
    # quality bar, not bit-identically.
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_un.x), atol=1e-7
    )
    np.testing.assert_allclose(float(res_sh.fun), float(res_un.fun), atol=1e-12)
    assert float(jnp.max(jnp.abs(res_sh.grad))) < 1e-8


def test_lbfgs_sharded_rosenbrock(rng):
    """Non-separable objective through the all_gather path."""
    n = 16
    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 4})
    res = optimize_lbfgs_sharded(rosenbrock_logdensity, x0, mesh)
    assert int(res.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-6)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8


def test_lbfgs_sharded_separable_vag(rng):
    """Separable objective via a shard-local value_and_grad_fn with an
    internal psum — no all_gather of x anywhere."""
    from jax import lax

    n = 32
    diag_full = np.linspace(0.5, 2.0, n)

    def local_vag(x_local):
        # each device sees its (n/k,) shard and the matching diag shard
        idx = lax.axis_index("model")
        k = lax.axis_size("model")
        loc = n // k
        diag = lax.dynamic_slice_in_dim(jnp.asarray(diag_full), idx * loc, loc)
        val = lax.psum(-0.5 * jnp.sum(diag * x_local * x_local), "model")
        grad_local = -diag * x_local
        return val, grad_local

    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 8})
    res = optimize_lbfgs_sharded(
        None, x0, mesh, value_and_grad_fn=local_vag
    )
    assert int(res.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-7)


def test_lbfgs_sharded_rejects_uneven_n(rng):
    mesh = make_mesh({"model": 8})
    with pytest.raises(ValueError):
        optimize_lbfgs_sharded(quad_logdensity, jnp.zeros(10), mesh)


def test_distributed_helpers_single_host():
    """Single-host: initialize() must be a clean no-op and report sane
    process topology."""
    from quasinewtonmethods_jl_tpu.parallel import distributed as dist

    dist.initialize()  # no cluster env -> no-op, must not raise
    assert dist.host_count() == 1
    assert dist.process_index() == 0
    assert not dist.is_distributed()


def test_lbfgs_sharded_wolfe_slope_psum(rng):
    """Regression (round-1 advisor, medium): the Wolfe trial slope gradᵀd
    must be the injected psum dot under shard_map — a local jnp.dot gives
    each device a different partial directional derivative, the Wolfe
    while-loop trip counts diverge across devices, and the collectives
    deadlock. Must match the unsharded Wolfe solve exactly."""
    n = 16
    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 4})
    res_sh = optimize_lbfgs_sharded(
        quad_logdensity, x0, mesh, ls=qnm.Wolfe(), tol=1e-8
    )
    res_un = qnm.optimize_lbfgs(
        quad_logdensity, x0, ls=qnm.Wolfe(), tol=1e-8,
        direction_method="two_loop",
    )
    assert int(res_sh.status) == qnm.Status.CONVERGED
    # cubic proposals consume slope VALUES, so the psum'd partial dots can
    # round a proposal differently than the unsharded dot — trajectories
    # match to fp noise, not bit-exactly
    assert abs(int(res_sh.iterations) - int(res_un.iterations)) <= 2
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_un.x), atol=1e-6
    )


def test_sample_sharded_hmc_matches_unsharded(rng):
    """Chains sharded over the mesh with sampler='hmc' must match the
    unsharded run to fp roundoff: every chain is independent (per-chain
    adaptation, diag mass), so GSPMD partitioning introduces no
    cross-device reductions — only re-fused per-chain arithmetic
    (measured drift ~1e-8 over 60 MH rounds)."""
    from quasinewtonmethods_jl_tpu.parallel import sample_sharded

    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    chains, n = 16, 3
    x0s = jnp.asarray(rng.standard_normal((chains, n)))
    mesh = make_mesh({"data": 8})
    kw = dict(n_samples=40, n_warmup=20, n_leapfrog=4)
    sh = sample_sharded(
        logdensity, jax.random.PRNGKey(0), x0s, mesh, sampler="hmc", **kw
    )
    un = qnm.hmc_sample(logdensity, jax.random.PRNGKey(0), x0s, **kw)
    np.testing.assert_allclose(
        np.asarray(sh.samples), np.asarray(un.samples), atol=1e-6
    )


def test_sample_sharded_chees_fleet_adaptation(rng):
    """ChEES over the mesh: the fleet adaptation's across-chain reductions
    lower to all-reduces. Cross-chain fp reduction order may differ from
    the unsharded program (and MH accepts amplify any difference), so the
    invariant checked is statistical: correct moments, clean R-hat, and a
    sensible adapted state."""
    from quasinewtonmethods_jl_tpu.parallel import sample_sharded

    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    chains, n = 32, 2
    mesh = make_mesh({"data": 8})
    res = sample_sharded(
        logdensity, jax.random.PRNGKey(1), jnp.zeros((chains, n)), mesh,
        sampler="chees", n_samples=400, n_warmup=300,
    )
    draws = np.asarray(res.samples).reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.12)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.2)
    assert float(res.step_size) > 0.0
    d = qnm.diagnose_chains(res.samples)
    assert np.all(d.rhat < 1.1)


def test_sample_sharded_nuts(rng):
    """NUTS chains over the mesh: tree loops' early-exit any-reduces
    become cross-device all-reduces; the partitioned program must run and
    sample correctly."""
    from quasinewtonmethods_jl_tpu.parallel import sample_sharded

    mesh = make_mesh({"data": 8})
    res = sample_sharded(
        lambda x: -0.5 * jnp.sum(x * x), jax.random.PRNGKey(2),
        jnp.zeros((16, 2)), mesh, sampler="nuts",
        n_samples=300, n_warmup=200, max_depth=5,
    )
    draws = np.asarray(res.samples).reshape(-1, 2)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.25)


def test_sample_sharded_validation(rng):
    from quasinewtonmethods_jl_tpu.parallel import sample_sharded

    mesh = make_mesh({"data": 8})
    with pytest.raises(ValueError, match="sampler"):
        sample_sharded(lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0),
                       jnp.zeros((16, 2)), mesh, sampler="slice")
    with pytest.raises(ValueError, match="divide"):
        sample_sharded(lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0),
                       jnp.zeros((12, 2)), mesh)


def _lm_fixture(rng, batch=32, m=24):
    ts = np.tile(np.linspace(0.0, 1.0, m), (batch, 1))
    true = np.stack(
        [rng.uniform(0.5, 2.0, batch), rng.uniform(-2.0, -0.5, batch)], axis=1
    )
    ys = true[:, :1] * np.exp(true[:, 1:] * ts)

    def resid(p, d):
        t, y = d
        return p[..., 0:1] * jnp.exp(p[..., 1:2] * t) - y

    x0 = jnp.tile(jnp.asarray([1.0, 0.0]), (batch, 1))
    return resid, x0, (jnp.asarray(ts), jnp.asarray(ys)), true


def test_least_squares_sharded_matches_unsharded(rng):
    from quasinewtonmethods_jl_tpu.parallel import least_squares_sharded

    resid, x0, data, true = _lm_fixture(rng)
    mesh = make_mesh({"data": 8})
    r_sh = least_squares_sharded(resid, x0, mesh, data=data)
    r_un = qnm.least_squares(resid, x0, data=data)
    assert np.all(np.asarray(r_sh.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x), atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(r_sh.iterations), np.asarray(r_un.iterations)
    )
    np.testing.assert_allclose(np.asarray(r_sh.x), true, atol=1e-6)
    # lanes actually placed across all 8 devices
    assert len({d for d in r_sh.x.devices()}) == 8


def test_least_squares_sharded_bounds_and_loss(rng):
    from quasinewtonmethods_jl_tpu.parallel import least_squares_sharded

    resid, x0, data, true = _lm_fixture(rng)
    mesh = make_mesh({"data": 8})
    lo = jnp.asarray([0.0, -1.0])  # broadcastable box -> replicated
    hi = jnp.asarray([5.0, 5.0])
    # tol 1e-7: bounded solutions have f* > 0, so the certificate floor
    # is ~sqrt(eps*f*) (documented in the least_squares docstring)
    r_sh = least_squares_sharded(
        resid, x0, mesh, data=data, bounds=(lo, hi), loss="soft_l1",
        f_scale=0.5, tol=1e-7,
    )
    r_un = qnm.least_squares(
        resid, x0, data=data, bounds=(lo, hi), loss="soft_l1", f_scale=0.5,
        tol=1e-7,
    )
    assert np.all(np.asarray(r_sh.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x), atol=1e-12)
    # the rate bound at -1 binds for every lane whose true rate < -1
    binds = true[:, 1] < -1.0
    np.testing.assert_allclose(np.asarray(r_sh.x)[binds, 1], -1.0, atol=1e-12)


def test_least_squares_sharded_validation(rng):
    from quasinewtonmethods_jl_tpu.parallel import least_squares_sharded

    mesh = make_mesh({"data": 8})
    with pytest.raises(ValueError, match="divide"):
        least_squares_sharded(
            lambda p, d: p, jnp.zeros((12, 2)), mesh, data=jnp.zeros((12, 3))
        )
    with pytest.raises(ValueError, match="batch"):
        least_squares_sharded(lambda p, d: p, jnp.zeros(4), mesh)


def test_optimize_tr_sharded_matches_unsharded(rng):
    from quasinewtonmethods_jl_tpu.parallel import optimize_tr_sharded

    X0 = jnp.asarray(rng.standard_normal((16, 6)))
    mesh = make_mesh({"data": 8})
    r_sh = optimize_tr_sharded(rosenbrock_logdensity, X0, mesh)
    r_un = qnm.optimize_tr(rosenbrock_logdensity, X0)
    assert np.all(np.asarray(r_sh.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x),
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(r_sh.iterations),
                                  np.asarray(r_un.iterations))
    np.testing.assert_array_equal(np.asarray(r_sh.n_hev),
                                  np.asarray(r_un.n_hev))
    assert len({d for d in r_sh.x.devices()}) == 8
    with pytest.raises(ValueError, match="divide"):
        optimize_tr_sharded(rosenbrock_logdensity, jnp.zeros((12, 4)), mesh)


def test_optimize_tr_sharded_preconditioned_matches_unsharded(rng):
    # the Hutchinson probe is a replicated (n,) draw broadcast into the
    # lane-sharded fleet and the PCG dots become all-reduces — parity
    # must hold including the HVP count (probes included)
    from quasinewtonmethods_jl_tpu.parallel import optimize_tr_sharded

    n = 8
    d = jnp.asarray(np.geomspace(1.0, 1e3, n))
    obj = lambda x: -0.5 * jnp.sum(d * x * x)
    X0 = jnp.asarray(rng.standard_normal((16, n)))
    mesh = make_mesh({"data": 8})
    r_sh = optimize_tr_sharded(obj, X0, mesh, precondition="jacobi")
    r_un = qnm.optimize_tr(obj, X0, precondition="jacobi")
    assert np.all(np.asarray(r_sh.status) == qnm.Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x),
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(r_sh.n_hev),
                                  np.asarray(r_un.n_hev))


def test_optimize_tr_model_sharded_matches_unsharded(rng):
    from quasinewtonmethods_jl_tpu.parallel import optimize_tr_model_sharded

    n = 512
    d = jnp.asarray(np.geomspace(1.0, 1e4, n))

    def obj(x):
        return -0.5 * jnp.sum(d * x * x)

    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 8})
    r_sh = optimize_tr_model_sharded(obj, x0, mesh, max_cg=128)
    r_un = qnm.optimize_tr(obj, x0, max_cg=128)
    assert int(r_sh.status) == qnm.Status.CONVERGED
    # partitioned dots reassociate fp reductions, so trajectories drift
    # at rounding level (the lbfgs_sharded bar): same optimum to the
    # quality bar, trip counts within one
    assert abs(int(r_sh.iterations) - int(r_un.iterations)) <= 1
    np.testing.assert_allclose(np.asarray(r_sh.x), 0.0, atol=1e-8)
    assert float(jnp.max(jnp.abs(r_sh.grad))) < 1e-8
    assert len({dd for dd in r_sh.x.devices()}) == 8


def test_optimize_tr_model_sharded_nonseparable(rng):
    # coupled gradient: GSPMD must insert the gathers it needs and still
    # hit the reference bars
    from quasinewtonmethods_jl_tpu.parallel import optimize_tr_model_sharded

    x0 = jnp.asarray(rng.standard_normal(16))
    mesh = make_mesh({"model": 8})
    res = optimize_tr_model_sharded(rosenbrock_logdensity, x0, mesh)
    assert int(res.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)
    assert float(jnp.max(jnp.abs(res.grad))) < 1e-8


def test_optimize_tr_model_sharded_validation(rng):
    from quasinewtonmethods_jl_tpu.parallel import optimize_tr_model_sharded

    mesh = make_mesh({"model": 8})
    with pytest.raises(ValueError, match="rank 1"):
        optimize_tr_model_sharded(quad_logdensity, jnp.zeros((4, 8)), mesh)
    with pytest.raises(ValueError, match="divide"):
        optimize_tr_model_sharded(quad_logdensity, jnp.zeros(10), mesh)


def test_least_squares_residual_axis_sharded_single_fit(rng):
    """The big-data curve fit: ONE lane whose residual axis m is sharded
    over the mesh. The LM program is lane-elementwise AND
    residual-reduction-shaped (JTJ/JTr are contractions over m), so
    GSPMD partitions it from the data placement alone — pinned
    BITWISE-identical to the unsharded fit (same contractions, same
    order, just partitioned)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    M = 2048
    t = np.linspace(0.0, 1.0, M)
    y = 2.0 * np.exp(-1.3 * t) + 0.01 * rng.standard_normal(M)

    def resid(p, d):
        tt, yy = d
        return p[..., 0:1] * jnp.exp(p[..., 1:2] * tt) - yy

    x0 = jnp.asarray([[1.0, 0.0]])
    data = (jnp.asarray(t)[None], jnp.asarray(y)[None])
    mesh = make_mesh({"data": 8})
    data_sh = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(mesh, P(None, "data"))),
        data,
    )
    with mesh:
        r_sh = qnm.least_squares(resid, x0, data=data_sh)
    r_un = qnm.least_squares(resid, x0, data=data)
    assert int(r_sh.status[0]) == qnm.Status.CONVERGED
    np.testing.assert_array_equal(np.asarray(r_sh.x), np.asarray(r_un.x))
    np.testing.assert_array_equal(np.asarray(r_sh.iterations),
                                  np.asarray(r_un.iterations))


def test_svgd_particle_sharded_matches_unsharded(rng):
    """SVGD under GSPMD: particles sharded over the mesh turn the (B, B)
    kernel contractions into collective matmuls — pinned BITWISE
    identical to the unsharded run (pure jnp, placement-only)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    x0 = jnp.asarray(rng.standard_normal((64, 4)))
    mesh = make_mesh({"data": 8})
    x0_sh = jax.device_put(x0, NamedSharding(mesh, P("data", None)))
    with mesh:
        r_sh = qnm.svgd_sample(logdensity, x0_sh, n_steps=100)
    r_un = qnm.svgd_sample(logdensity, x0, n_steps=100)
    np.testing.assert_array_equal(
        np.asarray(r_sh.particles), np.asarray(r_un.particles)
    )
    assert len({d for d in r_sh.particles.devices()}) == 8


def test_optimize_cg_sharded_matches_unsharded(rng):
    from quasinewtonmethods_jl_tpu.parallel import optimize_cg_sharded

    X0 = jnp.asarray(rng.standard_normal((16, 6)))
    mesh = make_mesh({"data": 8})
    r_sh = optimize_cg_sharded(quad_logdensity, X0, mesh, tol=1e-8)
    r_un = qnm.optimize_cg(quad_logdensity, X0, tol=1e-8)
    assert np.all(np.asarray(r_sh.status) == qnm.Status.CONVERGED)
    # lanes are independent and per-lane reductions are shard-local; the
    # only collectives are loop predicates. Parity is last-ulp rather
    # than bitwise: the fold-eval invariant takes (fun, G) from the
    # line-search trial, whose fusion differs under GSPMD partitioning
    # (measured max drift ~1e-18 absolute on this fixture).
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(r_sh.iterations),
                                  np.asarray(r_un.iterations))
    assert len({d for d in r_sh.x.devices()}) == 8
    with pytest.raises(ValueError, match="divide"):
        optimize_cg_sharded(quad_logdensity, jnp.zeros((12, 4)), mesh)


def test_optimize_cg_model_sharded_matches_unsharded(rng):
    """Round-5 (verdict item 7b): ONE very-large-n CG solve sharded over
    the model axis — pure-jnp engine partitions from x0 placement alone.
    Unlike TR (quadratic local convergence, ~10 outer iterations,
    trip counts within 1), CG runs O(√cond) linear-convergence
    iterations and each partitioned β reduction reassociates — measured
    159 vs 150 iterations on this fixture — so the parity bar is
    proportional (within 15%), with the same optimum at the quality
    bar."""
    from quasinewtonmethods_jl_tpu.parallel import optimize_cg_model_sharded

    n = 1024
    d = jnp.asarray(np.geomspace(1.0, 100.0, n))

    def obj(x):
        return -0.5 * jnp.sum(d * x * x)

    x0 = jnp.asarray(rng.standard_normal(n))
    mesh = make_mesh({"model": 8})
    r_sh = optimize_cg_model_sharded(obj, x0, mesh)
    r_un = qnm.optimize_cg(obj, x0)
    assert int(r_sh.status) == qnm.Status.CONVERGED
    assert (
        abs(int(r_sh.iterations) - int(r_un.iterations))
        <= 0.15 * int(r_un.iterations)
    )
    np.testing.assert_allclose(np.asarray(r_sh.x), 0.0, atol=1e-8)
    assert float(jnp.max(jnp.abs(r_sh.grad))) < 1e-8
    assert len({dd for dd in r_sh.x.devices()}) == 8
    # the preconditioned flavor shards too (jacobi probes are (n,)
    # broadcasts — partition like the gradient)
    r_pre = optimize_cg_model_sharded(obj, x0, mesh, precondition="jacobi")
    assert int(r_pre.status) == qnm.Status.CONVERGED
    assert int(r_pre.iterations) < int(r_sh.iterations)


def test_optimize_cg_model_sharded_nonseparable_and_validation(rng):
    from quasinewtonmethods_jl_tpu.parallel import optimize_cg_model_sharded

    x0 = jnp.asarray(rng.standard_normal(16) * 0.5)
    mesh = make_mesh({"model": 8})
    res = optimize_cg_model_sharded(rosenbrock_logdensity, x0, mesh)
    assert int(res.status) == qnm.Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="rank 1"):
        optimize_cg_model_sharded(quad_logdensity, jnp.zeros((4, 8)), mesh)
    with pytest.raises(ValueError, match="divide"):
        optimize_cg_model_sharded(quad_logdensity, jnp.zeros(10), mesh)


def test_optimize_auglag_sharded_per_lane_data(rng):
    """Round-5: the constrained fleet sharded over lanes WITH per-lane
    constraint data (each device owns its lanes' feasible sets) —
    matches the unsharded fleet lane-for-lane."""
    from quasinewtonmethods_jl_tpu.parallel import optimize_auglag_sharded

    n = 4

    def f(z):
        return -jnp.sum((z - 2.0) ** 2)

    def disk(z, r2):
        return r2 - jnp.sum(z * z)

    B = 16
    r2s = jnp.asarray(np.linspace(1.0, 30.0, B))
    X0 = jnp.full((B, n), 0.1)
    mesh = make_mesh({"data": 8})
    r_sh = optimize_auglag_sharded(
        f, X0, mesh, ineq=disk, constraint_data=r2s,
    )
    r_un = qnm.optimize_auglag(f, X0, ineq=disk, constraint_data=r2s)
    assert bool(r_sh.converged.all())
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_un.x),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(r_sh.n_outer),
                                  np.asarray(r_un.n_outer))
    with pytest.raises(ValueError, match="divide"):
        optimize_auglag_sharded(f, jnp.zeros((10, n)), mesh, ineq=disk)
