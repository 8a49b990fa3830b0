"""Batched HMC sampler: correctness on known targets + the MAP handoff.

The sampler completes the reference's intended workflow (MAP engine for
HMC chain initialization, reference README.md:14): these tests pin the
invariant distribution on Gaussian targets (moment checks within MC
error), the mass-matrix preconditioning path (dense B from the MAP
fleet), step-size adaptation, and NaN-robust divergence rejection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm


def _corr_gaussian(n):
    """Correlated Gaussian logdensity with known covariance."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((n, n)) * 0.4
    cov = A @ A.T + np.eye(n)
    prec = np.linalg.inv(cov)
    prec_j = jnp.asarray(prec)

    def logdensity(x):
        return -0.5 * x @ (prec_j @ x)

    return logdensity, cov


def test_hmc_standard_normal_moments():
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    n, chains = 4, 32
    key = jax.random.PRNGKey(0)
    x0s = jnp.zeros((chains, n))
    res = qnm.hmc_sample(logdensity, key, x0s, n_samples=800, n_warmup=300,
                        n_leapfrog=8)
    draws = np.asarray(res.samples).reshape(-1, n)  # pooled over chains
    assert draws.shape[0] == 800 * chains
    # MC error with ~25k (correlated) draws: generous but meaningful bars
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    # adaptation worked: acceptance near the 0.8 target on average
    acc = float(np.mean(np.asarray(res.accept_rate)))
    assert 0.6 < acc <= 1.0


def test_hmc_preconditioned_correlated_gaussian():
    """Dense mass = true covariance must sample the correlated target well
    at a modest leapfrog budget (the whole point of preconditioning)."""
    logdensity, cov = _corr_gaussian(3)
    chains = 48
    key = jax.random.PRNGKey(1)
    x0s = jnp.zeros((chains, 3))
    res = qnm.hmc_sample(logdensity, key, x0s, mass=jnp.asarray(cov),
                        n_samples=700, n_warmup=300, n_leapfrog=8)
    draws = np.asarray(res.samples).reshape(-1, 3)
    emp_cov = np.cov(draws.T)
    np.testing.assert_allclose(emp_cov, cov, atol=0.35 * np.abs(cov).max())
    assert float(np.mean(np.asarray(res.accept_rate))) > 0.6


def test_map_to_hmc_handoff():
    """The full intended pipeline: batched MAP solve -> B as mass ->
    batched chains. B at the mode of a Gaussian IS the covariance, so the
    handoff gives an ~ideally preconditioned sampler."""
    logdensity, cov = _corr_gaussian(3)
    rng = np.random.default_rng(2)
    X0 = jnp.asarray(rng.standard_normal((16, 3)) * 3.0)
    fleet = qnm.optimize_batched(logdensity, X0, tol=1e-10)
    assert np.all(np.asarray(fleet.status) == qnm.Status.CONVERGED)

    x0s, mass = qnm.chain_init_from_map(
        fleet, jitter=0.1, key=jax.random.PRNGKey(3)
    )
    # the converged inverse Hessian approximates the covariance
    np.testing.assert_allclose(np.asarray(mass), cov, atol=0.2 * np.abs(cov).max())

    res = qnm.hmc_sample(logdensity, jax.random.PRNGKey(4), x0s, mass=mass,
                        n_samples=600, n_warmup=250, n_leapfrog=8)
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.15)
    emp_cov = np.cov(draws.T)
    np.testing.assert_allclose(emp_cov, cov, atol=0.35 * np.abs(cov).max())


def test_hmc_diag_mass_and_no_warmup():
    def logdensity(x):
        scales = jnp.asarray([1.0, 100.0])  # badly scaled
        return -0.5 * jnp.sum(x * x / scales)

    chains = 32
    res = qnm.hmc_sample(
        logdensity, jax.random.PRNGKey(5), jnp.zeros((chains, 2)),
        mass=jnp.asarray([1.0, 100.0]),  # diagonal covariance
        n_samples=600, n_warmup=0, step_size=0.5, n_leapfrog=8,
    )
    draws = np.asarray(res.samples).reshape(-1, 2)
    v = draws.var(axis=0)
    np.testing.assert_allclose(v[0], 1.0, rtol=0.3)
    np.testing.assert_allclose(v[1], 100.0, rtol=0.3)
    # no warmup: step size is exactly the requested one
    np.testing.assert_allclose(np.asarray(res.step_size), 0.5)


def test_hmc_divergence_is_rejected_not_propagated():
    """A wildly too-large step size produces non-finite trajectories; they
    must be rejected (chain stays finite), not accepted into the samples."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    res = qnm.hmc_sample(
        logdensity, jax.random.PRNGKey(6), jnp.ones((4, 3)),
        n_samples=50, n_warmup=0, step_size=1e6, n_leapfrog=4,
    )
    assert np.all(np.isfinite(np.asarray(res.samples)))
    assert np.all(np.asarray(res.accept_rate) == 0.0)


def test_hmc_reproducible_and_chains_differ():
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    kw = dict(n_samples=50, n_warmup=10, n_leapfrog=4)
    a = qnm.hmc_sample(logdensity, jax.random.PRNGKey(7), jnp.zeros((3, 2)), **kw)
    b = qnm.hmc_sample(logdensity, jax.random.PRNGKey(7), jnp.zeros((3, 2)), **kw)
    np.testing.assert_array_equal(np.asarray(a.samples), np.asarray(b.samples))
    # distinct chains take distinct paths under one key
    assert not np.allclose(
        np.asarray(a.samples[:, 0]), np.asarray(a.samples[:, 1])
    )


def test_hmc_bad_mass_shape():
    with pytest.raises(ValueError, match="mass"):
        qnm.hmc_sample(
            lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0),
            jnp.zeros((2, 3)), mass=jnp.zeros((3, 3, 3)),
            n_samples=2, n_warmup=0,
        )


# ---------------------------------------------------------------------------
# ChEES-HMC (adaptive trajectory length — the lockstep NUTS alternative)
# ---------------------------------------------------------------------------


def test_chees_standard_normal_moments():
    """Invariant-distribution check with full joint adaptation on: the
    adapted sampler must reproduce N(0, I) moments within MC error and
    accept near the 0.75 target."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    n, chains = 4, 64
    res = qnm.chees_sample(
        logdensity, jax.random.PRNGKey(0), jnp.zeros((chains, n)),
        n_samples=600, n_warmup=400,
    )
    draws = np.asarray(res.samples).reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    acc = float(np.mean(np.asarray(res.accept_rate)))
    assert 0.55 < acc <= 0.95
    assert float(res.step_size) > 0.0 and np.isfinite(float(res.step_size))


def test_chees_learns_longer_trajectories_for_wide_targets():
    """The point of ChEES: on a badly scaled Gaussian (widest scale 10) a
    tiny initial trajectory length must GROW during warmup — and the
    widest coordinate's variance must still come out right, which plain
    HMC at the same tiny fixed path length cannot deliver."""
    scales = jnp.asarray([1.0, 25.0, 100.0])  # var 1, 25, 100

    def logdensity(x):
        return -0.5 * jnp.sum(x * x / scales)

    chains = 64
    res = qnm.chees_sample(
        logdensity, jax.random.PRNGKey(1), jnp.zeros((chains, 3)),
        n_samples=800, n_warmup=500, traj_length=0.1, adapt_mass=False,
    )
    assert float(res.traj_length) > 0.5  # grew by > 5x
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(
        draws.var(axis=0), np.asarray(scales), rtol=0.35
    )


def test_chees_fleet_mass_adaptation():
    """With adapt_mass (the default) the across-chain variance EMA must
    recover a badly scaled diagonal to within a factor ~3 and equalize
    sampling quality across scales."""
    scales = jnp.asarray([0.25, 1.0, 64.0])

    def logdensity(x):
        return -0.5 * jnp.sum(x * x / scales)

    chains = 128
    res = qnm.chees_sample(
        logdensity, jax.random.PRNGKey(2), jnp.zeros((chains, 3)),
        n_samples=600, n_warmup=600,
    )
    ratio = np.asarray(res.mass_diag) / np.asarray(scales)
    assert np.all(ratio > 1 / 4) and np.all(ratio < 4.0)
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(
        draws.var(axis=0), np.asarray(scales), rtol=0.4
    )


def test_chees_explicit_mass_and_reproducible():
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    kw = dict(n_samples=40, n_warmup=20, mass=jnp.ones(2))
    a = qnm.chees_sample(logdensity, jax.random.PRNGKey(3),
                         jnp.zeros((4, 2)), **kw)
    b = qnm.chees_sample(logdensity, jax.random.PRNGKey(3),
                         jnp.zeros((4, 2)), **kw)
    np.testing.assert_array_equal(np.asarray(a.samples), np.asarray(b.samples))
    # explicit mass is honored verbatim
    np.testing.assert_array_equal(np.asarray(a.mass_diag), 1.0)


def test_chees_divergence_rejected():
    def logdensity(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    res = qnm.chees_sample(
        logdensity, jax.random.PRNGKey(4), jnp.ones((4, 3)),
        n_samples=30, n_warmup=0, step_size=1e6,
    )
    assert np.all(np.isfinite(np.asarray(res.samples)))
    assert np.all(np.asarray(res.accept_rate) == 0.0)


def test_chees_dense_mass_from_map_handoff():
    """The full handoff into ChEES: dense B ≈ cov as the mass makes the
    correlated target ~isotropic, so short adapted trajectories sample it
    well — and mass_diag reports the diagonal of the dense mass."""
    logdensity, cov = _corr_gaussian(3)
    res = qnm.chees_sample(
        logdensity, jax.random.PRNGKey(9), jnp.zeros((48, 3)),
        mass=jnp.asarray(cov), n_samples=700, n_warmup=300,
    )
    draws = np.asarray(res.samples).reshape(-1, 3)
    emp_cov = np.cov(draws.T)
    np.testing.assert_allclose(emp_cov, cov, atol=0.35 * np.abs(cov).max())
    np.testing.assert_allclose(
        np.asarray(res.mass_diag), np.diagonal(cov), rtol=1e-6
    )
    assert float(np.mean(np.asarray(res.accept_rate))) > 0.5


def test_chees_float32_chains_under_x64():
    """Regression: the Halton jitter sequence is built in f64; without the
    astype cast, f32 chains in an x64-enabled process (this suite's CPU
    parity mode) promoted the warmup carry (t_jit -> g_chees -> log_T/Adam
    moments) and lax.scan raised a carry-dtype mismatch."""
    res = qnm.chees_sample(
        lambda x: -0.5 * jnp.sum(x * x), jax.random.PRNGKey(0),
        jnp.zeros((8, 3), jnp.float32), n_samples=10, n_warmup=10,
    )
    assert res.samples.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(res.samples)))


def test_chees_rejects_bad_mass_shape():
    with pytest.raises(ValueError, match="mass"):
        qnm.chees_sample(
            lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0),
            jnp.zeros((2, 3)), mass=jnp.zeros((3, 3, 3)),
            n_samples=2, n_warmup=0,
        )


def test_chees_on_neals_funnel():
    """The canonical pathological geometry: adapted fleet HMC must explore
    BOTH the wide mouth (v > 2) and the narrow neck (v < -2) of a 6-dim
    funnel and put the v-marginal variance in the right decade (exact:
    var(v) = 9 — systematically underestimated by any fixed-metric HMC,
    so the bar is coverage, not calibration)."""
    from quasinewtonmethods_jl_tpu.models import funnel_logdensity

    chains = 128
    key = jax.random.PRNGKey(0)
    x0s = 0.5 * jax.random.normal(jax.random.fold_in(key, 9), (chains, 6))
    res = qnm.chees_sample(
        funnel_logdensity, key, x0s, n_samples=1500, n_warmup=800,
        target_accept=0.9,
    )
    v = np.asarray(res.samples[:, :, 0]).ravel()
    assert np.isfinite(v).all()
    assert (v > 2.0).mean() > 0.05    # mouth visited
    assert (v < -2.0).mean() > 0.02   # neck visited
    assert 3.0 < v.var() < 15.0       # right decade (exact = 9)


# ---------------------------------------------------------------------------
# NUTS (iterative multinomial formulation, lockstep fleet)
# ---------------------------------------------------------------------------


def test_nuts_standard_normal_moments_and_adaptation():
    """N(0, I): moments within MC error; step size adapts to ~1 (the known
    optimum for the unit Gaussian); trees stop well short of max_depth
    (the U-turn criterion is actually firing)."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    res = qnm.nuts_sample(
        logdensity, jax.random.PRNGKey(0), jnp.zeros((16, 3)),
        n_samples=500, n_warmup=300, max_depth=6,
    )
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    assert 0.6 < float(np.mean(np.asarray(res.accept_prob))) <= 1.0
    assert 0.4 < float(np.mean(np.asarray(res.step_size))) < 2.5
    assert float(np.mean(np.asarray(res.mean_tree_depth))) < 4.0
    d = qnm.diagnose_chains(res.samples)
    assert np.all(d.rhat < 1.05)


def test_nuts_adapts_depth_to_scale_spread():
    """The point of NUTS: a 400x variance spread needs long trajectories
    for the wide coordinate — trees must go DEEPER than on N(0, I), and
    every scale must come out right without any tuning."""
    scales = jnp.asarray([1.0, 25.0, 400.0])

    def logdensity(x):
        return -0.5 * jnp.sum(x * x / scales)

    # adapt_mass off: this test pins the raw U-turn mechanism (trees must
    # DEEPEN to cover the wide coordinate); the mass-adaptation test below
    # covers the default path where adaptation makes deep trees unnecessary
    res = qnm.nuts_sample(
        logdensity, jax.random.PRNGKey(1), jnp.zeros((32, 3)),
        n_samples=800, n_warmup=400, max_depth=8, adapt_mass=False,
    )
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(
        draws.var(axis=0), np.asarray(scales), rtol=0.3
    )
    assert float(np.mean(np.asarray(res.mean_tree_depth))) > 2.0


def test_nuts_dense_mass_from_map_handoff():
    logdensity, cov = _corr_gaussian(3)
    res = qnm.nuts_sample(
        logdensity, jax.random.PRNGKey(2), jnp.zeros((32, 3)),
        mass=jnp.asarray(cov), n_samples=700, n_warmup=300,
    )
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(
        np.cov(draws.T), cov, atol=0.3 * np.abs(cov).max()
    )
    # ~isotropic after preconditioning: shallow trees
    assert float(np.mean(np.asarray(res.mean_tree_depth))) < 4.0


def test_nuts_on_neals_funnel():
    """The geometry NUTS was built for: both tails of v covered and the
    v-marginal variance in the right decade (exact = 9)."""
    from quasinewtonmethods_jl_tpu.models import funnel_logdensity

    res = qnm.nuts_sample(
        funnel_logdensity, jax.random.PRNGKey(3),
        0.5 * jax.random.normal(jax.random.PRNGKey(33), (64, 6)),
        n_samples=1200, n_warmup=600, target_accept=0.9,
    )
    v = np.asarray(res.samples[:, :, 0]).ravel()
    assert np.isfinite(v).all()
    assert (v > 2.0).mean() > 0.05
    assert (v < -2.0).mean() > 0.02
    assert 4.0 < v.var() < 15.0


def test_nuts_divergences_reject_in_band():
    """A pathological step size must diverge on the FIRST leaf of every
    tree: the chain never moves and everything stays finite."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    res = qnm.nuts_sample(
        logdensity, jax.random.PRNGKey(4), jnp.ones((4, 3)),
        n_samples=30, n_warmup=0, step_size=1e6,
    )
    s = np.asarray(res.samples)
    assert np.isfinite(s).all()
    np.testing.assert_array_equal(s, np.ones_like(s))  # all rejected
    assert np.all(np.asarray(res.accept_prob) == 0.0)


def test_nuts_reproducible_and_f32():
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    kw = dict(n_samples=20, n_warmup=10)
    a = qnm.nuts_sample(logdensity, jax.random.PRNGKey(5),
                        jnp.zeros((4, 2)), **kw)
    b = qnm.nuts_sample(logdensity, jax.random.PRNGKey(5),
                        jnp.zeros((4, 2)), **kw)
    np.testing.assert_array_equal(np.asarray(a.samples), np.asarray(b.samples))

    r = qnm.nuts_sample(logdensity, jax.random.PRNGKey(6),
                        jnp.zeros((8, 3), jnp.float32),
                        n_samples=40, n_warmup=40)
    assert r.samples.dtype == jnp.float32
    assert np.isfinite(np.asarray(r.samples)).all()


def test_nuts_fleet_mass_adaptation_shrinks_trees():
    """The fleet-diagonal mass (same estimator as ChEES) must recover a
    400x scale spread AND cut tree depth — each doubling costs 2^j
    gradients, so preconditioning is a direct throughput lever. Both runs
    must still land every variance."""
    scales = jnp.asarray([1.0, 25.0, 400.0])

    def logdensity(x):
        return -0.5 * jnp.sum(x * x / scales)

    kw = dict(n_samples=600, n_warmup=400, max_depth=8)
    off = qnm.nuts_sample(logdensity, jax.random.PRNGKey(7),
                          jnp.zeros((32, 3)), adapt_mass=False, **kw)
    on = qnm.nuts_sample(logdensity, jax.random.PRNGKey(7),
                         jnp.zeros((32, 3)), **kw)
    for r in (off, on):
        d = np.asarray(r.samples).reshape(-1, 3)
        np.testing.assert_allclose(d.var(axis=0), np.asarray(scales),
                                   rtol=0.35)
    depth_on = float(np.mean(np.asarray(on.mean_tree_depth)))
    depth_off = float(np.mean(np.asarray(off.mean_tree_depth)))
    assert depth_on < depth_off - 0.5, (depth_on, depth_off)
    # the adapted metric itself is right to within a factor ~3
    ratio = np.asarray(on.mass_diag) / np.asarray(scales)
    assert np.all(ratio > 1 / 3) and np.all(ratio < 3.0)


# ---- round 3: fleet covariance mass adaptation + low-rank metric ----


def test_lowrank_mass_ops_match_dense():
    """LowRankMass apply/kinetic/diag/momentum-draw agree with the dense
    materialization M = g(I-QQ') + Q diag(sig) Q' algebraically."""
    from quasinewtonmethods_jl_tpu.sampling import (
        LowRankMass, _apply_mass, _kinetic, _mass_diag,
    )

    rng = np.random.default_rng(0)
    n, r = 10, 4
    Q, _ = jnp.linalg.qr(jnp.asarray(rng.standard_normal((n, r))))
    sig = jnp.asarray(rng.uniform(0.5, 3.0, r))
    gamma = jnp.asarray(1.4)
    M = LowRankMass(gamma=gamma, Q=Q, sig=sig)
    Md = gamma * (jnp.eye(n) - Q @ Q.T) + Q @ jnp.diag(sig) @ Q.T

    p = jnp.asarray(rng.standard_normal((7, n)))
    np.testing.assert_allclose(
        np.asarray(_apply_mass(M, p)), np.asarray(p @ Md.T), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(_kinetic(p, M)),
        0.5 * np.einsum(
            "ci,ij,cj->c", np.asarray(p), np.asarray(Md), np.asarray(p)
        ),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(_mass_diag(M)), np.asarray(jnp.diagonal(Md)), rtol=1e-12
    )
    # the momentum transform is exactly M^(-1/2): T T' == inv(M)
    qz = jnp.eye(n) @ Q
    T = jnp.eye(n) * jax.lax.rsqrt(gamma) + (
        qz * (jax.lax.rsqrt(sig) - jax.lax.rsqrt(gamma))[None, :]
    ) @ Q.T
    np.testing.assert_allclose(
        np.asarray(T @ T.T), np.asarray(jnp.linalg.inv(Md)), rtol=1e-10
    )


def test_lowrank_mass_with_outer_scale_matches_dense():
    """The d-scaled metric (round 4: adapt_mass='lowrank' output) equals
    the dense materialization M_d = D^(1/2) M D^(1/2) in every closed
    form HMC touches, including the momentum transform's covariance."""
    from quasinewtonmethods_jl_tpu.sampling import (
        LowRankMass, _apply_mass, _apply_mass_single, _draw_momentum,
        _kinetic, _mass_diag,
    )

    rng = np.random.default_rng(5)
    n, r = 10, 3
    Q, _ = jnp.linalg.qr(jnp.asarray(rng.standard_normal((n, r))))
    sig = jnp.asarray(rng.uniform(0.5, 3.0, r))
    gamma = jnp.asarray(0.7)
    d = jnp.asarray(rng.uniform(0.2, 9.0, n))
    M = LowRankMass(gamma=gamma, Q=Q, sig=sig, d=d)
    core = gamma * (jnp.eye(n) - Q @ Q.T) + Q @ jnp.diag(sig) @ Q.T
    Md = jnp.sqrt(d)[:, None] * core * jnp.sqrt(d)[None, :]

    p = jnp.asarray(rng.standard_normal((7, n)))
    np.testing.assert_allclose(
        np.asarray(_apply_mass(M, p)), np.asarray(p @ Md.T), rtol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(_apply_mass_single(M, p[0])), np.asarray(Md @ p[0]),
        rtol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(_kinetic(p, M)),
        0.5 * np.einsum(
            "ci,ij,cj->c", np.asarray(p), np.asarray(Md), np.asarray(p)
        ),
        rtol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(_mass_diag(M)), np.asarray(jnp.diagonal(Md)), rtol=1e-11
    )
    # empirical momentum covariance -> Md^(-1) (big sample, loose bar)
    ps = _draw_momentum(jax.random.PRNGKey(0), 200_000, n, jnp.float64, M, None)
    emp = np.cov(np.asarray(ps).T)
    tgt = np.asarray(jnp.linalg.inv(Md))
    assert np.max(np.abs(emp - tgt)) / np.max(np.abs(tgt)) < 0.03


def test_hmc_lowrank_mass_recovers_correlated_gaussian():
    from quasinewtonmethods_jl_tpu.sampling import LowRankMass

    rng = np.random.default_rng(1)
    n, r = 10, 4
    Q, _ = jnp.linalg.qr(jnp.asarray(rng.standard_normal((n, r))))
    sig = jnp.asarray(rng.uniform(0.5, 3.0, r))
    M = LowRankMass(gamma=jnp.asarray(1.4), Q=Q, sig=sig)
    Md = 1.4 * (jnp.eye(n) - Q @ Q.T) + Q @ jnp.diag(sig) @ Q.T
    Ci = jnp.linalg.inv(Md)

    def logd(x):
        return -0.5 * x @ Ci @ x

    res = qnm.hmc_sample(
        logd, jax.random.PRNGKey(0), jnp.zeros((64, n)), mass=M,
        n_samples=800, n_warmup=400,
    )
    emp = np.cov(np.asarray(res.samples).reshape(-1, n).T)
    err = np.max(np.abs(emp - np.asarray(Md))) / np.max(np.abs(np.asarray(Md)))
    assert err < 0.25, err


def test_nuts_dense_fleet_adaptation_matches_oracle_depth():
    """The round-2 verdict's acceptance bar: on a correlated Gaussian
    (where the builder measured diag mass does NOT reduce NUTS depth),
    across-chain dense covariance adaptation must get grad-evals/draw
    within 1.3x of an oracle run given the true covariance as mass."""
    rng = np.random.default_rng(7)
    n = 8
    rho = 0.95
    C = np.full((n, n), rho) + (1 - rho) * np.eye(n)
    scales = np.geomspace(0.5, 5.0, n)
    C = C * np.outer(scales, scales)
    Ci = jnp.linalg.inv(jnp.asarray(C))

    def logd(x):
        return -0.5 * x @ Ci @ x

    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((64, n))
    kw = dict(n_samples=200, n_warmup=300, max_depth=9)
    oracle = qnm.nuts_sample(logd, key, x0, mass=jnp.asarray(C), **kw)
    dense = qnm.nuts_sample(logd, key, x0, adapt_mass="dense", **kw)
    do = float(oracle.mean_tree_depth.mean())
    dd = float(dense.mean_tree_depth.mean())
    assert 2.0 ** dd <= 1.3 * 2.0 ** do, (dd, do)
    emp = np.cov(np.asarray(dense.samples).reshape(-1, n).T)
    assert np.max(np.abs(emp - C)) / np.max(np.abs(C)) < 0.2


def test_chees_dense_adaptation_moments():
    rng = np.random.default_rng(9)
    n = 6
    A = rng.standard_normal((n, n))
    C = A @ A.T / n + np.eye(n)
    Ci = jnp.linalg.inv(jnp.asarray(C))

    def logd(x):
        return -0.5 * x @ Ci @ x

    res = qnm.chees_sample(
        logd, jax.random.PRNGKey(1), jnp.zeros((64, n)), adapt_mass="dense",
        n_samples=500, n_warmup=400,
    )
    emp = np.cov(np.asarray(res.samples).reshape(-1, n).T)
    err = np.max(np.abs(emp - C)) / np.max(np.abs(C))
    assert err < 0.3, err
    # the reported mass diagonal tracks the target's diagonal scale-wise
    ratio = np.asarray(res.mass_diag) / np.diag(C)
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0)


def test_dense_adaptation_chunked_equals_long():
    """The resume discipline extends to the dense-mass mode: the (n, n)
    covariance EMA rides the state and replays exactly."""
    def logd(t):
        return -0.5 * jnp.sum(t * t * jnp.array([1.0, 4.0, 0.25]))

    key = jax.random.PRNGKey(5)
    x0 = jnp.asarray(np.random.default_rng(0).standard_normal((16, 3)))
    long = qnm.chees_sample(
        logd, key, x0, n_samples=20, n_warmup=20, adapt_mass="dense"
    )
    r1 = qnm.chees_sample(
        logd, key, x0, n_samples=0, n_warmup=12, total_warmup=20,
        adapt_mass="dense",
    )
    r2 = qnm.chees_sample_from_state(
        logd, r1.state, n_samples=20, n_warmup=8, adapt_mass="dense"
    )
    np.testing.assert_array_equal(
        np.asarray(long.samples), np.asarray(r2.samples)
    )
    assert r2.state.var_ema.shape == (3, 3)


def test_chees_lowrank_adaptation_recovers_subspace_and_moments():
    """adapt_mass='lowrank' (round-4, VERDICT round-3 item 5): one
    subspace-iteration step per warmup round on the EMA'd fleet-covariance
    OPERATOR must rotate the rank-r basis onto the target's dominant
    correlated directions — with no (n, n) object in the adaptation state
    — and the sampled moments must recover the target."""
    rng = np.random.default_rng(13)
    n, r_true = 16, 3
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V = V[:, :r_true]
    C = np.eye(n) + V @ np.diag([30.0, 15.0, 8.0]) @ V.T
    Ci = jnp.linalg.inv(jnp.asarray(C))

    def logd(x):
        return -0.5 * x @ Ci @ x

    res = qnm.chees_sample(
        logd, jax.random.PRNGKey(2), jnp.zeros((128, n)),
        adapt_mass="lowrank", mass_rank=6,
        n_samples=400, n_warmup=500,
    )
    st = res.state
    # O(n·r) adaptation state only: diag EMA stays (n,), basis is (n, r)
    assert st.var_ema.shape == (n,)
    assert st.lr_Q.shape == (n, 6) and st.lr_sig.shape == (6,)
    # each true top direction is (almost) inside span(lr_Q)
    align = np.linalg.norm(np.asarray(st.lr_Q).T @ V, axis=0)
    assert np.all(align > 0.8), align
    # tracked eigenvalues see the amplified scales (top one ~31)
    assert float(jnp.max(st.lr_sig)) > 5.0
    # the frozen metric's diagonal tracks the target's diagonal
    ratio = np.asarray(res.mass_diag) / np.diag(C)
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0), ratio
    emp = np.cov(np.asarray(res.samples).reshape(-1, n).T)
    err = np.max(np.abs(emp - C)) / np.max(np.abs(C))
    assert err < 0.35, err


def test_lowrank_adaptation_chunked_equals_long():
    """The resume discipline extends to 'lowrank': lr_Q/lr_sig ride the
    state and the chunked run replays the long run exactly."""
    def logd(t):
        return -0.5 * jnp.sum(t * t * jnp.array([1.0, 4.0, 0.25, 2.0]))

    key = jax.random.PRNGKey(8)
    x0 = jnp.asarray(np.random.default_rng(3).standard_normal((16, 4)))
    kw = dict(adapt_mass="lowrank", mass_rank=2)
    long = qnm.chees_sample(logd, key, x0, n_samples=20, n_warmup=20, **kw)
    r1 = qnm.chees_sample(
        logd, key, x0, n_samples=0, n_warmup=12, total_warmup=20, **kw
    )
    # NOTE: no mass_rank on resume — the rank rides the saved lr_Q shape
    r2 = qnm.chees_sample_from_state(
        logd, r1.state, n_samples=20, n_warmup=8, adapt_mass="lowrank"
    )
    np.testing.assert_array_equal(
        np.asarray(long.samples), np.asarray(r2.samples)
    )
    assert r2.state.lr_Q.shape == (4, 2)
    np.testing.assert_array_equal(
        np.asarray(long.state.lr_Q), np.asarray(r2.state.lr_Q)
    )


def test_nuts_lowrank_adaptation_shrinks_depth_and_recovers_subspace():
    """adapt_mass='lowrank' on NUTS (round 4): the subspace iteration
    rides the NUTS warmup rounds exactly as in ChEES, the standardized
    core lands on the target's CORRELATION structure, and — the point
    for NUTS — the metric shrinks tree depth vs diagonal adaptation
    (each doubling costs 2^depth gradients). Fixture: geomspaced scales
    x uniform rho=0.9 — diag captures the scales but not the
    correlation (measured here: diag depth ~2.8, standardized lowrank
    ~1.8; the pre-standardization scalar-γ core measured ~3.9, WORSE
    than diag, which is why the core is standardized)."""
    n = 16
    s = np.geomspace(1.0, 10.0, n)
    R = np.full((n, n), 0.9) + 0.1 * np.eye(n)
    C = np.outer(s, s) * R
    Ci = jnp.linalg.inv(jnp.asarray(C))

    def logd(x):
        return -0.5 * x @ Ci @ x

    kw = dict(n_samples=60, n_warmup=200, max_depth=8)
    lr = qnm.nuts_sample(
        logd, jax.random.PRNGKey(2), jnp.zeros((64, n)),
        adapt_mass="lowrank", mass_rank=4, **kw,
    )
    st = lr.state
    assert st.var_ema.shape == (n,)  # O(n·r) adaptation state only
    assert st.lr_Q.shape == (n, 4) and st.lr_sig.shape == (4,)
    # the standardized covariance is the correlation matrix R; its one
    # dominant eigenvector must lie in the tracked span with its
    # amplified eigenvalue (1 + 0.9(n-1) = 14.5) on the tracked spectrum
    w, V = np.linalg.eigh(R)
    top = V[:, -1]
    assert float(np.linalg.norm(np.asarray(st.lr_Q).T @ top)) > 0.9
    assert float(jnp.max(st.lr_sig)) > 0.5 * w[-1]
    diag = qnm.nuts_sample(
        logd, jax.random.PRNGKey(2), jnp.zeros((64, n)),
        adapt_mass=True, **kw,
    )
    assert (
        float(lr.mean_tree_depth.mean())
        < float(diag.mean_tree_depth.mean()) - 0.5
    ), (float(lr.mean_tree_depth.mean()), float(diag.mean_tree_depth.mean()))


def test_nuts_lowrank_chunked_equals_long():
    """The resume discipline extends to NUTS 'lowrank': lr_Q/lr_sig ride
    NUTSState and the chunked run replays the long run exactly."""
    def logd(t):
        return -0.5 * jnp.sum(t * t * jnp.array([1.0, 4.0, 0.25, 2.0]))

    key = jax.random.PRNGKey(8)
    x0 = jnp.asarray(np.random.default_rng(3).standard_normal((16, 4)))
    kw = dict(adapt_mass="lowrank", mass_rank=2)
    long = qnm.nuts_sample(logd, key, x0, n_samples=12, n_warmup=16, **kw)
    r1 = qnm.nuts_sample(
        logd, key, x0, n_samples=0, n_warmup=9, total_warmup=16, **kw
    )
    # NOTE: no mass_rank on resume — the rank rides the saved lr_Q shape
    r2 = qnm.nuts_sample_from_state(
        logd, r1.state, n_samples=12, n_warmup=7, adapt_mass="lowrank"
    )
    np.testing.assert_array_equal(
        np.asarray(long.samples), np.asarray(r2.samples)
    )
    assert r2.state.lr_Q.shape == (4, 2)
    np.testing.assert_array_equal(
        np.asarray(long.state.lr_Q), np.asarray(r2.state.lr_Q)
    )


def test_chain_init_from_map_lowrank_handoff():
    """mass_form='lowrank' hands the samplers a LowRankMass built from
    the best lane's ring; sampling a correlated Gaussian through it
    recovers the moments (the dense-free large-n pipeline)."""
    from quasinewtonmethods_jl_tpu.sampling import LowRankMass

    rng = np.random.default_rng(11)
    n = 12
    A = rng.standard_normal((n, n))
    C = A @ A.T / n + np.eye(n)
    Ci = jnp.linalg.inv(jnp.asarray(C))

    def logd(x):
        return -0.5 * x @ Ci @ x

    x0 = jnp.asarray(rng.standard_normal((8, n)))
    fleet = qnm.optimize_lbfgs_batched(logd, x0, history=12, tol=1e-8)
    assert np.any(np.asarray(fleet.status) == qnm.Status.CONVERGED)
    chains, mass = qnm.chain_init_from_map(fleet, mass_form="lowrank")
    assert isinstance(mass, LowRankMass)
    res = qnm.hmc_sample(
        logd, jax.random.PRNGKey(2), chains, mass=mass,
        n_samples=600, n_warmup=300,
    )
    emp = np.cov(np.asarray(res.samples).reshape(-1, n).T)
    err = np.max(np.abs(emp - C)) / np.max(np.abs(C))
    assert err < 0.35, err


def test_chain_init_lowrank_on_bfgs_raises():
    def logd(x):
        return -jnp.sum((x - 1.0) ** 2)

    fleet = qnm.optimize_batched(logd, jnp.zeros((4, 3)))
    with pytest.raises(ValueError, match="lowrank"):
        qnm.chain_init_from_map(fleet, mass_form="lowrank")
    with pytest.raises(ValueError, match="mass_form"):
        qnm.chain_init_from_map(fleet, mass_form="nope")


@pytest.mark.parametrize("sampler", ["hmc", "chees", "nuts"])
def test_energies_and_divergences_contract(sampler):
    """Every HMC-family result carries (draws, chains) Hamiltonians and a
    per-chain divergence count; an easy Gaussian mixes with E-BFMI above
    Stan's 0.3 warning bar and zero divergences."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    chains, n, draws = 16, 4, 250
    key = jax.random.PRNGKey(5)
    x0s = jax.random.normal(key, (chains, n))
    fn = {"hmc": qnm.hmc_sample, "chees": qnm.chees_sample,
          "nuts": qnm.nuts_sample}[sampler]
    res = fn(logdensity, key, x0s, n_samples=draws, n_warmup=200)
    e = np.asarray(res.energies)
    d = np.asarray(res.divergences)
    assert e.shape == (draws, chains)
    assert d.shape == (chains,) and np.issubdtype(d.dtype, np.integer)
    assert np.all(np.isfinite(e))
    assert np.all(d == 0)
    bfmi = qnm.energy_bfmi(e)
    assert np.all(bfmi > 0.3), bfmi
    # energies must actually be the Hamiltonian scale of this target:
    # E[E] = (potential + kinetic)/draw ~ n/2 + n/2 = n for a standard
    # Gaussian (generous MC bar)
    assert abs(e.mean() - n) < 1.5


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_energies_chunked_identical(sampler):
    """The resume contract extends to the new observability outputs:
    chunked runs concatenate to the long run's exact energies and sum to
    its divergence counts."""
    def logdensity(x):
        return -0.5 * jnp.sum(x * x)

    chains, n = 8, 3
    key = jax.random.PRNGKey(6)
    x0s = jax.random.normal(key, (chains, n))
    if sampler == "hmc":
        long = qnm.hmc_sample(logdensity, key, x0s, n_samples=120,
                              n_warmup=80)
        r1 = qnm.hmc_sample(logdensity, key, x0s, n_samples=50,
                            n_warmup=80)
        r2 = qnm.hmc_sample_from_state(logdensity, r1.state, n_samples=70)
    else:
        long = qnm.nuts_sample(logdensity, key, x0s, n_samples=120,
                               n_warmup=80)
        r1 = qnm.nuts_sample(logdensity, key, x0s, n_samples=50,
                             n_warmup=80)
        r2 = qnm.nuts_sample_from_state(logdensity, r1.state, n_samples=70)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(r1.energies), np.asarray(r2.energies)]),
        np.asarray(long.energies),
    )
    assert int(r1.divergences.sum() + r2.divergences.sum()) == int(
        long.divergences.sum()
    )


def test_divergences_count_in_band():
    """A step size far past the stability limit must be *counted* as
    divergent (and rejected in-band), not raise or poison the chain."""
    def stiff(x):
        return -0.5 * 1e6 * jnp.sum(x * x)

    chains, n = 8, 3
    key = jax.random.PRNGKey(7)
    x0s = 0.001 * jax.random.normal(key, (chains, n))
    rh = qnm.hmc_sample(stiff, key, x0s, n_samples=60, n_warmup=0,
                        step_size=10.0)
    assert int(rh.divergences.sum()) > 0
    assert np.all(np.isfinite(np.asarray(rh.final_x)))
    rn = qnm.nuts_sample(stiff, key, x0s, n_samples=40, n_warmup=0,
                         step_size=5.0)
    assert int(rn.divergences.sum()) > 0
    assert np.all(np.isfinite(np.asarray(rn.final_x)))
