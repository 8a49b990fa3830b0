"""Structured-parameter (pytree) solves."""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm


def logreg_logdensity(params):
    # dict params: weights vector + bias scalar + log-scale prior
    w, b = params["w"], params["b"]
    X = jnp.asarray(
        np.random.default_rng(3).standard_normal((50, 4)), w.dtype
    )
    y = (X @ jnp.asarray([1.0, -1.0, 0.5, 0.0], w.dtype) + 0.3 > 0).astype(w.dtype)
    logits = X @ w + b
    loglik = jnp.sum(
        y * jax.nn.log_sigmoid(logits) + (1 - y) * jax.nn.log_sigmoid(-logits)
    )
    return loglik - 0.05 * (jnp.sum(w * w) + b * b)


def test_optimize_pytree_dict(rng):
    x0 = {"w": jnp.zeros(4), "b": jnp.zeros(())}
    params, res = qnm.optimize_pytree(logreg_logdensity, x0)
    assert bool(res.converged)
    assert set(params) == {"w", "b"}
    assert params["w"].shape == (4,)
    assert params["b"].shape == ()
    # mode must agree with the flat solve of the same problem
    flat0, unravel = jax.flatten_util.ravel_pytree(x0)
    res_flat = qnm.optimize(lambda f: logreg_logdensity(unravel(f)), flat0)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(res_flat.x), atol=1e-8
    )


def test_optimize_lbfgs_pytree_nested(rng):
    x0 = {"blocks": [jnp.asarray(rng.standard_normal(8)),
                     jnp.asarray(rng.standard_normal(3))],
          "scale": jnp.zeros(())}

    def f(p):
        a, b = p["blocks"]
        return -(jnp.sum((a - 1.0) ** 2) + jnp.sum((b + 2.0) ** 2)
                 + (p["scale"] - 0.5) ** 2)

    params, res = qnm.optimize_lbfgs_pytree(f, x0)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(params["blocks"][0]), 1.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(params["blocks"][1]), -2.0, atol=1e-7)
    np.testing.assert_allclose(float(params["scale"]), 0.5, atol=1e-7)


def test_pytree_jit_cache_reuse(rng):
    """Same objective + structure twice must not retrace (hashable adapter)."""
    x0 = {"w": jnp.zeros(4), "b": jnp.zeros(())}
    _, r1 = qnm.optimize_pytree(logreg_logdensity, x0)
    x0b = {"w": jnp.ones(4), "b": jnp.ones(())}
    _, r2 = qnm.optimize_pytree(logreg_logdensity, x0b)
    assert bool(r1.converged) and bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x), atol=1e-7)


def test_pytree_rejects_int_params():
    import pytest

    with pytest.raises(TypeError):
        qnm.optimize_pytree(lambda p: -jnp.sum(p["a"] ** 2.0), {"a": jnp.arange(3)})


def test_optimize_batched_pytree(rng):
    batch = 12

    def f(p):
        return -(jnp.sum((p["w"] - 1.0) ** 2) + (p["b"] + 2.0) ** 2)

    x0 = {
        "w": jnp.asarray(rng.standard_normal((batch, 5))),
        "b": jnp.asarray(rng.standard_normal(batch)),
    }
    params, res = qnm.optimize_batched_pytree(f, x0, backend="fused")
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)
    assert params["w"].shape == (batch, 5)
    assert params["b"].shape == (batch,)
    np.testing.assert_allclose(np.asarray(params["w"]), 1.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(params["b"]), -2.0, atol=1e-7)


def test_map_then_sample_pytree():
    """Structured params end-to-end: MAP + draws come back in the tree
    structure, names label the flat summary, and the flat result keeps
    the full pipeline surface."""
    mu = jnp.asarray([1.0, -2.0])

    def logd(params):
        return (
            -0.5 * jnp.sum((params["beta"] - mu) ** 2)
            - 0.5 * (params["scales"]["sigma"] - 0.5) ** 2
        )

    tree0 = {"beta": jnp.zeros(2), "scales": {"sigma": jnp.asarray(0.0)}}
    out = qnm.map_then_sample_pytree(
        logd, jax.random.PRNGKey(3), tree0, n_chains=16, n_samples=300,
        n_warmup=200,
    )
    assert out.samples["beta"].shape == (300, 16, 2)
    assert out.samples["scales"]["sigma"].shape == (300, 16)
    np.testing.assert_allclose(np.asarray(out.x_map["beta"]), mu, atol=1e-5)
    np.testing.assert_allclose(
        float(out.x_map["scales"]["sigma"]), 0.5, atol=1e-5
    )
    draws = np.asarray(out.samples["beta"]).reshape(-1, 2)
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.15)
    assert out.names == ("beta[0]", "beta[1]", "scales.sigma")
    # the flat surface carries the summary/diagnostics story
    s = qnm.posterior_summary(out.flat.samples)
    tbl = s.table(names=list(out.names))
    assert "scales.sigma" in tbl
    assert out.flat.diagnostics is not None


def test_pytree_names_shapes():
    names = qnm.pytree_names(
        {"A": jnp.zeros((2, 2)), "b": jnp.asarray(1.0)}
    )
    assert names == ["A[0,0]", "A[0,1]", "A[1,0]", "A[1,1]", "b"]


# ---------------------------------------------------------------------------
# Round 5: the whole engine family over pytrees (verdict item 5)
# ---------------------------------------------------------------------------


def _hier_tree(dtype=jnp.float64):
    """Dict-structured hierarchical-model parameters: coefficient block,
    scalar intercept, per-group offsets."""
    return {
        "beta": jnp.zeros(3, dtype),
        "mu": jnp.zeros((), dtype),
        "groups": {"offsets": jnp.zeros(2, dtype)},
    }


def _hier_logdensity(p):
    """A strictly concave hierarchical toy: quadratics around distinct
    targets with a shrinkage coupling (known unique MAP)."""
    beta, mu, off = p["beta"], p["mu"], p["groups"]["offsets"]
    return (
        -jnp.sum((beta - jnp.asarray([1.0, -2.0, 0.5], beta.dtype)) ** 2)
        - 2.0 * (mu - 0.7) ** 2
        - jnp.sum((off - mu) ** 2)
    )


def _hier_map():
    """Analytic MAP: beta = target; d/dmu = -4(mu-.7) + 2*sum(off-mu) = 0,
    d/doff = -2(off-mu) = 0 -> off = mu, mu = 0.7."""
    return {
        "beta": np.asarray([1.0, -2.0, 0.5]),
        "mu": np.asarray(0.7),
        "groups": {"offsets": np.asarray([0.7, 0.7])},
    }


def _assert_tree_close(got, want, atol):
    flat_g = jax.flatten_util.ravel_pytree(got)[0]
    flat_w = jax.flatten_util.ravel_pytree(
        jax.tree_util.tree_map(jnp.asarray, want)
    )[0]
    np.testing.assert_allclose(np.asarray(flat_g), np.asarray(flat_w),
                               atol=atol)


def test_optimize_cg_pytree():
    params, res = qnm.optimize_cg_pytree(_hier_logdensity, _hier_tree())
    assert bool(res.converged)
    _assert_tree_close(params, _hier_map(), 1e-6)
    # stacked fleet: two lanes from different starts, same mode
    x0s = jax.tree_util.tree_map(
        lambda l: jnp.stack([l, l + 0.5]), _hier_tree()
    )
    params_b, res_b = qnm.optimize_cg_pytree(
        _hier_logdensity, x0s, stacked=True
    )
    assert bool(res_b.converged.all())
    assert params_b["beta"].shape == (2, 3)
    for i in (0, 1):
        _assert_tree_close(
            jax.tree_util.tree_map(lambda l: l[i], params_b),
            _hier_map(), 1e-6,
        )


def test_optimize_tr_pytree_with_bounds():
    params, res = qnm.optimize_tr_pytree(_hier_logdensity, _hier_tree())
    assert bool(res.converged)
    _assert_tree_close(params, _hier_map(), 1e-6)
    # pytree bounds: cap beta[1] >= -1 (binds; analytic solution moves
    # only that coordinate for this separable beta block)
    lo = {
        "beta": jnp.asarray([-jnp.inf, -1.0, -jnp.inf]),
        "mu": -jnp.inf,
        "groups": {"offsets": jnp.full(2, -jnp.inf)},
    }
    # mixed-form sides: lo is a pytree (raveled), hi a scalar (broadcast)
    params_b, res_b = qnm.optimize_tr_pytree(
        _hier_logdensity, _hier_tree(), bounds=(lo, jnp.inf)
    )
    assert bool(res_b.converged)
    np.testing.assert_allclose(float(params_b["beta"][1]), -1.0, atol=1e-7)
    np.testing.assert_allclose(float(params_b["mu"]), 0.7, atol=1e-7)


def test_least_squares_pytree():
    """Fit y = a*exp(-b t) with structured params {'amp': a, 'rate': b}
    (minimization convention, exact-fit residuals -> zero loss)."""
    t = jnp.linspace(0.0, 3.0, 24)
    y = 2.0 * jnp.exp(-1.3 * t)

    def resid(p):
        return p["amp"] * jnp.exp(-p["rate"] * t) - y

    params, res = qnm.least_squares_pytree(
        resid, {"amp": jnp.asarray(1.0), "rate": jnp.asarray(0.5)}
    )
    assert bool(res.converged)
    np.testing.assert_allclose(float(params["amp"]), 2.0, atol=1e-8)
    np.testing.assert_allclose(float(params["rate"]), 1.3, atol=1e-8)
    # stacked fleet with per-lane data
    y2 = jnp.stack([y, 3.0 * jnp.exp(-0.7 * t)])

    def resid_d(p, ylane):
        return p["amp"] * jnp.exp(-p["rate"] * t) - ylane

    x0s = {"amp": jnp.ones(2), "rate": jnp.full(2, 0.5)}
    params_b, res_b = qnm.least_squares_pytree(
        resid_d, x0s, stacked=True, data=y2
    )
    assert bool(res_b.converged.all())
    np.testing.assert_allclose(np.asarray(params_b["amp"]), [2.0, 3.0],
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(params_b["rate"]), [1.3, 0.7],
                               atol=1e-7)


def test_optimize_auglag_pytree():
    """Constrained structured solve: the constraint consumes the SAME
    pytree as the objective (sum(beta) + mu = 0)."""

    def eq(p):
        return jnp.sum(p["beta"]) + p["mu"]

    params, res = qnm.optimize_auglag_pytree(
        _hier_logdensity, _hier_tree(), eq=eq
    )
    assert bool(res.converged)
    np.testing.assert_allclose(
        float(jnp.sum(params["beta"]) + params["mu"]), 0.0, atol=1e-7
    )
    assert res.lam.shape == (1,)
    # stacked constrained fleet
    x0s = jax.tree_util.tree_map(
        lambda l: jnp.stack([l, l + 0.3]), _hier_tree()
    )
    params_b, res_b = qnm.optimize_auglag_pytree(
        _hier_logdensity, x0s, eq=eq, stacked=True
    )
    assert bool(res_b.converged.all())
    viols = np.asarray(
        jax.vmap(lambda b, m: jnp.sum(b) + m)(
            params_b["beta"], params_b["mu"]
        )
    )
    np.testing.assert_allclose(viols, 0.0, atol=1e-6)


def test_minimize_pytree_all_methods():
    """The scipy-convention shim over structures, every engine family."""

    def g(p):  # minimize -logdensity
        return -_hier_logdensity(p)

    for method in ("bfgs", "lbfgs", "cg", "tr"):
        params, res = qnm.minimize_pytree(g, _hier_tree(), method=method)
        assert bool(res.converged), method
        _assert_tree_close(params, _hier_map(), 1e-5)
        # minimization convention on the way out
        assert float(res.fun) >= 0.0
    # constrained route over the pytree
    params_c, res_c = qnm.minimize_pytree(
        g, _hier_tree(), ineq=lambda p: p["mu"] - 1.0
    )
    assert bool(res_c.converged)
    np.testing.assert_allclose(float(params_c["mu"]), 1.0, atol=1e-6)
    assert float(res_c.mu[0]) > 0.0  # active bound, positive price


def test_pytree_analytic_vag_ravels():
    """value_and_grad_fn over the pytree: the gradient tree is raveled
    transparently; trajectory matches AD bitwise (same math)."""

    def vag(p):
        v, g = jax.value_and_grad(_hier_logdensity)(p)
        return v, g

    p_ad, r_ad = qnm.optimize_cg_pytree(_hier_logdensity, _hier_tree())
    p_an, r_an = qnm.optimize_cg_pytree(
        _hier_logdensity, _hier_tree(), value_and_grad_fn=vag
    )
    assert bool(r_an.converged)
    assert int(r_ad.iterations) == int(r_an.iterations)
    _assert_tree_close(p_an, p_ad, 1e-12)
