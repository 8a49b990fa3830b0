"""Executable tour of the public API — every entry point in ~a minute.

Run: python examples/tour.py    (CPU or GPU; CPU uses f64 + tol 1e-8)
"""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator
from quasinewtonmethods_jl_tpu import parallel as par
from quasinewtonmethods_jl_tpu.models import (
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    PoissonRegressionMAP,
    Rosenbrock,
    rosenbrock_logdensity,
)
from quasinewtonmethods_jl_tpu.utils import (
    load_state,
    practically_converged,
    save_state,
    solve_stats,
)


# f64 parity mode on the CPU: examples assume float64 semantics on CPU (the
# reference's native precision); jax keeps x64 off by default.
if not on_accelerator():
    jax.config.update("jax_enable_x64", True)


def main():
    on_accel = on_accelerator()
    dtype = default_dtype()
    tol = 1e-3 if on_accel else 1e-8
    key = jax.random.PRNGKey(0)
    say = lambda *a: print(*a, flush=True)

    # -- scalar BFGS (reference-parity core) --------------------------------
    x0 = jax.random.normal(key, (24,), dtype)
    res = qnm.optimize(rosenbrock_logdensity, x0, tol=tol)
    say(f"optimize:            {qnm.Status(int(res.status)).name:10s} "
        f"iters={int(res.iterations)} stats={solve_stats(res)}")

    # order-3 line search, reference-exact semantics
    res3 = qnm.optimize(rosenbrock_logdensity, x0, tol=tol,
                        ls=qnm.BackTracking(order=3), h0_scale=False)
    say(f"order-3 / no-H0:     {qnm.Status(int(res3.status)).name:10s} "
        f"iters={int(res3.iterations)}")

    # Wolfe line search
    resw = qnm.optimize(rosenbrock_logdensity, x0, tol=tol, ls=qnm.Wolfe())
    say(f"Wolfe:               {qnm.Status(int(resw.status)).name:10s} "
        f"iters={int(resw.iterations)}")

    # model objects
    for model in (Rosenbrock(12), IllConditionedQuadratic(64, 1e3, dtype=dtype),
                  LogisticRegressionMAP(32, 200, dtype=dtype),
                  PoissonRegressionMAP(16, 200, dtype=dtype)):
        r = qnm.optimize(model, jnp.zeros(len(model), dtype), tol=max(tol, 1e-6))
        say(f"{type(model).__name__:20s} {qnm.Status(int(r.status)).name:10s} "
            f"iters={int(r.iterations)}")

    # -- checkpoint / resume -------------------------------------------------
    part = qnm.optimize(rosenbrock_logdensity, x0, tol=tol, max_iterations=3)
    save_state("/tmp/qnm_tour_state.npz", part.state)
    resumed = qnm.optimize_from_state(
        rosenbrock_logdensity, load_state("/tmp/qnm_tour_state.npz"), tol=tol)
    say(f"checkpoint+resume:   {qnm.Status(int(resumed.status)).name}")

    # -- L-BFGS (large n) ----------------------------------------------------
    diag = jnp.linspace(0.5, 3.0, 2048).astype(dtype)
    big = lambda x: -0.5 * jnp.sum(diag * x * x)
    rl = qnm.optimize_lbfgs(big, jax.random.normal(key, (2048,), dtype), tol=tol)
    say(f"optimize_lbfgs n=2k: {qnm.Status(int(rl.status)).name:10s} "
        f"iters={int(rl.iterations)}")

    # -- pytree params -------------------------------------------------------
    params, rp = qnm.optimize_pytree(
        lambda p: -(jnp.sum((p["w"] - 1) ** 2) + (p["b"] + 2) ** 2),
        {"w": jnp.zeros(5, dtype), "b": jnp.zeros((), dtype)}, tol=tol)
    say(f"optimize_pytree:     {qnm.Status(int(rp.status)).name:10s} "
        f"b*={float(params['b']):+.3f}")

    # -- Broyden family beyond BFGS -----------------------------------------
    for um in ("dfp", "sr1"):
        ru = qnm.optimize(rosenbrock_logdensity, x0, tol=tol,
                          update_method=um)
        say(f"update_method={um}:   {qnm.Status(int(ru.status)).name:10s} "
            f"iters={int(ru.iterations)}")

    # -- scipy-convention shim ----------------------------------------------
    rmin = qnm.minimize(lambda t: -rosenbrock_logdensity(t), x0, tol=tol)
    say(f"minimize:            {qnm.Status(int(rmin.status)).name:10s} "
        f"fun={float(rmin.fun):.2e} (>= 0: minimization convention)")
    assert float(rmin.fun) >= 0.0

    # -- batched fleet + multistart -----------------------------------------
    X0 = jax.random.normal(key, (256, 16), dtype)
    rb = qnm.optimize_batched(rosenbrock_logdensity, X0, tol=tol)
    ok = practically_converged(rb, tol=tol)
    say(f"optimize_batched:    {int(ok.sum())}/256 usable lanes")

    rms = qnm.optimize_multistart(
        lambda x: -0.5 * jnp.sum((x - 2) ** 2), key, n_starts=64, dim=3,
        tol=tol)
    say(f"optimize_multistart: best fun {float(rms.fun):.4f} "
        f"({int(rms.n_converged)}/64 converged)")

    # -- trust-region Newton-Krylov (exact curvature, matrix-free) -----------
    rtr = qnm.optimize_tr(rosenbrock_logdensity, x0, tol=tol)
    say(f"optimize_tr:         {qnm.Status(int(rtr.status)).name:10s} "
        f"iters={int(rtr.iterations)} hvps={int(rtr.n_hev)}")
    assert int(rtr.status) == qnm.Status.CONVERGED

    # -- nonlinear CG (O(n) state: the very-large-n fleet engine) ------------
    rcg = qnm.optimize_cg(rosenbrock_logdensity, x0, tol=tol,
                          max_iterations=50_000)
    say(f"optimize_cg:         {qnm.Status(int(rcg.status)).name:10s} "
        f"iters={int(rcg.iterations)} restarts={int(rcg.n_resets)}")
    assert int(rcg.status) == qnm.Status.CONVERGED

    # -- constrained solve (augmented Lagrangian over the same engines) ------
    # maximize -(x-2)^2 - (y-1)^2 on the line x + y = 1: KKT gives
    # x = (1, 0) with shadow price lam = 2
    rc = qnm.optimize_auglag(
        lambda z: -((z[0] - 2.0) ** 2) - ((z[1] - 1.0) ** 2),
        jnp.zeros(2, dtype), eq=lambda z: z[0] + z[1] - 1.0,
    )
    say(f"optimize_auglag:     {qnm.Status(int(rc.status)).name:10s} "
        f"x={np.asarray(rc.x).round(4)} lam={float(rc.lam[0]):.3f} "
        f"viol={float(rc.viol):.1e} outer={int(rc.n_outer)}")
    assert int(rc.status) == qnm.Status.CONVERGED

    # -- gradient-free ensemble sampling (the emcee algorithm) ---------------
    target_mu = jnp.asarray([1.0, -2.0, 0.5], dtype)
    laplace = lambda x: -jnp.sum(jnp.abs(x - target_mu))  # noqa: E731
    walkers = jax.random.normal(key, (64, 3), dtype)
    rens = qnm.ensemble_sample(laplace, key, walkers,
                               n_samples=1500, n_warmup=300)
    tau, reliable = qnm.ensemble_autocorr_time(rens.samples)
    say(f"ensemble_sample:     |mean err| "
        f"{float(jnp.max(jnp.abs(rens.samples.reshape(-1, 3).mean(0) - target_mu))):.3f} "
        f"on a non-differentiable target; tau={float(tau.max()):.1f} "
        f"(reliable={bool(reliable.all())})")

    # -- microcanonical Langevin (fixed-cost: every step is a draw) ----------
    rmc = qnm.mclmc_sample(lambda x: -0.5 * jnp.sum(x * x), key,
                           jax.random.normal(key, (64, 8), dtype),
                           n_samples=600, n_warmup=300)
    vmc = rmc.samples.reshape(-1, 8).var(0)
    say(f"mclmc_sample:        var in [{float(vmc.min()):.3f}, "
        f"{float(vmc.max()):.3f}] (controlled O(eps^2) bias), "
        f"eps={float(rmc.step_size):.2f} L={float(rmc.L):.2f}, "
        f"div={int(rmc.divergences.sum())}")

    # -- nonlinear least squares (fit 64 curves in one launch) ---------------
    ts = jnp.tile(jnp.linspace(0.0, 3.0, 32, dtype=dtype), (64, 1))
    true_p = jnp.stack([jnp.linspace(0.5, 2.0, 64),
                        jnp.linspace(0.2, 1.5, 64)], axis=1).astype(dtype)
    ys = true_p[:, :1] * jnp.exp(-true_p[:, 1:] * ts)
    rlm = qnm.least_squares(
        lambda p, d: p[0] * jnp.exp(-p[1] * d[0]) - d[1],
        jnp.ones((64, 2), dtype), data=(ts, ys), tol=tol)
    say(f"least_squares:       {int(jnp.sum(rlm.converged))}/64 fits, "
        f"max err {float(jnp.max(jnp.abs(rlm.x - true_p))):.2e}")

    # -- implicit differentiation -------------------------------------------
    f = lambda x, p: -0.5 * jnp.sum((x - p) ** 2)
    g = jax.grad(lambda p: jnp.sum(
        qnm.optimize_implicit(f, jnp.zeros(4, dtype), p,
                              qnm.ImplicitOptions(tol=tol))[0]))(
        jnp.ones(4, dtype))
    say(f"optimize_implicit:   d(sum x*)/dp = {np.asarray(g).round(3)}")

    # -- mesh sharding (virtual devices if CPU) ------------------------------
    if len(jax.devices()) >= 2:
        mesh = par.make_mesh({"data": min(len(jax.devices()), 8)})
        rs = par.optimize_batched_sharded(
            rosenbrock_logdensity,
            jax.random.normal(key, (mesh.shape["data"] * 8, 8), dtype),
            mesh, tol=tol)
        say(f"batched_sharded:     {int(jnp.sum(rs.status == 1))} converged over "
            f"{mesh.shape['data']} devices")
    else:
        say("batched_sharded:     skipped (single device)")

    # -- sampling + diagnostics (the MAP -> HMC workflow tail) --------------
    gauss = lambda t: -0.5 * jnp.sum(t * t)
    ch = qnm.chees_sample(gauss, key, jnp.zeros((16, 3), dtype),
                          n_samples=150, n_warmup=100)
    diag = qnm.diagnose_chains(ch.samples)
    say(f"chees_sample:        traj {float(ch.traj_length):.2f}, "
        f"max rhat {float(diag.rhat.max()):.3f}, "
        f"min ess {float(diag.ess.min()):.0f}")
    nu = qnm.nuts_sample(gauss, key, jnp.zeros((8, 3), dtype),
                         n_samples=100, n_warmup=80, max_depth=5)
    say(f"nuts_sample:         depth {float(nu.mean_tree_depth.mean()):.1f}, "
        f"accept {float(nu.accept_prob.mean()):.2f}")

    # on-device diagnostics: parity with the host oracle, (n,)-sized fetch
    ddev = qnm.diagnose_chains_device(ch.samples)
    say(f"device diagnostics:  max rhat {float(jnp.max(ddev.rhat)):.3f} "
        f"(host {float(diag.rhat.max()):.3f})")

    # sampler checkpoint/resume: chunked == long, bitwise
    part = qnm.chees_sample(gauss, key, jnp.zeros((16, 3), dtype),
                            n_samples=0, n_warmup=60, total_warmup=100)
    rest = qnm.chees_sample_from_state(gauss, part.state,
                                       n_samples=150, n_warmup=40)
    say(f"chees resume:        chunked == long: "
        f"{bool(jnp.array_equal(rest.samples, ch.samples))}")

    # evidence-grade polish + Laplace evidence (ring-based for L-BFGS)
    fleet = qnm.optimize_batched(gauss, jax.random.normal(key, (8, 3), dtype),
                                 tol=tol)
    pol = qnm.polish_newton(gauss, fleet, steps=2)
    lz = qnm.laplace_evidence(fleet, obj=gauss)
    say(f"polish+evidence:     max|grad| {float(pol.grad_norm_before.max()):.1e}"
        f" -> {float(pol.grad_norm_after.max()):.1e}, "
        f"logZ {float(lz[0]):.3f} (exact {1.5 * float(jnp.log(2 * jnp.pi)):.3f})")

    # replica exchange: multimodal recovery from a one-basin start
    from quasinewtonmethods_jl_tpu.models import GaussianMixture

    mix = GaussianMixture(means=[[3.0, 3.0], [-3.0, -3.0]],
                          weights=[0.7, 0.3])
    stuck = jnp.full((32, 2), 3.0, dtype)
    pt = qnm.pt_sample(mix.logdensity, jax.random.PRNGKey(14), stuck,
                       n_temps=5, beta_min=0.05, n_samples=200,
                       n_warmup=200, n_leapfrog=8)
    wts = np.asarray(mix.mode_weights(pt.samples))
    say(f"pt_sample:           mode weights {wts.round(2)} (true [0.7 0.3]),"
        f" min swap {float(np.min(np.asarray(pt.swap_rate))):.2f}")

    # AIS evidence: the asymptotically exact rung above Laplace
    ais = qnm.ais_evidence(mix.logdensity, jax.random.PRNGKey(15),
                           (jnp.zeros(2, dtype), jnp.full((2,), 16.0, dtype)),
                           n_particles=1024, n_steps=48, n_leapfrog=8,
                           schedule=2.0)
    say(f"ais_evidence:        logZ {float(ais.logZ):.3f} "
        f"(exact {float(jnp.log(2 * jnp.pi)):.3f}), "
        f"weight ESS {float(ais.ess):.0f}/1024")

    # adaptive tempered SMC: the anneal finds its own ladder (ESS-bisected
    # increments), spending rungs only where the target changes fastest
    smc = qnm.ais_evidence(mix.logdensity, jax.random.PRNGKey(15),
                           (jnp.zeros(2, dtype), jnp.full((2,), 16.0, dtype)),
                           n_particles=1024, n_steps=48, n_leapfrog=8,
                           schedule="adaptive", resample=True)
    say(f"smc adaptive:        logZ {float(smc.logZ):.3f} in "
        f"{int(smc.n_rungs)}/48 rungs, {int(smc.n_resamples)} resamples")

    # bridge sampling: evidence from the PT draws already in hand —
    # no gradients, no annealing run, sees every basin the chains visited
    br = qnm.bridge_evidence(mix.logdensity, jax.random.PRNGKey(16),
                             pt.samples,
                             (jnp.zeros(2, dtype), jnp.full((2,), 16.0, dtype)))
    say(f"bridge_evidence:     logZ {float(br.logZ):.3f} "
        f"(exact {float(jnp.log(2 * jnp.pi)):.3f}), "
        f"iters {int(br.n_iter)}, rel err ~{float(jnp.sqrt(br.re2)):.3f}")

    # the full Vehtari et al. 2021 diagnostics panel: rank-normalized /
    # folded R-hat (catches variance mismatch) + tail ESS (certifies
    # credible-interval endpoints)
    say(f"rank diagnostics:    rhat_rank {float(diag.rhat_rank.max()):.3f}, "
        f"min tail ESS {float(diag.ess_tail.min()):.0f}")

    # the energy panel (Betancourt's E-BFMI — geometry problems R-hat
    # can't see) + the Stan-style posterior table with MCSE
    bfmi = qnm.energy_bfmi(nu.energies)
    say(f"energy panel:        E-BFMI min {float(bfmi.min()):.2f} "
        f"(warn < 0.3), divergences {int(nu.divergences.sum())}")
    summ = qnm.posterior_summary(nu.samples)
    say("posterior_summary:   mcse max "
        f"{float(summ.mcse.max()):.4f}; first row: "
        + summ.table().splitlines()[1].split()[0])

    # structured parameters end-to-end: pipeline over a pytree
    ptree = qnm.map_then_sample_pytree(
        lambda p: (-0.5 * jnp.sum((p["beta"] - 1.0) ** 2)
                   - 0.5 * p["scales"]["sigma"] ** 2),
        jax.random.PRNGKey(31),
        {"beta": jnp.zeros(2, dtype),
         "scales": {"sigma": jnp.asarray(0.0, dtype)}},
        n_chains=16, n_samples=200, n_warmup=150,
    )
    say(f"pytree pipeline:     samples['beta'] {ptree.samples['beta'].shape},"
        f" names {list(ptree.names)}")

    # PSIS-LOO: out-of-sample model comparison from existing draws —
    # theta ~ posterior for y_i ~ N(theta, 1); compare against a model
    # whose predictions are biased by +1
    y = np.asarray([0.3, -0.9, 0.6, 1.4, -0.2, 0.8], dtype=np.float64)
    post = qnm.chees_sample(
        lambda t: -0.5 * jnp.sum((jnp.asarray(y, dtype) - t[0]) ** 2)
        - 0.5 * t[0] ** 2 / 25.0,
        jax.random.PRNGKey(17), jnp.zeros((8, 1), dtype),
        n_samples=128, n_warmup=100)
    pointwise = lambda t: -0.5 * ((jnp.asarray(y, dtype) - t[0]) ** 2
                                  + jnp.log(2 * jnp.pi))
    biased = lambda t: -0.5 * ((jnp.asarray(y, dtype) - t[0] - 1.0) ** 2
                               + jnp.log(2 * jnp.pi))
    loo_a = qnm.loo_psis(pointwise, draws=post.samples)
    loo_b = qnm.loo_psis(biased, draws=post.samples)
    d, se = qnm.loo_compare(loo_a, loo_b)
    say(f"loo_psis:            elpd {float(loo_a.elpd):.2f} "
        f"(p_loo {float(loo_a.p_loo):.2f}, max khat "
        f"{float(loo_a.khat.max()):.2f}); vs biased model "
        f"diff {float(d):+.2f} +- {float(se):.2f}")

    # -- native host runtime -------------------------------------------------
    try:
        from quasinewtonmethods_jl_tpu.host import rosenbrock_host

        rh = rosenbrock_host(np.random.default_rng(0).standard_normal(60))
        say(f"native C++ host:     status={rh.status} iters={rh.iterations}")
    except Exception as e:  # no g++ toolchain
        say(f"native C++ host:     skipped ({type(e).__name__})")

    say("tour complete")


if __name__ == "__main__":
    main()
