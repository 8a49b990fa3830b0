"""Full benchmark sweep — all five BASELINE.md configs.

Unlike bench.py (the driver-facing one-line headline), this prints a JSON
line per config. Runs on an accelerator only (f32, tol 1e-3); without one
it exits non-zero.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.host import rosenbrock_host
from quasinewtonmethods_jl_tpu.utils.compile_cache import enable_compile_cache
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator
from quasinewtonmethods_jl_tpu.models import (
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)

DTYPE = default_dtype()
TOL = 1e-3
RNG = np.random.default_rng(20260816)


def fetch(tree):
    # ONE device->host readback: sum all leaves into a single device
    # scalar first, so each timing pays one sync. Typed PRNG-key leaves
    # (resumable sampler states carry one) are not summable — skip them.
    total = sum(
        jnp.sum(x).astype(jnp.float32)
        for x in jax.tree_util.tree_leaves(tree)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.number)
        or jnp.asarray(x).dtype == jnp.bool_
    )
    return float(total)


def timed(fn, *args, reps=3):
    out = fn(*args)
    fetch(out)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        fetch(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def emit(name, seconds, extra):
    print(json.dumps({"config": name, "seconds": round(seconds, 5), **extra}), flush=True)


def main():
    if not on_accelerator():
        print("no accelerator: this benchmark does not run on the CPU",
              file=sys.stderr, flush=True)
        sys.exit(1)
    enable_compile_cache()
    print(f"# backend={jax.default_backend()} dtype={DTYPE.__name__} tol={TOL}",
          file=sys.stderr, flush=True)

    # 1. Rosenbrock n=60 single solve (reference headline; + native C++ path)
    x0 = jnp.asarray(RNG.standard_normal(60), DTYPE)
    t, res = timed(lambda x: qnm.optimize(rosenbrock_logdensity, x, tol=TOL), x0)
    emit("rosenbrock_n60_single", t, {
        "status": int(res.status), "iterations": int(res.iterations),
        "reference_seconds": 330.8e-6,
    })
    xh = np.asarray(RNG.standard_normal(60))
    rosenbrock_host(xh)
    t0 = time.perf_counter()
    for _ in range(200):
        rh = rosenbrock_host(xh)
    emit("rosenbrock_n60_native_cpp", (time.perf_counter() - t0) / 200,
         {"status": rh.status, "iterations": rh.iterations,
          "reference_seconds": 330.8e-6})

    # 2. Ill-conditioned quadratic n=256
    modelq = IllConditionedQuadratic(256, condition=1e4, dtype=DTYPE)
    x0 = jnp.asarray(RNG.standard_normal(256), DTYPE)
    t, res = timed(lambda x: qnm.optimize(modelq, x, tol=max(TOL, 1e-4), max_iterations=5000), x0)
    emit("quadratic_n256_cond1e4", t, {"status": int(res.status),
                                       "iterations": int(res.iterations)})

    # 3. Logistic MAP n=100 (autodiff callback). f32 tol must respect the
    # value-resolution floor: with |f| ~ 233, the line search cannot certify
    # increases below eps(f32)*|f| ~ 3e-5, so grad tolerances tighter than
    # ~3e-3 stall in-band at this scale (README: f32 numerical contract).
    modell = LogisticRegressionMAP(dimension=100, n_obs=500, dtype=DTYPE)
    x0 = jnp.zeros(100, DTYPE)
    tol3 = 3e-3
    t, res = timed(lambda x: qnm.optimize(modell, x, tol=tol3), x0)
    emit("logistic_map_n100", t, {"status": int(res.status),
                                  "iterations": int(res.iterations)})

    # 4. Batched Rosenbrock fleet 4096 x n=60 (the headline)
    X = jnp.asarray(RNG.standard_normal((4096, 60)), jnp.float32)
    t, res = timed(
        lambda X: qnm.optimize_batched(rosenbrock_logdensity, X, tol=1e-3,
                                       max_iterations=3000), X)
    conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
    emit("batched_rosenbrock_4096x60", t, {
        "solves_per_sec": round(4096 / t, 1), "converged": conv,
        "target_solves_per_sec": 10000,
        "reference_solves_per_sec": round(1 / 330.8e-6, 1)})

    # 5. L-BFGS(10) n=4096
    n = 4096
    diag = jnp.asarray(np.linspace(0.2, 5.0, n), DTYPE)
    xs = jnp.asarray(RNG.standard_normal(n), DTYPE)
    f5 = lambda x: -0.5 * jnp.sum(diag * (x - xs) ** 2)
    t, res = timed(
        lambda x: qnm.optimize_lbfgs(f5, x, history=10, tol=max(TOL, 1e-5),
                                     max_iterations=500),
        jnp.zeros(n, DTYPE))
    emit("lbfgs_m10_n4096", t, {"status": int(res.status),
                                "iterations": int(res.iterations)})

    # 6. Batched L-BFGS fleets (masked-lockstep engine; circular ring for
    # n >= 192) — beyond-reference
    for b, n6 in ((1024, 512), (256, 4096)):
        X = jnp.asarray(RNG.standard_normal((b, n6)), jnp.float32)
        # unroll=2 pays only in the >= ~40 MB-ring regime (measured sweep:
        # +16%/iter at 256x4096, slower at 1024x512 — STATUS.md)
        unroll = 2 if n6 >= 2048 else 1
        t, res = timed(
            lambda X: qnm.optimize_lbfgs_batched(rosenbrock_logdensity, X,
                                                 history=10, tol=1e-3,
                                                 max_iterations=3000,
                                                 unroll=unroll), X)
        conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
        emit(f"lbfgs_fleet_{b}x{n6}", t, {
            "solves_per_sec": round(b / t, 1), "converged": conv,
            "unroll": unroll})

    # 7. Mid-size n: the fused engine's (n, n, batch) update at n = 128
    X = jnp.asarray(RNG.standard_normal((1024, 128)), jnp.float32)
    t, res = timed(
        lambda X: qnm.optimize_batched(rosenbrock_logdensity, X, tol=1e-3,
                                       max_iterations=3000, backend="fused"),
        X)
    conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
    emit("batched_rosenbrock_1024x128", t, {
        "solves_per_sec": round(1024 / t, 1), "converged": conv})

    # 8. LM least-squares fleet: 4096 per-lane exponential fits
    # (beyond-reference, round 4)
    B8, M8 = 4096, 40
    t8v = np.linspace(0.0, 1.0, M8, dtype=np.float32)
    amp = RNG.uniform(0.5, 3.0, B8).astype(np.float32)
    rate = RNG.uniform(-2.5, -0.5, B8).astype(np.float32)
    y8 = amp[:, None] * np.exp(rate[:, None] * t8v[None, :])
    data8 = (jnp.asarray(np.tile(t8v, (B8, 1))), jnp.asarray(y8))

    def resid8(p, d):
        tt, yy = d
        return p[..., 0:1] * jnp.exp(p[..., 1:2] * tt) - yy

    X8 = jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), (B8, 1))
    t, res = timed(
        lambda X: qnm.least_squares(resid8, X, data=data8, tol=1e-3), X8)
    conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
    emit("lm_expfit_fleet_4096x2", t, {
        "solves_per_sec": round(B8 / t, 1), "converged": conv})

    # 9. Trust-region fleet on the stiff quadratic (the geometry secant
    # methods cannot certify at f32 — round 4)
    N9, B9 = 256, 1024
    Q9, _ = np.linalg.qr(RNG.standard_normal((N9, N9)))
    A9 = jnp.asarray(((Q9 * np.geomspace(1.0, 1e4, N9)) @ Q9.T)
                     .astype(np.float32))
    b9 = jnp.asarray(RNG.standard_normal(N9).astype(np.float32))

    def quad9(x):
        return -0.5 * x @ (A9 @ x) + b9 @ x

    X9 = jnp.asarray(RNG.standard_normal((B9, N9)).astype(np.float32))
    t, res = timed(
        lambda X: qnm.optimize_tr(quad9, X, tol=1e-3, max_cg=256), X9)
    conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
    emit("tr_stiff_quad_1024x256", t, {
        "solves_per_sec": round(B9 / t, 1), "converged": conv})

    # 10. SVGD particle fleet (round 4): 300 Stein steps at B=4096, n=60
    A10 = RNG.standard_normal((60, 60)).astype(np.float32) * 0.3
    prec10 = jnp.asarray(np.linalg.inv(A10 @ A10.T + np.eye(60, dtype=np.float32)))

    def gauss10(x):
        return -0.5 * x @ (prec10 @ x)

    X10 = jnp.asarray((RNG.standard_normal((4096, 60)) * 2.0)
                      .astype(np.float32))
    t, res = timed(
        lambda X: qnm.svgd_sample(gauss10, X, n_steps=300), X10)
    emit("svgd_4096x60_300steps", t, {
        "particle_steps_per_sec": round(4096 * 300 / t, 1)})

    # 11. Nonlinear-CG fleets (round 4): the headline engine on the
    # 4096x60 shape plus the large-n shapes where it beats the ring
    # engines outright (r4q: 2.02x at 1024x512, 3.65x at 256x4096)
    for b11, n11 in ((4096, 60), (1024, 512), (256, 4096)):
        X11 = jnp.asarray(RNG.standard_normal((b11, n11)), DTYPE)
        t, res = timed(
            lambda X: qnm.optimize_cg(rosenbrock_logdensity, X, tol=TOL,
                                      max_iterations=6000), X11)
        emit(f"cg_fleet_{b11}x{n11}", t, {
            "solves_per_sec": round(b11 / t, 1),
            "converged": int(jnp.sum(res.status == qnm.Status.CONVERGED))})

    # 12. Gradient-free ensemble sampler (round 4): 256 draws at 4096
    # walkers, n=60 standard Gaussian
    def gauss12(x):
        return -0.5 * jnp.sum(x * x)

    X12 = jnp.asarray(RNG.standard_normal((4096, 60)), DTYPE)
    t, res = timed(
        lambda X: qnm.ensemble_sample(gauss12, jax.random.PRNGKey(0), X,
                                      n_samples=256, n_warmup=64), X12)
    emit("ensemble_4096x60_256draws", t, {
        "draws_per_sec": round(4096 * 256 / t, 1),
        "accept": round(float(res.accept_rate.mean()), 3)})

    # 13. MCLMC (round 4): the fixed-cost gradient sampler — 512 draws
    # at 4096 chains, n=60 standard Gaussian (r4u: 32.5M draws/s
    # sampling-only, 1.36x ChEES ESS/s)
    def gauss13(x):
        return -0.5 * jnp.sum(x * x)

    X13 = jnp.asarray(RNG.standard_normal((4096, 60)), DTYPE)
    t, res = timed(
        lambda X: qnm.mclmc_sample(gauss13, jax.random.PRNGKey(0), X,
                                   n_samples=512, n_warmup=256), X13)
    emit("mclmc_4096x60_512draws", t, {
        "draws_per_sec": round(4096 * 512 / t, 1),
        "energy_var": float(res.energy_var),
        "divergences": int(res.divergences.sum())})

    # 14. Constrained fleet (round 5): disk-constrained Rosenbrock n=60
    # (active sphere, whole fleet on the boundary) — the auglag fleet
    # with the CG inner engine at the chip-validated f32 contract
    def rosen14(x):
        return rosenbrock_logdensity(x)

    def disk14(x):
        return 30.0 - jnp.sum(x * x)

    X14 = jnp.asarray(RNG.standard_normal((4096, 60)).astype(np.float32))
    t, res = timed(
        lambda X: qnm.optimize_auglag(
            rosen14, X, ineq=disk14, engine="cg", tol=1e-3, ctol=1e-3,
            max_iterations=2000,
        ), X14)
    conv = int(jnp.sum(res.status == qnm.Status.CONVERGED))
    emit("auglag_disk_rosenbrock_4096x60", t, {
        "solves_per_sec": round(4096 / t, 1), "converged": conv,
        "max_viol": float(jnp.max(res.viol))})


if __name__ == "__main__":
    main()
