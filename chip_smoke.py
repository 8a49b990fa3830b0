#!/usr/bin/env python3
"""Run the library's main path once on one NVIDIA GPU and check it.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --multi   # four cards: the sharded phase only

Phases (one card):
  device  — the card's name and power limit, JAX version, flags, cache;
  bfgs    — `optimize_batched` fleets of 4096 x 60 and 32768 x 60 f32
            Rosenbrock starts at tol 1e-3, default engine and update;
  cg      — `optimize_cg` on the 4096 x 60 fleet;
  lbfgs   — `optimize_lbfgs_batched` at 1024 x 512 f32, history 10;
  f64     — `optimize` at n=60 in float64 on the device, tol 1e-8, held to
            the reference's own bars (|l*| < 2 eps, max|grad| < 1e-8);
  sample  — `map_then_sample` on a known 60-d Gaussian, 4096 chains.

Every fleet lane must report CONVERGED, and its certificate is recomputed
on the host in float64 from the analytic gradient. The last line of
standard output is one JSON object, printed only when every phase passed:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

F64_EPS = float(np.finfo(np.float64).eps)
FLEET_TOL = 1e-3
# The engine certifies max|grad| < tol with the gradient evaluated in f32.
# Recomputed in f64 at the same x, the Rosenbrock gradient differs by the
# f32 rounding of r = b - a^2 (<= 2 ulp of a^2) amplified by the 400 a
# factor: 400 * |a|^3 * 2 eps32 ~ 1e-4 for |a| <= 1.1 near the optimum.
CERT_MARGIN = 1e-4
# At the optimum the 2x2 Hessian of each Rosenbrock pair has smallest
# eigenvalue ~0.399, so max|grad| < 1.1e-3 bounds |x - 1| by ~2.8e-3;
# 1e-2 leaves room for the f32 iterate's own rounding.
X_BOUND = 1e-2

# Shapes: (lanes, n) of each fleet, chains of the sampler phase, and the
# four-card shapes. The BFGS stacks are 59 MB and 472 MB of f32.
BFGS_FLEETS = ((4096, 60), (32768, 60))
LBFGS_FLEET = (1024, 512)
SAMPLE_CHAINS = 4096
MULTI_FLEET = (16384, 60)
MULTI_N = 1 << 22


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rosenbrock_grad64(X: np.ndarray) -> np.ndarray:
    """Analytic gradient of the (negated) extended Rosenbrock, f64, per row."""
    X = np.asarray(X, np.float64)
    half = X.shape[-1] // 2
    a, b = X[..., :half], X[..., half: 2 * half]
    r = b - a * a
    ga = 400.0 * r * a + 2.0 * (1.0 - a)
    gb = -200.0 * r
    parts = [ga, gb]
    if X.shape[-1] % 2:
        parts.append(2.0 * (1.0 - X[..., -1:]))
    return np.concatenate(parts, axis=-1)


def device_phase(jax, want: int, cache_dir: str):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    log(f"jax: {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache_dir}")
    return devs


def check_fleet(name, res, qnm, t):
    status = np.asarray(res.status)
    x = np.asarray(res.x)
    n_conv = int(np.sum(status == qnm.Status.CONVERGED))
    cert = float(np.max(np.abs(rosenbrock_grad64(x))))
    err = float(np.max(np.abs(x.astype(np.float64) - 1.0)))
    log(f"{name}: {t:.2f}s (first call, compile or cache load included)  "
        f"converged {n_conv}/{status.size}  iterations max "
        f"{int(np.max(res.iterations))}"
        f"  host f64 max|grad| {cert:.3e}  max|x-1| {err:.3e}")
    check(n_conv == status.size,
          f"{name}: {status.size - n_conv} lanes not CONVERGED "
          f"(statuses {sorted(set(status.tolist()))})")
    check(cert < FLEET_TOL + CERT_MARGIN,
          f"{name}: host certificate {cert:.3e} >= {FLEET_TOL + CERT_MARGIN}")
    check(err < X_BOUND, f"{name}: max|x-1| {err:.3e} >= {X_BOUND}")


def bytes_in_use(device):
    stats = device.memory_stats()  # None on backends without allocator stats
    return None if stats is None else stats["bytes_in_use"]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    import jax

    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def fleet_phases(jax, jnp, qnm, seed: int):
    from quasinewtonmethods_jl_tpu.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )
    from quasinewtonmethods_jl_tpu.utils.device import default_fleet_backend

    rng = np.random.default_rng(seed)
    log(f"bfgs engine: backend={default_fleet_backend()} "
        "update=ops.bfgs.fused_bfgs_update_reference (XLA)")
    fleets = [jnp.asarray(rng.standard_normal(shape), jnp.float32)
              for shape in BFGS_FLEETS]
    for X in fleets:
        name = "bfgs {}x{}".format(*X.shape)
        res, t = timed(lambda: qnm.optimize_batched(
            rosenbrock_logdensity, X, tol=FLEET_TOL,
            value_and_grad_fn=rosenbrock_value_and_grad))
        check(res.x.dtype == jnp.float32, f"{name}: dtype {res.x.dtype}")
        check_fleet(name, res, qnm, t)

    X = fleets[0]
    res, t = timed(lambda: qnm.optimize_cg(
        rosenbrock_logdensity, X, tol=FLEET_TOL,
        value_and_grad_fn=rosenbrock_value_and_grad))
    check_fleet("cg {}x{}".format(*X.shape), res, qnm, t)

    X = jnp.asarray(rng.standard_normal(LBFGS_FLEET), jnp.float32)
    res, t = timed(lambda: qnm.optimize_lbfgs_batched(
        rosenbrock_logdensity, X, history=10, tol=FLEET_TOL,
        value_and_grad_fn=rosenbrock_value_and_grad))
    check_fleet("lbfgs {}x{}".format(*X.shape), res, qnm, t)


def f64_phase(jax, jnp, qnm, seed: int):
    from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity

    x0 = jnp.asarray(np.random.default_rng(seed).standard_normal(60),
                     jnp.float64)
    check(x0.dtype == jnp.float64, "x64 is off: f64 start became f32")
    # h0_scale=False: the reference's exact semantics, which its bars assume
    res, t = timed(lambda: qnm.optimize(rosenbrock_logdensity, x0,
                                        h0_scale=False))
    platform = next(iter(res.x.devices())).platform
    x = np.asarray(res.x)
    fun = float(res.fun)
    grad = float(np.max(np.abs(np.asarray(res.grad))))
    host = float(np.max(np.abs(rosenbrock_grad64(x))))
    err = float(np.max(np.abs(x - 1.0)))
    log(f"f64 n=60: {t:.2f}s  on {platform}  status {int(res.status)}  "
        f"iterations {int(res.iterations)}  |l*| {abs(fun):.3e}  "
        f"max|grad| {grad:.3e} (host {host:.3e})  max|x-1| {err:.3e}")
    check(platform == "gpu", f"f64 solve ran on {platform}")
    check(int(res.status) == qnm.Status.CONVERGED, "f64 solve not CONVERGED")
    check(abs(fun) < 2 * F64_EPS, f"|l*| {abs(fun):.3e} >= 2 eps(f64)")
    check(grad < 1e-8 and host < 1e-8, "f64 max|grad| >= 1e-8")
    # the reference suite's own x bar (tests/test_solve_rosenbrock.py)
    check(err < 1e-5, f"f64 max|x-1| {err:.3e} >= 1e-5")


def sample_phase(jax, jnp, qnm, seed: int):
    n, chains = 60, SAMPLE_CHAINS
    mu = np.linspace(-1.0, 1.0, n)
    sigma = np.linspace(0.5, 2.0, n)
    mu_j = jnp.asarray(mu, jnp.float32)
    prec_j = jnp.asarray(1.0 / sigma**2, jnp.float32)

    def logdensity(x):
        d = x - mu_j
        return -0.5 * jnp.sum(prec_j * d * d)

    out, t = timed(lambda: qnm.map_then_sample(
        logdensity, jax.random.PRNGKey(seed), jnp.zeros(n, jnp.float32),
        n_chains=chains, n_samples=200, n_warmup=200))
    d = out.diagnostics
    rhat = float(np.max(d.rhat))
    ess = float(np.min(d.ess))
    mean_err = float(np.max(np.abs(np.asarray(d.mean) - mu) / sigma))
    var_err = float(np.max(np.abs(np.asarray(d.std) ** 2 / sigma**2 - 1.0)))
    log(f"map_then_sample n=60 x {chains} chains: {t:.2f}s  R-hat max "
        f"{rhat:.4f}  ESS min {ess:.0f}  max|mean-mu|/sigma {mean_err:.4f}  "
        f"max|var/sigma^2-1| {var_err:.4f}")
    check(np.all(np.asarray(out.map_result.status) == qnm.Status.CONVERGED),
          "MAP fleet not all CONVERGED")
    check(rhat < 1.05, f"R-hat {rhat:.4f} >= 1.05")
    # 4096 chains x 200 draws; even at 1% efficiency the standard errors
    # are ~0.011 sigma (mean) and ~0.016 (variance ratio): 5x margins below
    check(mean_err < 0.05, f"pooled mean off by {mean_err:.4f} sigma")
    check(var_err < 0.08, f"pooled variance off by {var_err:.4f}")


def multi_phase(jax, jnp, qnm, seed: int):
    import quasinewtonmethods_jl_tpu.parallel as par
    from jax import lax
    from quasinewtonmethods_jl_tpu.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    devs = jax.devices()[:4]
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.standard_normal(MULTI_FLEET), jnp.float32)
    shape = "{}x{}".format(*X.shape)
    mesh = par.make_mesh({"data": 4}, devs)
    sh, t_sh = timed(lambda: par.optimize_batched_sharded(
        rosenbrock_logdensity, X, mesh, tol=FLEET_TOL,
        value_and_grad_fn=rosenbrock_value_and_grad))
    check_fleet(f"sharded bfgs {shape} (data=4)", sh, qnm, t_sh)
    for d in devs:
        log(f"  {d}: bytes_in_use {bytes_in_use(d)}")
    one, t_one = timed(lambda: qnm.optimize_batched_fused(
        rosenbrock_logdensity, jax.device_put(X, devs[0]), tol=FLEET_TOL,
        value_and_grad_fn=rosenbrock_value_and_grad))
    check_fleet(f"one-card bfgs {shape}", one, qnm, t_one)
    same = np.asarray(sh.status) == np.asarray(one.status)
    dx = float(np.max(np.abs(np.asarray(sh.x) - np.asarray(one.x))))
    log(f"data-sharded vs one card: statuses equal {int(same.sum())}/"
        f"{same.size}  max|dx| {dx:.3e}")
    check(bool(np.all(same)), "sharded and one-card statuses differ")
    check(dx < 2 * X_BOUND, f"sharded vs one-card max|dx| {dx:.3e}")

    # one separable objective, n = 2^22, parameter axis over 4 cards:
    # f(x) = -sum c_i (x_i - 1)^2 + (x_i - 1)^4 / 4, c_i in [0.5, 1.5]
    n, tol = MULTI_N, 1e-3
    n_local = n // 4

    def coef(idx):
        return 1.0 + 0.5 * jnp.sin(idx.astype(jnp.float32))

    def vag_terms(x, c):
        d = x - 1.0
        value = -jnp.sum(c * d * d + 0.25 * d**4)
        return value, -(2.0 * c * d + d**3)

    def vag_local(xl):
        off = lax.axis_index("model") * n_local
        v, g = vag_terms(xl, coef(off + jnp.arange(n_local)))
        return lax.psum(v, "model"), g

    def vag_full(x):
        return vag_terms(x, coef(jnp.arange(n)))

    x0 = jnp.asarray(rng.standard_normal(n), jnp.float32)
    mesh_m = par.make_mesh({"model": 4}, devs)
    msh, t_m = timed(lambda: par.optimize_lbfgs_sharded(
        None, x0, mesh_m, tol=tol, value_and_grad_fn=vag_local))
    for d in devs:
        log(f"  {d}: bytes_in_use {bytes_in_use(d)}")
    m1, t_1 = timed(lambda: qnm.optimize_lbfgs(
        lambda x: vag_full(x)[0], jax.device_put(x0, devs[0]), tol=tol,
        value_and_grad_fn=vag_full))
    x_sh, x_1 = np.asarray(msh.x), np.asarray(m1.x)
    dx = float(np.max(np.abs(x_sh - x_1)))
    log(f"model-sharded lbfgs n={n} (model=4): {t_m:.2f}s status "
        f"{int(msh.status)} iterations {int(msh.iterations)}; one card "
        f"{t_1:.2f}s status {int(m1.status)} iterations "
        f"{int(m1.iterations)}; max|dx| {dx:.3e}  max|x-1| "
        f"{float(np.max(np.abs(x_sh - 1.0))):.3e}")
    check(int(msh.status) == qnm.Status.CONVERGED, "model-sharded not CONVERGED")
    check(int(m1.status) == qnm.Status.CONVERGED, "one-card lbfgs not CONVERGED")
    # curvature >= 1 everywhere (2 c_i >= 1), so |x - 1| <= max|grad| < tol
    check(dx < 2 * tol, f"model-sharded vs one-card max|dx| {dx:.3e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache_dir = enable_compile_cache()
    want = 4 if args.multi else 1
    devs = device_phase(jax, want, cache_dir)
    t0 = time.perf_counter()
    if args.multi:
        multi_phase(jax, jnp, qnm, args.seed)
    else:
        fleet_phases(jax, jnp, qnm, args.seed)
        f64_phase(jax, jnp, qnm, args.seed)
        sample_phase(jax, jnp, qnm, args.seed)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
