"""Headline benchmark: batched quasi-Newton solves/sec on one accelerator.

Config 4 of BASELINE.md: 4096 independent Rosenbrock n=60 solves to the
same max|grad| < 1e-3 certificate (the HMC-chain-init workload), f32.

The HEADLINE engine is nonlinear CG (Hager–Zhang + approximate Wolfe):
CG's O(n)-state iteration avoids the (n, n, batch) inverse-Hessian
traffic entirely. The BFGS numbers are measured and emitted every run
(``bfgs_value`` / ``bfgs_single_call``) on the same protocol.

Runs on an accelerator only: without one it exits non-zero.

Baseline for vs_baseline: the reference's single-core sequential rate —
1 solve / 330.825 us (README.md:80 median) = 3022.7 solves/sec. (The
reference runs BFGS; the framework-level comparison is the WORKLOAD —
same objective, same convergence certificate — with each side free to
pick its engine. vs the same-algorithm BFGS series we are at
``bfgs_value`` / 3022.7.)

Prints exactly one JSON line on stdout; diagnostics go to stderr.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.compile_cache import enable_compile_cache
from quasinewtonmethods_jl_tpu.utils.device import on_accelerator
from quasinewtonmethods_jl_tpu.models import (
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

BATCH = 4096
N = 60
TOL = 1e-3
MAX_ITERS = 3000
REFERENCE_SOLVES_PER_SEC = 1.0 / 330.825e-6  # README.md:80


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    dev = jax.devices()[0]
    log(f"device: {dev} (platform {dev.platform}, {dev.device_kind})")
    if not on_accelerator():
        log("no accelerator: this benchmark does not run on the CPU")
        sys.exit(1)
    log(f"compile cache: {enable_compile_cache()}")

    rng = np.random.default_rng(20260816)

    # analytic value+grad for both engines: the same parity choice as the
    # reference's benchmark, whose objective supplies ∂logdensity!
    # analytically (reference README.md:34-48); measured +1-2% over AD
    def solve_bfgs(X):
        return qnm.optimize_batched_fused(
            rosenbrock_logdensity,
            X,
            tol=TOL,
            max_iterations=MAX_ITERS,
            value_and_grad_fn=rosenbrock_value_and_grad,
        )

    def solve(X):
        # the round-4 headline engine (see module docstring)
        return qnm.optimize_cg(
            rosenbrock_logdensity,
            X,
            tol=TOL,
            max_iterations=MAX_ITERS,
            value_and_grad_fn=rosenbrock_value_and_grad,
        )

    def fetch(r):
        # ONE device->host readback per call; the combined scalar still
        # forces materialization of the full result by data dependency.
        return float(jnp.sum(r.x) + jnp.sum(r.status).astype(jnp.float32))

    X = jnp.asarray(rng.standard_normal((BATCH, N)), jnp.float32)
    t0 = time.perf_counter()
    out = solve(X)
    fetch(out)
    log(f"warmup (incl. compile): {time.perf_counter() - t0:.1f}s")

    # Single-call walls first (diagnostic): each call pays its own host
    # round trip on top of device work.
    times = []
    conv = 0
    n_reps = 4
    for rep in range(n_reps):
        X = jnp.asarray(rng.standard_normal((BATCH, N)), jnp.float32)
        float(jnp.sum(X))  # materialize input before timing
        t0 = time.perf_counter()
        out = solve(X)
        fetch(out)
        times.append(time.perf_counter() - t0)
        conv = int(jnp.sum(out.status == qnm.Status.CONVERGED))
        log(
            f"rep{rep}: {times[-1]:.3f}s  converged {conv}/{BATCH}  "
            f"itmax {int(out.iterations.max())}  "
            f"max|x-1| {float(jnp.nanmax(jnp.abs(out.x - 1.0))):.2e}"
        )
    log(f"single-call best: {min(times):.3f}s -> {BATCH/min(times):.0f} solves/s")

    # Headline: SUSTAINED throughput — K distinct fleets solved
    # back-to-back with ONE readback, the shape of a production serving
    # pipeline (async dispatch overlaps the host round trip). Results
    # still fully materialize through the combined-scalar data dependency.
    K = 8
    Xs = [
        jnp.asarray(rng.standard_normal((BATCH, N)), jnp.float32)
        for _ in range(K)
    ]
    for Xi in Xs:
        float(jnp.sum(Xi))

    def chain(solve_fn):
        acc = jnp.zeros((), jnp.float32)
        convs = jnp.zeros((), jnp.int32)
        for Xi in Xs:
            r = solve_fn(Xi)
            acc = acc + jnp.sum(r.x)
            convs = convs + jnp.sum(
                (r.status == qnm.Status.CONVERGED).astype(jnp.int32)
            )
        return float(acc), int(convs)

    chain(solve)  # warm the chained dispatch path
    sus = []
    conv_k = 0
    for _ in range(3):
        t0 = time.perf_counter()
        _a, conv_k = chain(solve)
        sus.append(time.perf_counter() - t0)
    best = min(sus) / K
    solves_per_sec = BATCH / best
    conv = conv_k // K
    log(
        f"sustained: {K}x{BATCH} in {min(sus):.3f}s -> "
        f"{solves_per_sec:.0f} solves/s (conv {conv_k}/{K * BATCH})"
    )

    # BFGS series (rounds 1-3 continuity; same protocol, fewer reps)
    Xb = jnp.asarray(rng.standard_normal((BATCH, N)), jnp.float32)
    float(jnp.sum(Xb))
    t0 = time.perf_counter()
    out_b = solve_bfgs(Xb)
    fetch(out_b)
    log(f"bfgs warmup (incl. compile): {time.perf_counter() - t0:.1f}s")
    tb = []
    for _ in range(2):
        Xb = jnp.asarray(rng.standard_normal((BATCH, N)), jnp.float32)
        float(jnp.sum(Xb))
        t0 = time.perf_counter()
        fetch(solve_bfgs(Xb))
        tb.append(time.perf_counter() - t0)
    bfgs_single = BATCH / min(tb)
    chain(solve_bfgs)  # warm the chained path
    sus_b = []
    for _ in range(2):
        t0 = time.perf_counter()
        _a, conv_b = chain(solve_bfgs)
        sus_b.append(time.perf_counter() - t0)
    bfgs_sustained = K * BATCH / min(sus_b)
    log(
        f"bfgs: single {bfgs_single:.0f}/s, sustained {bfgs_sustained:.0f}/s"
        f" (conv {conv_b}/{K * BATCH})"
    )

    # Both methodologies in the one JSON line (advisor round-3): the
    # headline `value` is the sustained rate; `single_call` keeps the
    # rounds-1/2 semantics so cross-round comparisons can't conflate them.
    single_call = BATCH / min(times)
    print(
        json.dumps(
            {
                "metric": "batched_solves_per_sec_rosenbrock_n60",
                "value": round(solves_per_sec, 1),
                "unit": "solves/sec/chip",
                "vs_baseline": round(solves_per_sec / REFERENCE_SOLVES_PER_SEC, 2),
                "methodology": (
                    f"engine=cg(hz)+approx-wolfe; sustained: {K} fleets "
                    "pipelined, one readback; same max|grad|<1e-3 "
                    "certificate as the bfgs series"
                ),
                "single_call": round(single_call, 1),
                "single_call_vs_baseline": round(
                    single_call / REFERENCE_SOLVES_PER_SEC, 2
                ),
                # the same-algorithm series (fused BFGS engine)
                "bfgs_value": round(bfgs_sustained, 1),
                "bfgs_single_call": round(bfgs_single, 1),
                "bfgs_vs_baseline": round(
                    bfgs_sustained / REFERENCE_SOLVES_PER_SEC, 2
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
