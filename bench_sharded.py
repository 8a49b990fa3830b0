"""Multi-chip data-parallel scaling harness.

Measures solve-fleet throughput vs mesh size for `optimize_batched_sharded`
(batch axis over the 'data' mesh axis; the only cross-device traffic is the
while-loop predicate's all-reduce), on every accelerator one process sees.
Without an accelerator it exits non-zero.

Usage:
    python bench_sharded.py [--per-device 256] [--n 32]

Prints one JSON line per mesh size:
    {"mesh": k, "batch": B, "seconds": t, "solves_per_sec": r,
     "per_device_batch": B/k, "platform": ..., "weak_efficiency": e}
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu.parallel import make_mesh, optimize_batched_sharded
from quasinewtonmethods_jl_tpu.utils.compile_cache import enable_compile_cache
from quasinewtonmethods_jl_tpu.utils.device import on_accelerator


def time_fleet(mesh, X, reps=3):
    def run():
        res = optimize_batched_sharded(
            rosenbrock_logdensity, X, mesh, tol=1e-3, max_iterations=2000,
        )
        # one host readback that depends on the whole result
        return float(jnp.sum(res.x)) + int(jnp.sum(res.status))

    run()  # compile
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=256,
                    help="weak-scaling batch per device")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if not on_accelerator():
        print("no accelerator: this benchmark does not run on the CPU",
              file=sys.stderr, flush=True)
        sys.exit(1)
    enable_compile_cache()
    n_dev = len(jax.devices())
    platform = jax.devices()[0].platform
    print(f"# {n_dev} x {platform} devices", file=sys.stderr, flush=True)
    rng = np.random.default_rng(20260816)

    sizes = [k for k in (1, 2, 4, 8, 16, 32) if k <= n_dev]
    base_rate = None
    for k in sizes:
        mesh = make_mesh({"data": k}, devices=jax.devices()[:k])
        batch = args.per_device * k  # weak scaling: fixed work per device
        X = jnp.asarray(rng.standard_normal((batch, args.n)), jnp.float32)
        t = time_fleet(mesh, X, args.reps)
        rate = batch / t
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "mesh": k,
            "batch": batch,
            "per_device_batch": args.per_device,
            "n": args.n,
            "seconds": round(t, 4),
            "solves_per_sec": round(rate, 1),
            "weak_efficiency": round(rate / (base_rate * k), 3),
            "platform": platform,
        }), flush=True)


if __name__ == "__main__":
    main()
