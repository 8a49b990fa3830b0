"""Production fleet pattern: preemption-safe batched MAP serving.

The deployment shape the framework is built for: a service receives
batches of MAP problems (here: posterior modes for incoming model fits),
runs them as one lockstep fleet on the accelerator, survives preemption
via checkpoints, and spreads over every available chip with a data-parallel
mesh. Everything below runs unmodified from 1 CPU to a multi-GPU host —
only the mesh size changes.

Run: python examples/production_fleet.py   (CPU or GPU)
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP
from quasinewtonmethods_jl_tpu.parallel import (
    distributed as dist,
    make_mesh,
    optimize_batched_sharded,
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
    tol = 3e-3 if on_accel else 1e-8
    say = lambda *a: print(*a, flush=True)

    # 0. multi-host init (no-op on a single host) + data-parallel mesh over
    #    every local device; on a multi-host cluster, every device of it.
    dist.initialize()
    n_dev = len(jax.devices())
    mesh = make_mesh({"data": n_dev})
    say(f"devices: {n_dev} x {jax.devices()[0].platform}, mesh {mesh.shape}")

    # 1. an incoming batch of MAP problems (one shared model, many starts —
    #    the HMC-init/serving pattern); batch divides over the mesh
    model = LogisticRegressionMAP(dimension=24, n_obs=400, dtype=dtype)
    batch = 16 * n_dev
    starts = jax.random.normal(jax.random.PRNGKey(0), (batch, 24), dtype)

    # 2. first serving leg — run a bounded number of iterations per leg so
    #    the service can checkpoint between legs (preemption safety)
    leg = optimize_batched_sharded(
        model, starts, mesh, tol=tol, max_iterations=8
    )
    say(f"leg 1: {solve_stats(leg)}")

    # 3. "preemption": persist the fleet state, lose the process state,
    #    restore, and continue — a resumed lane CONTINUES its BFGS
    #    trajectory (no restart), so chunked serving equals one long solve
    with tempfile.TemporaryDirectory() as d:
        ckpt = f"{d}/fleet"
        save_state(ckpt, leg.state)
        restored = load_state(ckpt, qnm.BFGSState)
    final = qnm.optimize_batched_fused_from_state(
        model, restored, tol=tol
    )
    say(f"resumed to completion: {solve_stats(final)}")

    # 4. serving-quality acceptance: strictly converged, or stalled at the
    #    fp noise floor with a near-tolerance gradient (usable mode)
    usable = practically_converged(final, tol)
    assert bool(np.all(usable)), "some lanes are unusable"
    modes = np.asarray(final.x)[np.asarray(usable)]
    spread = float(np.abs(modes - modes.mean(axis=0)).max())
    say(f"{int(np.sum(usable))}/{batch} usable modes, max spread {spread:.2e}")
    assert spread < 1e-2  # concave MAP: every chain at the same mode

    say("production fleet pattern complete")


if __name__ == "__main__":
    main()
