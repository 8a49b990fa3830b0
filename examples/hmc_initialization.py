"""HMC chain initialization with batched BFGS MAP solves.

The reference library's stated purpose (its README): the inner
MAP/mode-finding engine for ProbabilityModels.jl + InplaceDHMC.jl — find the
posterior mode for many chains, then sample. This example shows that
workflow on an accelerator:

  1. a fleet of BFGS solves finds the MAP from many random starts at once
     (one XLA computation);
  2. the converged inverse-Hessian approximations B⁻¹ (≈ posterior
     covariance at the mode, since the objective is a log-density) seed the
     HMC mass matrix;
  3. chains start at mode + B^(1/2)-shaped jitter.

Run: python examples/hmc_initialization.py   (CPU or GPU)
"""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP

# f64 parity mode on the CPU: examples assume float64 semantics on CPU (the
# reference's native precision); jax keeps x64 off by default.
if not on_accelerator():
    jax.config.update("jax_enable_x64", True)



def main():
    n_chains = 64
    dim = 32

    dtype = default_dtype()
    tol = 1e-3 if dtype == jnp.float32 else 1e-8
    model = LogisticRegressionMAP(dimension=dim, n_obs=300, dtype=dtype)

    # 1. batched MAP: one solve per chain, all in one XLA computation
    key = jax.random.PRNGKey(0)
    starts = jax.random.normal(key, (n_chains, dim), dtype)
    res = qnm.optimize_batched(model, starts, tol=tol)
    converged = np.asarray(res.status) == qnm.Status.CONVERGED
    # In-band failure handling: a lane whose line search stalls at the
    # floating-point noise floor reports LINESEARCH_FAILURE (the reference
    # returns NaN in the same situation). Its gradient is still in the
    # result — treat near-tolerance stalls as practical convergence.
    gradmax = np.abs(np.asarray(res.grad)).max(axis=1)
    stalled_ok = (
        np.asarray(res.status) == qnm.Status.LINESEARCH_FAILURE
    ) & (gradmax < 10 * tol)
    usable = converged | stalled_ok
    print(
        f"MAP solves: {converged.sum()}/{n_chains} converged, "
        f"{stalled_ok.sum()} stalled at noise floor (usable: {usable.sum()})"
    )

    # All chains must agree on the mode (concave posterior)
    modes = np.asarray(res.x)[usable]
    spread = np.abs(modes - modes.mean(axis=0)).max()
    print(f"mode agreement across chains: max spread {spread:.2e}")

    # 2. mass matrix from the converged inverse Hessian: B⁻¹ at the mode of a
    # log-density approximates the posterior covariance. Use strictly
    # converged lanes only — a stalled lane's last update may carry NaNs
    # (that is what made it stall).
    B_inv = np.asarray(res.state.B)[converged].mean(axis=0)
    converged = usable
    evals = np.linalg.eigvalsh(B_inv)
    print(f"covariance estimate eigenvalues: [{evals.min():.3g}, {evals.max():.3g}]")

    # 3. positions for the samplers: mode + covariance-shaped jitter
    chol = np.linalg.cholesky(B_inv + 1e-9 * np.eye(dim))
    rng = np.random.default_rng(1)
    chain_starts = modes.mean(axis=0) + rng.standard_normal((n_chains, dim)) @ chol.T
    print(f"chain start positions: {chain_starts.shape}, "
          f"logdensity at mode {float(res.last_value[converged.argmax()]):.4f}")

    # 4. sample: batched preconditioned HMC (qnm.hmc_sample) — B as the
    # mass-matrix preconditioner, all chains in one jitted scan. This is
    # the full workflow the reference library was built to serve.
    hmc = qnm.hmc_sample(
        model,
        jax.random.PRNGKey(2),
        jnp.asarray(chain_starts, dtype),
        mass=jnp.asarray(B_inv, dtype),
        n_samples=300,
        n_warmup=150,
        n_leapfrog=8,
    )
    draws = np.asarray(hmc.samples).reshape(-1, dim)
    post_mean = draws.mean(axis=0)
    print(
        f"HMC: {hmc.samples.shape[0]} draws x {n_chains} chains, "
        f"mean acceptance {float(np.mean(np.asarray(hmc.accept_rate))):.2f}, "
        f"|posterior mean - MAP| max {np.abs(post_mean - modes.mean(axis=0)).max():.3f}"
    )

    # 5. alternative: ChEES-HMC (qnm.chees_sample) — trajectory length and
    # diagonal mass learned ACROSS the chain fleet (no per-chain U-turn
    # trees; the lockstep-fleet take on NUTS adaptivity). Useful when no dense
    # B is on hand or n is too big to want one.
    chees = qnm.chees_sample(
        model,
        jax.random.PRNGKey(3),
        jnp.asarray(chain_starts, dtype),
        n_samples=300,
        n_warmup=200,
    )
    cdraws = np.asarray(chees.samples).reshape(-1, dim)
    print(
        f"ChEES: adapted trajectory length {float(chees.traj_length):.3f}, "
        f"step {float(chees.step_size):.3f}, mean acceptance "
        f"{float(np.mean(np.asarray(chees.accept_rate))):.2f}, "
        f"|posterior mean - MAP| max "
        f"{np.abs(cdraws.mean(axis=0) - modes.mean(axis=0)).max():.3f}"
    )


if __name__ == "__main__":
    main()
