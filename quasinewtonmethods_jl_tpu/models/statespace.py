"""Linear-Gaussian state-space (AR(1)-with-drift) MAP objective.

The scan-shaped log-density class (round 5): sequential likelihoods —
state-space models, AR processes, Kalman-style recursions — trace to a
`lax.scan` whose body carries a matvec. This fixture is the named
representative: estimate the drift vector w of the latent recursion

    z_t = A z_{t-1} + w,      y_t ~ N(z_t, sigma^2 I)

by MAP over w with a N(0, prior_scale^2 I) prior (A, the observations, and
sigma are fixed, seeded data). The log-posterior is strictly concave in
w (the recursion is linear in w), has a closed-form optimum via the
normal equations (used by the tests), and its traced form is a scan with
a matvec body and extensive outputs.

Reference analog: the callback protocol's "any smooth log-density"
contract (src/QuasiNewtonMethods.jl:8-9) — sequential likelihoods are a
natural member the reference never names because its CPU loops don't
care about control-flow structure; compiled accelerator code does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..api import ProbabilityModel

__all__ = ["AR1DriftMAP"]


class AR1DriftMAP(ProbabilityModel):
    """Seeded synthetic AR(1)-with-drift posterior over the drift w."""

    def __init__(
        self,
        dimension: int = 8,
        n_steps: int = 32,
        spectral_radius: float = 0.6,
        obs_scale: float = 0.5,
        prior_scale: float = 10.0,
        seed: int = 0,
        dtype=jnp.float64,
    ):
        super().__init__(dimension)
        n = dimension
        ka, kw, ke = jax.random.split(jax.random.PRNGKey(seed), 3)
        A = jax.random.normal(ka, (n, n), dtype)
        # scale to the requested spectral radius (stable recursion) —
        # on the HOST: general eig has no accelerator lowering, and this is
        # seeded constant data, not traced compute
        import numpy as _np

        eig = float(_np.max(_np.abs(_np.linalg.eigvals(
            _np.asarray(A, _np.float64)
        ))))
        self.A = A * jnp.asarray(spectral_radius / eig, dtype)
        w_true = jax.random.normal(kw, (n,), dtype)
        # simulate the latent recursion + noisy observations
        def sim(z, k):
            z1 = self.A @ z + w_true
            return z1, z1
        _, zs = jax.lax.scan(sim, jnp.zeros(n, dtype), jnp.arange(n_steps))
        noise = obs_scale * jax.random.normal(ke, (n_steps, n), dtype)
        self.ys = zs + noise
        self.obs_scale = float(obs_scale)
        self.prior_scale = float(prior_scale)
        self.w_true = w_true

    def logdensity(self, w):
        inv2s2 = 0.5 / self.obs_scale**2

        def step(z, y):
            z1 = self.A @ z + w
            return z1, -inv2s2 * jnp.sum((y - z1) ** 2)

        _, lls = jax.lax.scan(step, jnp.zeros_like(w), self.ys)
        return jnp.sum(lls) - 0.5 * jnp.sum(w * w) / self.prior_scale**2

    def map_solution(self):
        """Closed form via the normal equations: z_t = M_t w with
        M_t = sum_{j<=t} A^j, so the MAP solves
        (sum M_t'M_t / s^2 + I/p^2) w = sum M_t' y_t / s^2."""
        n = self.dimension
        T = self.ys.shape[0]
        M = jnp.zeros((n, n), self.ys.dtype)
        P = jnp.eye(n, dtype=self.ys.dtype)  # A^0
        lhs = jnp.eye(n, dtype=self.ys.dtype) / self.prior_scale**2
        rhs = jnp.zeros(n, self.ys.dtype)
        s2 = self.obs_scale**2
        for t in range(T):
            M = M + P  # M_t = I + A + ... + A^t
            lhs = lhs + (M.T @ M) / s2
            rhs = rhs + (M.T @ self.ys[t]) / s2
            P = self.A @ P
        return jnp.linalg.solve(lhs, rhs)
