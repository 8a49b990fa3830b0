"""Constrained-parameter transforms (bijectors) for log-density models.

The reference library optimizes over unconstrained R^n and delegates
constrained parameters (variances > 0, probabilities in simplices,
ordered cutpoints, ...) to its parent ecosystem — ProbabilityModels.jl
builds the unconstraining transform + log-Jacobian into the generated
``logdensity``/``∂logdensity!`` callbacks that QuasiNewtonMethods.jl
consumes (reference: src/QuasiNewtonMethods.jl:8-9 defines only the
callback protocol; README.md:14 names the ProbabilityModels.jl use case).
This module is the accelerator-native equivalent of that capability: pure,
static-shape bijections z (unconstrained) -> x (constrained) with exact
log|det J| accumulation, so every engine in this package — the scalar
driver, the batched fleets, L-BFGS, the samplers, the one-call pipeline —
runs on z while the user thinks in x.

Design rules (same as the rest of the package):

* **Static shapes, no data-dependent control flow** — every transform is
  expressible with elementwise ops + cumsum/cumprod, so it vmaps, jits,
  and shards untouched; nothing here blocks XLA fusion.
* **Maximization convention preserved**: the wrapped objective is
  ``l(forward(z)) + log|det dforward/dz|`` — the log-density of z under
  the pushforward, maximized like any other objective.
* **Analytic gradients survive wrapping**: `TransformedModel` pulls a
  user-supplied analytic gradient back through the transform with one
  ``jax.vjp`` of ``forward`` (no re-differentiation of the user model).

The transforms follow the standard (Stan-style) constructions:
exp for positivity, scaled sigmoid for intervals, log-spaced increments
for ordered vectors, stick-breaking for simplices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .api import ProbabilityModel, as_logdensity

__all__ = [
    "Transform",
    "Identity",
    "Positive",
    "Interval",
    "Ordered",
    "Simplex",
    "CorrCholesky",
    "CovCholesky",
    "BlockTransform",
    "TransformedModel",
    "transform_objective",
    "forward_draws",
    "unpack_cholesky",
    "pack_cholesky",
]


class Transform:
    """A static-shape bijection z (unconstrained) -> x (constrained).

    Subclasses define ``unconstrained_size``/``constrained_size`` (equal
    for most transforms; the simplex maps k-1 -> k) and the three maps
    below. All maps take/return flat 1-D arrays of the advertised sizes
    and are pure jnp — safe under jit/vmap/shard_map.
    """

    @property
    def unconstrained_size(self) -> int:
        raise NotImplementedError

    @property
    def constrained_size(self) -> int:
        raise NotImplementedError

    def forward(self, z: jax.Array) -> jax.Array:
        """Map unconstrained z to constrained x."""
        return self.forward_and_log_det(z)[0]

    def forward_and_log_det(self, z: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """(x, log|det dforward/dz|) in one pass — the hot-path form the
        wrapped objective uses (avoids recomputing shared subexpressions)."""
        raise NotImplementedError

    def inverse(self, x: jax.Array) -> jax.Array:
        """Map constrained x back to z (for user-supplied starts)."""
        raise NotImplementedError

    def log_det_jacobian(self, z: jax.Array) -> jax.Array:
        """log|det dforward/dz| at z."""
        return self.forward_and_log_det(z)[1]


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    """Unconstrained block (passthrough, zero log-Jacobian)."""

    size: int

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        return z, jnp.zeros((), z.dtype)

    def inverse(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class Positive(Transform):
    """Lower-bounded block: x = lo + exp(z); log|J| = sum(z).

    ``lo`` is a static Python float (default 0.0 — strictly positive
    parameters: variances, scales, rates)."""

    size: int
    lo: float = 0.0

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        return self.lo + jnp.exp(z), jnp.sum(z)

    def inverse(self, x):
        return jnp.log(x - self.lo)


@dataclasses.dataclass(frozen=True)
class Interval(Transform):
    """Bounded block: x = lo + (hi - lo) * sigmoid(z).

    log|J| = sum(log(hi-lo) + log_sigmoid(z) + log_sigmoid(-z)) — the
    numerically stable form (no catastrophic cancellation for |z| large).
    """

    size: int
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError(
                f"Interval requires hi > lo, got lo={self.lo}, hi={self.hi}"
            )

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        width = jnp.asarray(self.hi - self.lo, z.dtype)
        x = self.lo + width * jax.nn.sigmoid(z)
        ld = jnp.sum(
            jnp.log(width) + jax.nn.log_sigmoid(z) + jax.nn.log_sigmoid(-z)
        )
        return x, ld

    def inverse(self, x):
        p = (x - self.lo) / (self.hi - self.lo)
        return jnp.log(p) - jnp.log1p(-p)


@dataclasses.dataclass(frozen=True)
class Ordered(Transform):
    """Strictly increasing block (cutpoints): x_0 = z_0,
    x_i = x_{i-1} + exp(z_i); log|J| = sum(z_1..)."""

    size: int

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        x = z[:1] + jnp.concatenate(
            [jnp.zeros((1,), z.dtype), jnp.cumsum(jnp.exp(z[1:]))]
        )
        return x, jnp.sum(z[1:])

    def inverse(self, x):
        return jnp.concatenate([x[:1], jnp.log(jnp.diff(x))])


@dataclasses.dataclass(frozen=True)
class Simplex(Transform):
    """Probability simplex of ``size`` components (stick-breaking;
    unconstrained dimension is size - 1).

    Stan's construction: break fraction v_i = sigmoid(z_i - log(K-1-i)),
    x_i = v_i * (remaining stick); the offset makes z = 0 map to the
    uniform simplex. Fully vectorized — the running stick is an exclusive
    cumsum of log1m(v) in log space (no sequential scan, no cancellation).
    """

    size: int

    def __post_init__(self):
        if self.size < 2:
            raise ValueError(f"Simplex needs size >= 2, got {self.size}")

    @property
    def unconstrained_size(self) -> int:
        return self.size - 1

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        k = self.size
        offs = jnp.log(jnp.arange(k - 1, 0, -1, dtype=z.dtype))
        za = z - offs
        lv = jax.nn.log_sigmoid(za)  # log v_i
        l1mv = jax.nn.log_sigmoid(-za)  # log(1 - v_i)
        # exclusive cumulative log-remaining-stick: [0, l1mv_0, l1mv_0+l1mv_1, ...]
        lrem = jnp.concatenate([jnp.zeros((1,), z.dtype), jnp.cumsum(l1mv)])
        x = jnp.concatenate([jnp.exp(lv + lrem[:-1]), jnp.exp(lrem[-1:])])
        ld = jnp.sum(lv + l1mv + lrem[:-1])
        return x, ld

    def inverse(self, x):
        k = self.size
        offs = jnp.log(jnp.arange(k - 1, 0, -1, dtype=x.dtype))
        rem = 1.0 - jnp.concatenate(
            [jnp.zeros((1,), x.dtype), jnp.cumsum(x[:-1])]
        )[:-1]
        v = x[:-1] / rem
        return jnp.log(v) - jnp.log1p(-v) + offs


def unpack_cholesky(x: jax.Array, dim: int) -> jax.Array:
    """Unpack a row-major packed lower triangle (incl. diagonal; length
    dim*(dim+1)//2) into a (dim, dim) lower-triangular matrix. Batched
    leading axes pass through."""
    rows, cols = jnp.tril_indices(dim)
    out = jnp.zeros((*x.shape[:-1], dim, dim), x.dtype)
    return out.at[..., rows, cols].set(x)


def pack_cholesky(L: jax.Array) -> jax.Array:
    """Pack the lower triangle (incl. diagonal) of a (dim, dim) matrix into
    a flat row-major vector — the inverse of `unpack_cholesky`."""
    rows, cols = jnp.tril_indices(L.shape[-1])
    return L[..., rows, cols]


def _stable_log1m_tanh2(z: jax.Array) -> jax.Array:
    # log(1 - tanh(z)^2) without cancellation: = 2(log 2 - z - softplus(-2z))
    return 2.0 * (jnp.log(jnp.asarray(2.0, z.dtype)) - z - jax.nn.softplus(-2.0 * z))


@dataclasses.dataclass(frozen=True)
class CorrCholesky(Transform):
    """Cholesky factor of a ``dim x dim`` correlation matrix (the LKJ
    parameterization): z (dim*(dim-1)/2 canonical partial correlations,
    row-major strict lower order) -> x = packed lower triangle of L
    (row-major incl. the derived diagonal, length dim*(dim+1)/2), with
    L @ L.T a unit-diagonal positive-definite correlation matrix.

    Construction (Stan's): w_ij = tanh(z_ij); L_ij = w_ij *
    prod_{k<j} sqrt(1 - w_ik^2); L_ii closes each row to unit norm.
    The whole map is a masked (dim, dim) tanh + row-wise exclusive
    cumsum in log space — static shapes, no scan, vmap/shard-safe.
    log|det J| is over the free coordinates (the strict lower triangle
    of L; the diagonal is determined):
    sum_ij [ log(1 - w_ij^2) + (1/2) sum_{k<j} log(1 - w_ik^2) ].

    Use `unpack_cholesky(x, dim)` inside the model to get L itself.
    """

    dim: int

    def __post_init__(self):
        if self.dim < 2:
            raise ValueError(f"CorrCholesky needs dim >= 2, got {self.dim}")

    @property
    def unconstrained_size(self) -> int:
        return self.dim * (self.dim - 1) // 2

    @property
    def constrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    def _strict_rows_cols(self):
        return jnp.tril_indices(self.dim, k=-1)

    def forward_and_log_det(self, z):
        d = self.dim
        rows, cols = self._strict_rows_cols()
        Z = jnp.zeros((d, d), z.dtype).at[rows, cols].set(z)
        mask = jnp.zeros((d, d), bool).at[rows, cols].set(True)
        l1mw2 = jnp.where(mask, _stable_log1m_tanh2(Z), 0.0)
        # exclusive row cumsum: c[i, j] = sum_{k<j} l1mw2[i, k]
        c = jnp.cumsum(l1mw2, axis=1) - l1mw2
        L = jnp.where(mask, jnp.tanh(Z) * jnp.exp(0.5 * c), 0.0)
        # row closure: c at the diagonal column already sums the whole row
        diag = jnp.exp(0.5 * jnp.diagonal(c))
        L = L + jnp.diag(diag)
        ld = jnp.sum(jnp.where(mask, l1mw2 + 0.5 * c, 0.0))
        return pack_cholesky(L), ld

    def inverse(self, x):
        d = self.dim
        L = unpack_cholesky(x, d)
        # remaining stick: 1 - sum_{k<j} L_ik^2 (exclusive row cumsum)
        sq = L * L
        rem = 1.0 - (jnp.cumsum(sq, axis=1) - sq)
        w = L / jnp.sqrt(rem)
        rows, cols = self._strict_rows_cols()
        return jnp.arctanh(w[rows, cols])


@dataclasses.dataclass(frozen=True)
class CovCholesky(Transform):
    """Cholesky factor of a ``dim x dim`` covariance matrix: the diagonal
    entries of z map through exp (positivity), the strict lower triangle
    passes through. Packing order matches `CorrCholesky`/`pack_cholesky`
    (row-major lower incl. diagonal); both z and x have length
    dim*(dim+1)/2. log|det J| = sum of the diagonal z entries."""

    dim: int

    def __post_init__(self):
        if self.dim < 1:
            raise ValueError(f"CovCholesky needs dim >= 1, got {self.dim}")

    @property
    def unconstrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    @property
    def constrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    def _diag_positions(self):
        # position of (i, i) within the row-major packed lower triangle
        import numpy as _np

        i = _np.arange(self.dim)
        return jnp.asarray(i * (i + 1) // 2 + i)

    def forward_and_log_det(self, z):
        pos = self._diag_positions()
        zd = z[pos]
        x = z.at[pos].set(jnp.exp(zd))
        return x, jnp.sum(zd)

    def inverse(self, x):
        pos = self._diag_positions()
        return x.at[pos].set(jnp.log(x[pos]))


@dataclasses.dataclass(frozen=True)
class BlockTransform(Transform):
    """Concatenation of per-block transforms over one flat vector.

    ``blocks`` is a sequence of Transforms; z is the concatenation of each
    block's unconstrained slice, x of each constrained slice, log|J| the
    sum. This is the shape real models take — e.g.
    ``BlockTransform([Identity(p), Positive(1)])`` for a regression with a
    scale parameter.
    """

    blocks: Tuple[Transform, ...]

    def __init__(self, blocks: Sequence[Transform]):
        object.__setattr__(self, "blocks", tuple(blocks))
        if not self.blocks:
            raise ValueError("BlockTransform needs at least one block")

    @property
    def unconstrained_size(self) -> int:
        return sum(b.unconstrained_size for b in self.blocks)

    @property
    def constrained_size(self) -> int:
        return sum(b.constrained_size for b in self.blocks)

    def forward_and_log_det(self, z):
        xs = []
        ld = jnp.zeros((), z.dtype)
        off = 0
        for b in self.blocks:
            x_b, ld_b = b.forward_and_log_det(z[off : off + b.unconstrained_size])
            xs.append(x_b)
            ld = ld + ld_b
            off += b.unconstrained_size
        return jnp.concatenate(xs), ld

    def inverse(self, x):
        zs = []
        off = 0
        for b in self.blocks:
            zs.append(b.inverse(x[off : off + b.constrained_size]))
            off += b.constrained_size
        return jnp.concatenate(zs)


class TransformedModel(ProbabilityModel):
    """A ProbabilityModel over unconstrained z wrapping a constrained-space
    objective: logdensity(z) = l(forward(z)) + log|det J(z)|.

    Drop-in everywhere this package accepts an objective (optimize,
    fleets, samplers, map_then_sample). An analytic user gradient
    (``value_and_grad_fn`` or the object's own ``logdensity_and_gradient``)
    is pulled back through the transform with one ``jax.vjp`` of
    ``forward`` — the user model is never re-differentiated; only the
    log-Jacobian term is (cheap: elementwise/cumsum graph).
    """

    def __init__(self, obj, transform: Transform, value_and_grad_fn=None):
        super().__init__(transform.unconstrained_size)
        self._obj = obj
        self.transform = transform
        self._logdensity_x = as_logdensity(obj)
        if value_and_grad_fn is not None:
            self._vag_x = value_and_grad_fn
        elif hasattr(obj, "logdensity_and_gradient"):
            self._vag_x = obj.logdensity_and_gradient
        else:
            self._vag_x = None

    def logdensity(self, z: jax.Array) -> jax.Array:
        x, ld = self.transform.forward_and_log_det(z)
        return self._logdensity_x(x) + ld

    def logdensity_and_gradient(self, z: jax.Array):
        if self._vag_x is None:
            return jax.value_and_grad(self.logdensity)(z)
        x, vjp_fwd = jax.vjp(self.transform.forward, z)
        val_x, grad_x = self._vag_x(x)
        ld, grad_ld = jax.value_and_grad(self.transform.log_det_jacobian)(z)
        return val_x + ld, vjp_fwd(grad_x)[0] + grad_ld

    def constrain(self, z: jax.Array) -> jax.Array:
        """Map a z-space iterate/draw (or a batch of them) to x-space."""
        return forward_draws(self.transform, z)

    def unconstrain(self, x: jax.Array) -> jax.Array:
        """Map x-space points (or batches) to z-space starts."""
        if x.ndim == 1:
            return self.transform.inverse(x)
        flat = x.reshape(-1, x.shape[-1])
        z = jax.vmap(self.transform.inverse)(flat)
        return z.reshape(*x.shape[:-1], self.transform.unconstrained_size)


def transform_objective(obj, transform: Transform, value_and_grad_fn=None):
    """Wrap a constrained-space objective into a `TransformedModel` over
    unconstrained z. See the module docstring for conventions."""
    return TransformedModel(obj, transform, value_and_grad_fn=value_and_grad_fn)


def forward_draws(transform: Transform, z: jax.Array) -> jax.Array:
    """Apply ``transform.forward`` over the last axis of ``z`` with any
    number of leading batch axes ((draws, chains, n_z) -> (..., n_x))."""
    if z.ndim == 1:
        return transform.forward(z)
    flat = z.reshape(-1, z.shape[-1])
    x = jax.vmap(transform.forward)(flat)
    return x.reshape(*z.shape[:-1], transform.constrained_size)
