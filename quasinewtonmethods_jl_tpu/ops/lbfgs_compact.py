"""Compact-representation L-BFGS direction (Byrd–Nocedal–Schnabel 1994).

Algebraically identical to the two-loop recursion (ops/lbfgs.py) but shaped
for an accelerator: the two-loop's 2m *sequential* dot-product steps per direction
— ~40 dispatches per iteration for m=10, which measured as the dominant
cost of batched L-BFGS fleets — become two (m, n) matmul contractions, two
tiny (m, m) triangular solves, and a handful of elementwise ops:

    H = γI + [S, γY] M [Sᵀ; γYᵀ],   with R = triu(SᵀY), D = diag(SᵀY),
    M = [ R⁻ᵀ(D + γYᵀY)R⁻¹   −R⁻ᵀ ]
        [ −R⁻¹                0    ]

    Hg = γg + Sᵀ·top + γYᵀ·bottom, where
      a = R⁻¹(Sg),  bottom = −a,
      top = R⁻ᵀ[(D + γYᵀY)a − γ(Yg)]

Ring slots hold oldest..newest in 0..hist-1 (the lbfgs_push convention), so
R is genuinely upper triangular. Invalid slots (i >= hist) are masked
EXPLICITLY out of R, D, Sg, Yg (with unit diagonal entries keeping the
triangular solves well-posed): after a mid-run steepest-ascent reset the
driver clears only `hist`, so slots above it hold STALE nonzero pairs, not
zeros — unmasked they corrupted the post-reset directions by orders of
magnitude (regression-tested against the two-loop recursion).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = [
    "lbfgs_direction_compact",
    "lbfgs_diag_inv_hessian",
    "lbfgs_logdet_inv_hessian",
    "lbfgs_lowrank_inv_hessian",
]


def _masked_compact_setup(S, Y, hist, dtype):
    """ONE home for the stale-slot masking invariant (module docstring):
    zero the rows at slots >= hist, build the Gram pieces on the masked
    rings, and pad R/D with unit entries so the triangular solves stay
    well-posed. vmask entries are exactly 0/1, so masking inputs vs
    masking products is bitwise-identical."""
    mh = S.shape[0]
    valid = jnp.arange(mh) < hist
    vmask = valid.astype(dtype)
    Sm = S * vmask[:, None]
    Ym = Y * vmask[:, None]
    SY = Sm @ Ym.T  # (m, m): SY[i, j] = s_i' y_j, stale rows/cols zeroed
    YY = Ym @ Ym.T
    unit_invalid = 1.0 - vmask
    R = jnp.triu(SY) + jnp.diag(unit_invalid)  # unit diag on empty slots
    D = jnp.diag(SY) + unit_invalid  # (m,)
    return vmask, Sm, Ym, SY, YY, R, D


def lbfgs_direction_compact(
    S: jax.Array,  # (m, n) step history, oldest..newest in 0..hist-1
    Y: jax.Array,  # (m, n) gradient-difference history
    rho: jax.Array,  # (m,) unused (kept for signature parity with two-loop)
    hist: jax.Array,  # () int32 valid pair count
    gamma: jax.Array,  # () H0 scaling
    g: jax.Array,  # (n,) current gradient
) -> Tuple[jax.Array, jax.Array]:
    """d ≈ B⁻¹g (ascent direction) and m_dir = dᵀg — compact form."""
    dtype = g.dtype
    vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist, dtype)

    Sg = Sm @ g  # (m,)
    Yg = Ym @ g  # (m,)

    a = solve_triangular(R, Sg, lower=False)  # R⁻¹ Sᵀg
    t = D * a + gamma * (YY @ a) - gamma * Yg
    top = solve_triangular(R, t, lower=False, trans=1)  # R⁻ᵀ t
    # Hg = γg + S_colsᵀ·top + γ·Y_colsᵀ·(−a)
    d = gamma * g + S.T @ top - gamma * (Y.T @ a)
    m_dir = jnp.dot(d, g, preferred_element_type=dtype)
    return d, m_dir


def lbfgs_diag_inv_hessian(
    S: jax.Array,  # (m, n) canonical ring, oldest..newest in 0..hist-1
    Y: jax.Array,  # (m, n)
    hist: jax.Array,  # () int
    gamma: jax.Array,  # ()
) -> jax.Array:
    """diag(H) of the compact-form inverse-Hessian estimate, O(m²·n).

    From H = γI + U M Uᵀ with U = [Sᵀ, γYᵀ] and the BNS middle matrix,
    the j-th diagonal entry is a (2m)-dimensional quadratic form in
    U's j-th row:

        diag(H)_j = γ + v_jᵀ (D + γYᵀY) v_j − 2γ (v_j · Y[:, j]),
        v_j = R⁻¹ S[:, j]

    — two triangular-solve-shaped contractions, no n×n materialization.
    The use case is the large-n MAP→sampler handoff: the dense-B fleet
    hands `chain_init_from_map` a full covariance; an L-BFGS fleet can
    hand over this diagonal instead (the samplers' diag-mass form).
    Stale slots (i >= hist) are masked by the same `_masked_compact_setup`
    the direction uses — one home for the invariant.
    """
    n = S.shape[1]
    dtype = S.dtype
    _vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist, dtype)
    G = jnp.diag(D) + gamma * YY

    V = solve_triangular(R, Sm, lower=False)  # (m, n): v_j in column j
    quad = jnp.einsum("aj,ab,bj->j", V, G, V)
    cross = jnp.sum(V * Ym, axis=0)
    return gamma * jnp.ones((n,), dtype) + quad - 2.0 * gamma * cross


def lbfgs_logdet_inv_hessian(
    S: jax.Array,  # (m, n) canonical ring, oldest..newest in 0..hist-1
    Y: jax.Array,  # (m, n)
    hist: jax.Array,  # () int
    gamma: jax.Array,  # ()
) -> jax.Array:
    """log det H of the compact-form inverse-Hessian estimate in
    O(m³ + m²·n) — the determinant identity the dense-free MAP→evidence
    pipeline needs (round-2 VERDICT item 5).

    With H = γI + U M Uᵀ (U = [Sᵀ, γYᵀ], n×2m; M the BNS middle matrix),
    the matrix determinant lemma gives

        log det H = n·log γ + log det( I_2m + (1/γ)·M·(UᵀU) ),

    where UᵀU is the 2m×2m ring Gram [[SSᵀ, γSYᵀ], [γ(SYᵀ)ᵀ, γ²YYᵀ]] and
    M·(UᵀU) costs two m×m triangular solves — no n×n matrix ever forms.
    Stale slots are masked by `_masked_compact_setup` (their rows of U are
    zero, so they contribute identity rows to the 2m×2m determinant).
    Returns NaN (in-band) when the estimate is not positive definite
    (the Gaussian integral does not exist there).
    """
    n = S.shape[1]
    dtype = S.dtype
    mh = S.shape[0]
    _vmask, Sm, Ym, SY, YY, R, D = _masked_compact_setup(S, Y, hist, dtype)
    SS = Sm @ Sm.T

    # UᵀU blocks (SY[i, j] = s_i·y_j from the shared masked setup)
    UtU = jnp.block(
        [[SS, gamma * SY], [gamma * SY.T, gamma * gamma * YY]]
    )  # (2m, 2m)

    # M @ X for X = UᵀU, via the BNS block structure:
    #   top    = R⁻ᵀ[(D̂ + γYYᵀ) R⁻¹ X_top − X_bot]
    #   bottom = −R⁻¹ X_top
    X_top, X_bot = UtU[:mh], UtU[mh:]
    RinvX = solve_triangular(R, X_top, lower=False)
    G = jnp.diag(D) + gamma * YY
    top = solve_triangular(R, G @ RinvX - X_bot, lower=False, trans=1)
    MX = jnp.concatenate([top, -RinvX], axis=0)

    K = jnp.eye(2 * mh, dtype=dtype) + MX / gamma
    sign, logdet_k = jnp.linalg.slogdet(K)
    logdet = n * jnp.log(gamma) + logdet_k
    return jnp.where(sign > 0, logdet, jnp.nan)


def lbfgs_lowrank_inv_hessian(
    S: jax.Array,  # (m, n) canonical ring, oldest..newest in 0..hist-1
    Y: jax.Array,  # (m, n)
    hist: jax.Array,  # () int
    gamma: jax.Array,  # ()
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(gamma, Q, sig): the compact inverse-Hessian estimate as an exact
    spectral low-rank form

        H = γ·(I − QQᵀ) + Q·diag(sig)·Qᵀ,   Q (n, 2m) orthonormal,

    i.e. H acts as γ off the ring subspace and with eigenvalues ``sig``
    (= γ + eig of the projected middle) on it. O(m²·n + m³): QR of the
    (n, 2m) factor U = [Sᵀ, γYᵀ], then an eigendecomposition of the 2m×2m
    projected BNS middle. This is the large-n handoff that keeps the ring
    CORRELATION structure (the samplers' `LowRankMass` metric) instead of
    collapsing to diag(H); ``sig`` is clamped positive so downstream
    Cholesky-free sampling (closed-form M^±1/2 in the same basis) is
    always defined. Stale slots contribute zero columns to U (masked by
    `_masked_compact_setup`), hence γ-eigenvalues — harmless identity
    directions of the metric.
    """
    dtype = S.dtype
    mh = S.shape[0]
    _vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist, dtype)
    U = jnp.concatenate([Sm.T, gamma * Ym.T], axis=1)  # (n, 2m)
    Q, Rt = jnp.linalg.qr(U)  # Q (n, 2m), Rt (2m, 2m)

    # BNS middle M (symmetric, indefinite); projected onto the ring basis:
    # S_mid = Rt M Rtᵀ via two triangular solves against R
    G = jnp.diag(D) + gamma * YY
    Rt_top, Rt_bot = Rt[:, :mh], Rt[:, mh:]  # (2m, m) halves of Rt·[I;0],[0;I]
    A = solve_triangular(R, Rt_top.T, lower=False)  # R⁻¹ Rt_topᵀ -> (m, 2m)
    # M [X_top; X_bot] = [R⁻ᵀ(G A − X_bot); −A] per block structure
    top = solve_triangular(R, G @ A - Rt_bot.T, lower=False, trans=1)
    MX = jnp.concatenate([top, -A], axis=0)  # (2m, 2m) = M Rtᵀ
    S_mid = Rt @ MX  # (2m, 2m), symmetric up to fp noise
    S_mid = 0.5 * (S_mid + S_mid.T)
    sig_rel, P = jnp.linalg.eigh(S_mid)
    sig = jnp.maximum(gamma + sig_rel, 1e-10)  # H's on-subspace eigenvalues
    return gamma, Q @ P, sig
