"""Natively-batched L-BFGS driver — masked lockstep fleets.

Why this exists: `jax.vmap` of the scalar L-BFGS driver pays for
finished lanes on every outer iteration even though the per-lane
math is trivial — under vmap, the discarded branch of an already-finished
lane still participates in every nested `lax.while_loop`'s trip count, so a
few frozen lanes running garbage line searches drag all 4096 lanes through
hundreds of sequential lockstep rounds per iteration. The fused BFGS driver
(batched_solve.py) solved this with explicit lane masks; this module does
the same for L-BFGS:

  * explicit `active` masks everywhere — frozen lanes take no line-search
    rounds and are never updated;
  * the compact (Byrd–Nocedal–Schnabel) direction batched as einsums +
    batched (m, m) triangular solves — no per-lane sequential recursion;
  * the history-ring push vectorized with one-hot writes — no scatters;
  * shares the masked line searches, stall detector, and Status contract
    with the fused BFGS engine.

Layout: lane-minor like the BFGS engine — X/G/STEP are (n, batch), the
history rings are (m, n, batch), per-lane scalars are (batch,).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

# Precision policy. jnp.einsum lowers to dot_general, whose default f32
# precision on an accelerator may be reduced (TF32 on a GPU). Two classes
# of contractions here:
#   * the BIG Gram/direction contractions (SY/YY/Sg/Yg/d, O(m n batch)) —
#     matmul-bound: HIGHEST costs wall time at large n. Unlike the BFGS
#     stacked matvec (where reduced-precision noise
#     compounds in the persistent B state and measurably cost lanes their
#     convergence), these are recomputed fresh from exact S/Y every
#     iteration and the line search still guards ascent — measured full
#     convergence at f32 tol=1e-3 on all benchmark fleets at default
#     precision. Configurable via ``gram_precision`` for ill-conditioned
#     f32 fleets.
#   * the SMALL one-hot rotation einsums (O(m^2 batch)) and the state
#     export — pinned HIGHEST always: they are effectively permutations/
#     copies, bf16 would truncate the copied VALUES, and their cost is
#     negligible.
_HI = jax.lax.Precision.HIGHEST

from .api import as_value_and_grad, as_value_fn
from .batched_solve import _batched_linesearch, _batched_wolfe
from .lbfgs_solve import LBFGSResult
from .ops.linesearch import BackTracking
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT
from .state import LBFGSState, Status

__all__ = [
    "optimize_lbfgs_batched_fused",
    "optimize_lbfgs_batched_fused_from_state",
]


class _LCarry(NamedTuple):
    X: jax.Array  # (n, batch)
    G: jax.Array  # (n, batch)
    G_old: jax.Array  # (n, batch)
    STEP: jax.Array  # (n, batch)
    S: jax.Array  # (m, n, batch) CIRCULAR ring (per-lane head, no shifts)
    Y: jax.Array  # (m, n, batch)
    SY: jax.Array  # (m, m, batch) incremental Gram S_i·Y_j (circular mode;
    #                (1, 1, 1) dummy in shift mode — see _batched_push_incr)
    YY: jax.Array  # (m, m, batch) incremental Gram Y_i·Y_j (same)
    rho: jax.Array  # (m, batch)
    hist: jax.Array  # (batch,) int32 valid-pair count
    head: jax.Array  # (batch,) int32 next write slot
    gamma: jax.Array  # (batch,)
    fun: jax.Array  # (batch,)
    k: jax.Array  # ()
    status: jax.Array  # (batch,) int32
    iterations: jax.Array  # (batch,) int32
    n_fev: jax.Array
    n_gev: jax.Array
    n_resets: jax.Array
    stall: jax.Array


def _batched_push_shift(S, Y, rho, hist, gamma, step, y, active):
    """Vectorized cautious SHIFT-ring push (per-lane semantics of
    ops.lbfgs.lbfgs_push; ring stays in canonical time order). Costs 4+
    full-ring materializations per iteration, but for SMALL rings
    (small m*n*batch) those are cheap while the circular variant's
    extra per-iteration rotation kernels are not — the engine dispatches
    on ring size (see _RING_CIRCULAR_MIN_N)."""
    mh = S.shape[0]
    dtype = S.dtype
    sty = jnp.sum(step * y, axis=0)  # (batch,)
    yty = jnp.sum(y * y, axis=0)
    accept = (sty > 0.0) & active  # (batch,)
    full = hist >= mh

    ids = jnp.arange(mh)  # (m,)
    write_at = jnp.minimum(hist, mh - 1)  # (batch,)
    onehot = ids[:, None] == write_at[None, :]  # (m, batch)

    S_shift = jnp.concatenate([S[1:], step[None]], axis=0)
    Y_shift = jnp.concatenate([Y[1:], y[None]], axis=0)
    rho_shift = jnp.concatenate([rho[1:], (1.0 / sty)[None]], axis=0)
    S_app = jnp.where(onehot[:, None, :], step[None], S)
    Y_app = jnp.where(onehot[:, None, :], y[None], Y)
    rho_app = jnp.where(onehot, 1.0 / sty, rho)

    fullb = full[None, None, :]
    S_new = jnp.where(fullb, S_shift, S_app)
    Y_new = jnp.where(fullb, Y_shift, Y_app)
    rho_new = jnp.where(full[None, :], rho_shift, rho_app)

    acc_m = accept[None, None, :]
    S_out = jnp.where(acc_m, S_new, S)
    Y_out = jnp.where(acc_m, Y_new, Y)
    rho_out = jnp.where(accept[None, :], rho_new, rho)
    hist_out = jnp.where(accept, jnp.minimum(hist + 1, mh), hist)
    gamma_out = jnp.where(accept, sty / yty, gamma).astype(dtype)
    return S_out, Y_out, rho_out, hist_out, gamma_out


def _batched_compact_direction_shift(S, Y, hist, gamma, g, prec=None):
    """Batched BNS compact direction over the canonical shift ring."""
    mh, n, batch = S.shape
    dtype = g.dtype

    SY = jnp.einsum("inb,jnb->ijb", S, Y, precision=prec)  # (m, m, batch)
    YY = jnp.einsum("inb,jnb->ijb", Y, Y, precision=prec)
    ids = jnp.arange(mh)
    valid = ids[:, None] < hist[None, :]  # (m, batch)
    inval = (~valid).astype(dtype)

    triu = jnp.triu(jnp.ones((mh, mh), dtype))[:, :, None]
    eye = jnp.eye(mh, dtype=dtype)[:, :, None]
    R = SY * triu + eye * inval[:, None, :]  # unit diag on empty slots
    D = jnp.einsum("iib->ib", SY) + inval  # (m, batch)

    Sg = jnp.einsum("inb,nb->ib", S, g, precision=prec)  # (m, batch)
    Yg = jnp.einsum("inb,nb->ib", Y, g, precision=prec)

    Rb = jnp.transpose(R, (2, 0, 1))  # (batch, m, m)
    a = solve_triangular(Rb, Sg.T[..., None], lower=False)[..., 0].T  # (m, batch)
    t = D * a + gamma[None, :] * jnp.einsum("ijb,jb->ib", YY, a, precision=prec) - gamma[None, :] * Yg
    top = solve_triangular(Rb, t.T[..., None], lower=False, trans=1)[..., 0].T

    d = (
        gamma[None, :] * g
        + jnp.einsum("inb,ib->nb", S, top, precision=prec)
        - gamma[None, :] * jnp.einsum("inb,ib->nb", Y, a, precision=prec)
    )
    m_dir = jnp.sum(d * g, axis=0)
    return d, m_dir


def _batched_push_circular(S, Y, rho, hist, head, gamma, step, y, active):
    """Vectorized cautious CIRCULAR ring push (per-lane content identical to
    ops.lbfgs.lbfgs_push, stored rotated). The round-1 shift ring cost 4+
    full ring materializations per iteration (slice/concat/select
    chains); a
    circular ring with per-lane heads is ONE masked write per ring (1 read
    + 1 write, the XLA-visible minimum). Time order lives in (head, hist)
    and is applied to the SMALL (m, m)/(m,) tensors only (see
    `_batched_compact_direction`)."""
    mh = S.shape[0]
    dtype = S.dtype
    sty = jnp.sum(step * y, axis=0)  # (batch,)
    yty = jnp.sum(y * y, axis=0)
    accept = (sty > 0.0) & active  # (batch,)

    ids = jnp.arange(mh)  # (m,)
    onehot = (ids[:, None] == head[None, :]) & accept[None, :]  # (m, batch)

    S_out = jnp.where(onehot[:, None, :], step[None], S)
    Y_out = jnp.where(onehot[:, None, :], y[None], Y)
    rho_out = jnp.where(onehot, 1.0 / sty, rho)
    head_out = jnp.where(accept, (head + 1) % mh, head)
    hist_out = jnp.where(accept, jnp.minimum(hist + 1, mh), hist)
    gamma_out = jnp.where(accept, sty / yty, gamma).astype(dtype)
    return S_out, Y_out, rho_out, hist_out, head_out, gamma_out


def _batched_push_incr(S, Y, rho, hist, head, gamma, SY, YY, step, y, g,
                       active, prec=None):
    """Circular push + INCREMENTAL Gram maintenance — the bandwidth-minimal
    form of the large-n iteration.

    The full-recompute path (`_batched_compact_direction`) reads both rings
    ~3 extra times per iteration to rebuild SY/YY from scratch, but a ring
    push only changes ONE slot: row h and column h of each Gram matrix.
    This function carries SY[i,j] = S_i·Y_j and YY[i,j] = Y_i·Y_j in the
    loop state (slot order; stale slots hold garbage that the direction's
    validity mask already ignores) and computes the changed row/column from
    the SAME two stacked contractions that produce Sg/Yg — so the whole
    Gram + gradient-dot phase costs exactly one read of each ring:

        RA = S_out · [g, y]        (Sg and the SY column S_i·y_new)
        RB = Y_out · [g, step, y]  (Yg, the SY row s_new·Y_j, and the YY
                                    row/column Y_j·y_new)

    Per-iteration ring passes drop from ~7 to ~5 (push write x2, these two
    reads, and the two d-contraction reads), which is the XLA-visible floor
    without a fused Gram kernel. Numerics: each Gram entry is computed
    ONCE, at push time,
    from the exact pair — identical values to the recompute path at
    HIGHEST precision, and strictly less re-rounding at reduced default
    precision (regression-tested against the recompute oracle)."""
    mh = S.shape[0]
    # the ring push itself is _batched_push_circular verbatim (ONE home for
    # the cautious-push invariant); only accept/onehot are re-derived here
    # for the Gram row/column writes — XLA CSEs the repeated sty reduction
    S_out, Y_out, rho_out, hist_out, head_out, gamma_out = (
        _batched_push_circular(S, Y, rho, hist, head, gamma, step, y, active)
    )
    sty = jnp.sum(step * y, axis=0)  # (batch,)
    accept = (sty > 0.0) & active  # (batch,)
    ids = jnp.arange(mh)  # (m,)
    onehot = (ids[:, None] == head[None, :]) & accept[None, :]  # (m, batch)

    # one read of each ring for ALL Gram/gradient dots of this iteration
    RA = jnp.einsum(
        "pnb,rnb->prb", S_out, jnp.stack([g, y]), precision=prec
    )  # (m, 2, batch)
    RB = jnp.einsum(
        "pnb,rnb->prb", Y_out, jnp.stack([g, step, y]), precision=prec
    )  # (m, 3, batch)
    Sg, Sy_new = RA[:, 0], RA[:, 1]
    Yg, Ys_new, Yy_new = RB[:, 0], RB[:, 1], RB[:, 2]

    # SY[i, j] = S_i·Y_j: column h gets S_out·y_new, row h gets s_new·Y_out
    # (the (h, h) corner is sᵀy via either — both writes agree).
    col = onehot[None, :, :]  # j == h
    row = onehot[:, None, :]  # i == h
    SY_out = jnp.where(row, Ys_new[None, :, :],
                       jnp.where(col, Sy_new[:, None, :], SY))
    YY_out = jnp.where(row, Yy_new[None, :, :],
                       jnp.where(col, Yy_new[:, None, :], YY))
    return (S_out, Y_out, rho_out, hist_out, head_out, gamma_out,
            SY_out, YY_out, Sg, Yg)


def _time_order_idx(head, hist, mh):
    """(m, batch) slot index for each time position t (t = 0 oldest valid,
    t = hist-1 newest; t >= hist walks the stale slots): a per-lane
    rotation slot(t) = (t + head - hist) mod m."""
    t = jnp.arange(mh)[:, None]
    return (t + head[None, :] - hist[None, :]) % mh


def _time_order_perm(head, hist, mh, dtype):
    """One-hot rotation matrix P (time, slot, batch): P[t, p, b] = 1 iff
    slot p holds time position t for lane b. Rotations are applied as tiny
    einsum contractions with P instead of take_along_axis — per-lane
    gathers can lower to serialized gather kernels, while the one-hot
    contraction is plain elementwise work on (m, m, batch) tensors."""
    idx = _time_order_idx(head, hist, mh)  # (m, batch)
    return (idx[:, None, :] == jnp.arange(mh)[None, :, None]).astype(dtype)


def _batched_compact_direction(S, Y, hist, head, gamma, g, prec=None):
    """Batched BNS compact direction over the circular ring (per-lane
    semantics of ops.lbfgs_compact.lbfgs_direction_compact).

    The O(m·n·batch) contractions (SY, YY, Sg, Yg, and the final d) run on
    the RAW rings — contraction results are permutation-covariant, so the
    time ordering the triangular structure needs is applied as a per-lane
    rotation of the (m, m, batch)/(m, batch) SMALLS (take_along_axis
    gathers, ~m^2 per lane), and the solved coefficients rotate back
    before the d contraction. Unlike the shift ring (where stale slots
    were guaranteed zero), stale circular slots hold old pairs, so
    validity is masked explicitly."""
    SY = jnp.einsum("inb,jnb->ijb", S, Y, precision=prec)  # (m, m, batch)
    YY = jnp.einsum("inb,jnb->ijb", Y, Y, precision=prec)
    Sg = jnp.einsum("inb,nb->ib", S, g, precision=prec)  # (m, batch)
    Yg = jnp.einsum("inb,nb->ib", Y, g, precision=prec)
    return _compact_direction_from_grams(
        SY, YY, Sg, Yg, S, Y, hist, head, gamma, g, prec
    )


def _compact_direction_from_grams(SY, YY, Sg, Yg, S, Y, hist, head, gamma,
                                  g, prec=None):
    """BNS compact direction given slot-order Grams (incremental or
    recomputed) — the shared tail of both circular paths."""
    mh = S.shape[0]
    dtype = g.dtype

    P = _time_order_perm(head, hist, mh, dtype)  # (m_time, m_slot, batch)
    SY_t = jnp.einsum("tpb,pqb,uqb->tub", P, SY, P, precision=_HI)
    YY_t = jnp.einsum("tpb,pqb,uqb->tub", P, YY, P, precision=_HI)
    Sg_t = jnp.einsum("tpb,pb->tb", P, Sg, precision=_HI)
    Yg_t = jnp.einsum("tpb,pb->tb", P, Yg, precision=_HI)

    ids = jnp.arange(mh)
    valid = ids[:, None] < hist[None, :]  # (m, batch) in TIME order
    vmask2 = (valid[:, None, :] & valid[None, :, :]).astype(dtype)
    inval = (~valid).astype(dtype)

    triu = jnp.triu(jnp.ones((mh, mh), dtype))[:, :, None]
    eye = jnp.eye(mh, dtype=dtype)[:, :, None]
    R = SY_t * triu * vmask2 + eye * inval[:, None, :]  # unit diag on stale
    D = jnp.einsum("iib->ib", SY_t) * valid + inval  # (m, batch)
    Sg_t = Sg_t * valid
    Yg_t = Yg_t * valid

    Rb = jnp.transpose(R, (2, 0, 1))  # (batch, m, m)
    a = solve_triangular(Rb, Sg_t.T[..., None], lower=False)[..., 0].T
    t = (
        D * a
        + gamma[None, :] * jnp.einsum("ijb,jb->ib", YY_t * vmask2, a, precision=prec)
        - gamma[None, :] * Yg_t
    )
    top = solve_triangular(Rb, t.T[..., None], lower=False, trans=1)[..., 0].T

    # coefficients back to slot order for the raw-ring contraction
    # (P is a permutation: its transpose is its inverse)
    a_s = jnp.einsum("tpb,tb->pb", P, a, precision=_HI)
    top_s = jnp.einsum("tpb,tb->pb", P, top, precision=_HI)

    d = (
        gamma[None, :] * g
        + jnp.einsum("inb,ib->nb", S, top_s, precision=prec)
        - gamma[None, :] * jnp.einsum("inb,ib->nb", Y, a_s, precision=prec)
    )
    m_dir = jnp.sum(d * g, axis=0)
    return d, m_dir


# Ring-implementation dispatch (trace-time, on n): the circular ring's
# one-masked-write push wins once the rings are big enough that HBM
# traffic dominates; below that the shift ring's canonical order avoids
# the circular variant's extra per-iteration rotation kernels (the loop is
# launch-bound there). The crossover n is a tuning constant to re-measure
# on each device.
_RING_CIRCULAR_MIN_N = 192

# The circular path's Gram strategy is the static ``incremental_gram``
# kwarg (True = incremental SY/YY carry, False = full recompute every
# iteration — a jit static arg, NOT a module global, per the CLAUDE.md
# trace-cache rule). The incremental carry saves ~3 ring passes per
# iteration, which pays only where ring bandwidth, not per-launch dispatch,
# bounds the iteration. Default False = the simpler recompute path; the
# incremental path is kept, tested
# (test_incremental_gram_matches_recompute), and selectable for runtimes
# where memory bandwidth binds.


def _lbfgs_loop_batched(
    vag_b, f_b, carry0: _LCarry, ls, tol, max_iterations: int,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    circular: bool = True,
    gram_precision=None,
    unroll: int = 1,
    incremental_gram: bool = False,
) -> _LCarry:
    dtype = carry0.X.dtype
    tol = jnp.asarray(tol, dtype)

    def cond(c: _LCarry):
        return jnp.logical_and(
            c.k < max_iterations, jnp.any(c.status == Status.RUNNING)
        )

    def body(c: _LCarry):
        f0, g = vag_b(c.X)
        # k < max_iterations keeps the cap exact under unroll > 1 (chained
        # bodies past the cap are full no-ops — every carry write below is
        # active-masked); free for unroll == 1 where cond guarantees it
        was_active = (c.status == Status.RUNNING) & (c.k < max_iterations)
        nonfinite = ~jnp.isfinite(f0)
        converged = jnp.max(jnp.abs(g), axis=0) < tol
        improved = jnp.where(jnp.isnan(c.fun), True, f0 > c.fun)
        stall = jnp.where(
            was_active & ~improved, c.stall + 1, jnp.zeros_like(c.stall)
        )
        stall = jnp.where(was_active, stall, c.stall)
        stalled = (
            stall >= stall_limit if stall_limit else jnp.zeros_like(was_active)
        )
        status_pre = jnp.where(
            was_active,
            jnp.where(
                nonfinite,
                jnp.int32(Status.NONFINITE_VALUE),
                jnp.where(
                    converged,
                    jnp.int32(Status.CONVERGED),
                    jnp.where(
                        stalled,
                        jnp.int32(Status.LINESEARCH_FAILURE),
                        jnp.int32(Status.RUNNING),
                    ),
                ),
            ),
            c.status,
        )
        # & was_active: see the BFGS engine — keeps trailing unroll bodies
        # past the iteration cap full no-ops for still-RUNNING lanes
        active = (status_pre == Status.RUNNING) & was_active

        y_pair = c.G_old - g
        if circular and incremental_gram:
            (S, Y, rho, hist, head, gamma, SY, YY, Sg, Yg) = (
                _batched_push_incr(
                    c.S, c.Y, c.rho, c.hist, c.head, c.gamma, c.SY, c.YY,
                    c.STEP, y_pair, g, active, gram_precision,
                )
            )
            d, m = _compact_direction_from_grams(
                SY, YY, Sg, Yg, S, Y, hist, head, gamma, g, gram_precision
            )
        elif circular:
            S, Y, rho, hist, head, gamma = _batched_push_circular(
                c.S, c.Y, c.rho, c.hist, c.head, c.gamma, c.STEP, y_pair,
                active,
            )
            SY, YY = c.SY, c.YY  # carried untouched in recompute mode
            d, m = _batched_compact_direction(S, Y, hist, head, gamma, g,
                                              gram_precision)
        else:
            S, Y, rho, hist, gamma = _batched_push_shift(
                c.S, c.Y, c.rho, c.hist, c.gamma, c.STEP, y_pair, active
            )
            head = c.head  # unused in shift mode
            SY, YY = c.SY, c.YY  # dummies in shift mode
            d, m = _batched_compact_direction_shift(S, Y, hist, gamma, g,
                                                    gram_precision)

        # reset: clear history, steepest ascent (per-lane)
        gg = jnp.sum(g * g, axis=0)
        reset = (m <= 0.0) & active
        d = jnp.where(active[None, :], jnp.where(reset[None, :], g, d), 0.0)
        m = jnp.where(active, jnp.where(reset, gg, m), jnp.ones_like(m))
        hist = jnp.where(reset, jnp.zeros_like(hist), hist)
        gamma = jnp.where(reset, jnp.ones_like(gamma), gamma)

        from .ops.wolfe import Wolfe

        if isinstance(ls, Wolfe):

            def phi_vag(alpha):
                fv, gv = vag_b(c.X + alpha[None, :] * d)
                return fv, jnp.sum(gv * d, axis=0), gv

            alpha, ls_fev, _it, ls_failed, _f_acc, _G_acc = _batched_wolfe(
                phi_vag, f0, m, active, ls, dtype
            )
            ls_gev = ls_fev
        else:

            def phi(alpha):
                return f_b(c.X + alpha[None, :] * d)

            alpha, ls_fev, _it, ls_failed = _batched_linesearch(
                phi, f0, m, active, ls, dtype
            )
            ls_gev = jnp.zeros_like(ls_fev)

        take = (active & ~ls_failed)[None, :]
        step = jnp.where(take, alpha[None, :] * d, jnp.zeros_like(d))
        new_status = jnp.where(
            active & ls_failed, jnp.int32(Status.LINESEARCH_FAILURE), status_pre
        )
        wmask = was_active[None, :]
        amask = active[None, :]
        return _LCarry(
            X=c.X + step,
            G=jnp.where(wmask, g, c.G),
            G_old=jnp.where(amask, g, c.G_old),
            STEP=jnp.where(amask, step, c.STEP),
            S=S,
            Y=Y,
            SY=SY,
            YY=YY,
            rho=rho,
            hist=hist,
            head=head,
            gamma=gamma,
            fun=jnp.where(was_active, f0, c.fun),
            k=c.k + 1,
            status=new_status,
            iterations=c.iterations + active.astype(jnp.int32),
            n_fev=c.n_fev + was_active.astype(jnp.int32) + ls_fev,
            n_gev=c.n_gev + was_active.astype(jnp.int32) + ls_gev,
            n_resets=c.n_resets + reset.astype(jnp.int32),
            stall=stall,
        )

    if unroll > 1:
        # amortize the per-while-step control cost (same rationale +
        # no-op-body proof as the BFGS engine's unroll)
        def chain(c):
            for _ in range(unroll):
                c = body(c)
            return c

        final = lax.while_loop(cond, chain, carry0)
    else:
        final = lax.while_loop(cond, body, carry0)
    return final._replace(
        status=jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.MAX_ITERATIONS),
            final.status,
        )
    )


def _fresh_lbfgs_carry(X, history, status0, circular, incremental_gram):
    """Fresh L-BFGS fleet carry for a (n, batch) lane-minor fleet (the
    single source of the carry layout — engine jit and the constrained
    fleet's inner solves both build here; review finding, round 5)."""
    n, batch = X.shape
    dtype = X.dtype
    gram_shape = (
        (history, history, batch)
        if circular and incremental_gram
        else (1, 1, 1)
    )
    zero_v = jnp.zeros((n, batch), dtype)
    zero_i = jnp.zeros((batch,), jnp.int32)
    return _LCarry(
        X=X,
        G=zero_v,
        G_old=zero_v,
        STEP=zero_v,
        S=jnp.zeros((history, n, batch), dtype),
        Y=jnp.zeros((history, n, batch), dtype),
        SY=jnp.zeros(gram_shape, dtype),
        YY=jnp.zeros(gram_shape, dtype),
        rho=jnp.zeros((history, batch), dtype),
        hist=zero_i,
        head=zero_i,
        gamma=jnp.ones((batch,), dtype),
        fun=jnp.full((batch,), jnp.nan, dtype),
        k=jnp.zeros((), jnp.int32),
        status=status0,
        iterations=zero_i,
        n_fev=zero_i,
        n_gev=zero_i,
        n_resets=zero_i,
        stall=zero_i,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "history", "ls", "max_iterations", "value_and_grad_fn",
        "stall_limit", "gram_precision", "unroll", "incremental_gram",
    ),
)
def _optimize_lbfgs_batched_fused_jit(
    obj, x0s, history, ls, tol, max_iterations, value_and_grad_fn,
    stall_limit=STALL_LIMIT_DEFAULT, gram_precision=None, unroll=1,
    incremental_gram=False,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)

    batch, n = x0s.shape
    circular = n >= _RING_CIRCULAR_MIN_N
    carry0 = _fresh_lbfgs_carry(
        x0s.T, history, jnp.full((batch,), Status.RUNNING, jnp.int32),
        circular, incremental_gram,
    )
    fc = _lbfgs_loop_batched(vag_b, f_b, carry0, ls, tol, max_iterations,
                             stall_limit, circular, gram_precision, unroll,
                             incremental_gram)
    return _result_from_lcarry(fc, circular)


def _result_from_lcarry(fc: _LCarry, circular: bool) -> LBFGSResult:
    # Export the ring in the canonical time order (oldest..newest in
    # 0..hist-1, zeros elsewhere) so the saved LBFGSState is interchangeable
    # with the scalar engine's convention — one rotation, once per solve
    # (the shift ring is already canonical).
    mh = fc.S.shape[0]
    dtype = fc.X.dtype
    if circular:
        P = _time_order_perm(fc.head, fc.hist, mh, fc.S.dtype)
        valid = (jnp.arange(mh)[:, None] < fc.hist[None, :])
        S_t = jnp.einsum("tpb,pnb->tnb", P, fc.S, precision=_HI) * valid[:, None, :]
        Y_t = jnp.einsum("tpb,pnb->tnb", P, fc.Y, precision=_HI) * valid[:, None, :]
        rho_t = jnp.einsum("tpb,pb->tb", P, fc.rho, precision=_HI) * valid
    else:
        S_t, Y_t, rho_t = fc.S, fc.Y, fc.rho
    state = LBFGSState(
        x=fc.X.T,
        grad=fc.G.T,
        grad_old=fc.G_old.T,
        step=fc.STEP.T,
        S=jnp.moveaxis(S_t, -1, 0),
        Y=jnp.moveaxis(Y_t, -1, 0),
        rho=rho_t.T,
        hist=fc.hist,
        gamma=fc.gamma,
        fun=fc.fun,
        k=fc.iterations,
        status=fc.status,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        stall=fc.stall,
    )
    nan = jnp.asarray(jnp.nan, dtype)
    return LBFGSResult(
        x=state.x,
        fun=jnp.where(fc.status == Status.CONVERGED, fc.fun, nan),
        grad=state.grad,
        status=fc.status,
        iterations=fc.iterations,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        last_value=fc.fun,
        state=state,
    )


def optimize_lbfgs_batched_fused(
    obj,
    x0s: jax.Array,
    history: int = 10,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    gram_precision=None,
    unroll: int = 1,
    incremental_gram: bool = False,
) -> LBFGSResult:
    """Masked-lockstep batched L-BFGS (the throughput engine for fleets).

    ``gram_precision``: jax.lax.Precision for the O(m*n*batch) Gram and
    direction contractions (None = backend default, fastest; pass
    jax.lax.Precision.HIGHEST for ill-conditioned f32 fleets — ~30%
    slower at large n, see the precision-policy note in the module).

    ``unroll``: chain this many masked iteration bodies per while step to
    amortize per-step dispatch (trajectory-identical in exact arithmetic;
    f32 rounding differs because XLA fuses across the chain). A tuning
    knob: leave at 1 unless a measurement on the device shows a gain."""
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    return _optimize_lbfgs_batched_fused_jit(
        obj, x0s, history, ls, tol, max_iterations, value_and_grad_fn,
        stall_limit, gram_precision, unroll, incremental_gram,
    )


@partial(
    jax.jit,
    static_argnames=(
        "obj", "ls", "max_iterations", "value_and_grad_fn",
        "stall_limit", "gram_precision", "unroll", "incremental_gram",
    ),
)
def _optimize_lbfgs_batched_fused_resume_jit(
    obj, state, ls, tol, max_iterations, value_and_grad_fn,
    stall_limit=STALL_LIMIT_DEFAULT, gram_precision=None, unroll=1,
    incremental_gram=False,
):
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    vag_b = jax.vmap(vag, in_axes=1, out_axes=(0, 1))
    f_b = jax.vmap(f, in_axes=1, out_axes=0)

    mh = state.S.shape[1]
    n = state.x.shape[1]
    circular = n >= _RING_CIRCULAR_MIN_N
    S0 = jnp.moveaxis(state.S, 0, -1)  # canonical order IS a valid ring
    Y0 = jnp.moveaxis(state.Y, 0, -1)
    if circular and incremental_gram:
        # seed the incremental Grams from the loaded ring — once per resume
        SY0 = jnp.einsum("inb,jnb->ijb", S0, Y0, precision=gram_precision)
        YY0 = jnp.einsum("inb,jnb->ijb", Y0, Y0, precision=gram_precision)
    else:
        SY0 = YY0 = jnp.zeros((1, 1, 1), S0.dtype)
    carry0 = _LCarry(
        X=state.x.T,
        G=state.grad.T,
        G_old=state.grad_old.T,
        STEP=state.step.T,
        S=S0,
        Y=Y0,
        SY=SY0,
        YY=YY0,
        rho=state.rho.T,
        hist=state.hist,
        # canonical time order: slots 0..hist-1 hold oldest..newest, so the
        # next write goes to slot `hist` (ring not yet full) or wraps to
        # slot 0 (the oldest) — exactly hist % m. With this head the
        # time-order rotation (slot(t) = (t + head - hist) % m) is the
        # identity, so a resumed ring is read back unpermuted.
        head=state.hist % mh,
        gamma=state.gamma,
        fun=state.fun,
        k=jnp.zeros((), jnp.int32),
        status=jnp.full(state.fun.shape, Status.RUNNING, jnp.int32),
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        # fresh stall budget (same rationale as the BFGS fleet resume)
        stall=jnp.zeros_like(state.stall),
    )
    fc = _lbfgs_loop_batched(vag_b, f_b, carry0, ls, tol, max_iterations,
                             stall_limit, circular, gram_precision, unroll,
                             incremental_gram)
    return _result_from_lcarry(fc, circular)


def optimize_lbfgs_batched_fused_from_state(
    obj,
    state,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    gram_precision=None,
    unroll: int = 1,
    incremental_gram: bool = False,
) -> LBFGSResult:
    """Resume a batched L-BFGS fleet from a (possibly checkpointed) batched
    LBFGSState — the L-BFGS analog of `optimize_batched_fused_from_state`.

    All lanes are re-armed to RUNNING (converged lanes can be re-solved
    under a tighter tol); iteration/eval counters continue from the saved
    values and ``max_iterations`` bounds this leg. A resumed lane CONTINUES
    its trajectory: the saved (step, grad_old) pair feeds the first
    cautious ring push, the saved ring drives the first direction, and
    lanes that have never stepped (step = 0 -> sᵀy = 0) are skipped by the
    cautious-push guard and take the steepest/H0 direction naturally.
    History capacity m is taken from the state's ring shape."""
    if state.x.ndim != 2:
        raise ValueError(
            "expected a batched LBFGSState (leaves with batch axis)"
        )
    return _optimize_lbfgs_batched_fused_resume_jit(
        obj, state, ls, tol, max_iterations, value_and_grad_fn,
        stall_limit, gram_precision, unroll, incremental_gram,
    )
