"""The fleet engine's fused update against a dense f64 Sherman–Morrison product.

`ops.bfgs.fused_bfgs_update_reference` computes the next direction and m
by closed forms and applies the reset / frozen / fresh-H0 selects inside
one batch-minor update. Here every lane is recomputed the textbook way,
one lane at a time in numpy float64:

    B_new = V B Vᵀ + ρ s sᵀ,   V = I − ρ s yᵀ,   ρ = 1/(sᵀy),
    d = B_new g,   m = gᵀ B_new g,

with B first scaled by the Barzilai–Borwein factor for fresh lanes, the
identity for reset lanes and B unchanged (d = 0, m = 1) for frozen ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from quasinewtonmethods_jl_tpu.ops.bfgs import (
    H0_GAMMA_CLIP,
    fused_bfgs_update_reference,
)

BATCH = 3


def _spd(rng, n):
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    return A @ A.T + np.eye(n)


def _lanes(rng, n, kind):
    """(B, s, g, g_old, active, fresh) for BATCH lanes of one kind."""
    B = np.stack([_spd(rng, n) for _ in range(BATCH)], axis=-1)
    s = rng.standard_normal((n, BATCH)) * 0.1
    g = rng.standard_normal((n, BATCH))
    # y = g_old - g = H s with H SPD: positive curvature, a normal update
    y = np.stack([_spd(rng, n) @ s[:, b] for b in range(BATCH)], axis=-1)
    active = np.ones((1, BATCH))
    fresh = np.zeros((1, BATCH))
    if kind == "reset":
        # B = I, g = s, y = -2s: m_pre = -|s|^2/2 < 0 forces the reset
        B = np.broadcast_to(np.eye(n)[:, :, None], (n, n, BATCH)).copy()
        g = s.copy()
        y = -2.0 * s
    elif kind == "frozen":
        active[:] = 0.0
    elif kind == "fresh":
        fresh[:] = 1.0
    return B, s, g, g + y, active, fresh


def _dense_reference(B, s, g, g_old, active, fresh):
    n = B.shape[0]
    B_out = np.empty_like(B)
    d = np.empty_like(g)
    m = np.empty((1, B.shape[-1]))
    reset = np.zeros((1, B.shape[-1]))
    for b in range(B.shape[-1]):
        Bb, sb, gb = B[:, :, b], s[:, b], g[:, b]
        if active[0, b] == 0:
            B_out[:, :, b], d[:, b], m[0, b] = Bb, 0.0, 1.0
            continue
        yb = g_old[:, b] - gb
        sty = sb @ yb
        if fresh[0, b] > 0 and sty > 0:
            Bb = Bb * np.clip(sty / (yb @ yb), *H0_GAMMA_CLIP)
        rho = 1.0 / sty
        V = np.eye(n) - rho * np.outer(sb, yb)
        Bn = V @ Bb @ V.T + rho * np.outer(sb, sb)
        mb = gb @ Bn @ gb
        if mb <= 0:
            B_out[:, :, b], d[:, b], m[0, b] = np.eye(n), gb, gb @ gb
            reset[0, b] = 1.0
        else:
            B_out[:, :, b], d[:, b], m[0, b] = Bn, Bn @ gb, mb
    return B_out, d, m, reset


@pytest.mark.parametrize("kind", ["normal", "reset", "frozen", "fresh"])
@pytest.mark.parametrize("n", [60, 128, 256, 512])
def test_fused_update_matches_sherman_morrison(n, kind):
    rng = np.random.default_rng(1000 * n + len(kind))
    args = _lanes(rng, n, kind)
    want = _dense_reference(*args)
    got = fused_bfgs_update_reference(*(jnp.asarray(a) for a in args))
    for name, w, g in zip(("B", "d", "m"), want[:3], got[:3]):
        g = np.asarray(g)
        assert g.dtype == np.float64
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * scale,
                                   err_msg=f"{name} ({kind}, n={n})")
    np.testing.assert_array_equal(np.asarray(got[3]), want[3])
    if kind == "reset":
        assert want[3].all()
    if kind == "frozen":
        np.testing.assert_array_equal(np.asarray(got[0]), args[0])
