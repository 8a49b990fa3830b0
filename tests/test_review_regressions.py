"""Regression tests for the round-2 code-review findings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity


def test_compact_direction_masks_stale_rows(rng):
    """A mid-run steepest-ascent reset clears only `hist`; slots above it
    keep STALE nonzero pairs. The compact direction must mask them (it
    previously assumed zero rows and produced directions wrong by orders
    of magnitude until the ring refilled)."""
    from quasinewtonmethods_jl_tpu.ops.lbfgs import lbfgs_direction
    from quasinewtonmethods_jl_tpu.ops.lbfgs_compact import (
        lbfgs_direction_compact,
    )

    m, n = 5, 8
    S = jnp.asarray(rng.standard_normal((m, n)))  # every slot stale/nonzero
    Y = jnp.asarray(rng.standard_normal((m, n)))
    rho = jnp.asarray(1.0 / np.einsum("ij,ij->i", np.asarray(S), np.asarray(Y)))
    g = jnp.asarray(rng.standard_normal(n))
    gamma = jnp.asarray(1.3)
    for hist in (0, 1, 3, 5):
        h = jnp.asarray(hist, jnp.int32)
        d2, m2 = lbfgs_direction(S, Y, rho, h, gamma, g)
        dc, mc = lbfgs_direction_compact(S, Y, rho, h, gamma, g)
        np.testing.assert_allclose(
            np.asarray(dc), np.asarray(d2), rtol=1e-10, atol=1e-12,
            err_msg=f"hist={hist}",
        )


def test_resume_resets_stall_budget(rng):
    """Resuming a stall-exited state must grant a fresh no-improvement
    budget — it previously re-failed after exactly one iteration without
    attempting a step (stall counter carried at the limit)."""
    _TH = np.deg2rad(150.0)
    ROT = np.asarray([[np.cos(_TH), -np.sin(_TH)], [np.sin(_TH), np.cos(_TH)]])

    def absorbed(x):
        return jnp.asarray(1e20, x.dtype) - 1e-30 * jnp.sum(x * x)

    def vag(x):
        gr = jnp.asarray(ROT, x.dtype) @ x
        return absorbed(x), gr / jnp.sqrt(jnp.sum(gr * gr))

    first = qnm.optimize(absorbed, jnp.asarray([3.0, -2.0]), tol=0.0,
                         value_and_grad_fn=vag, stall_limit=20,
                         max_iterations=500)
    assert int(first.status) == qnm.Status.LINESEARCH_FAILURE
    k1 = int(first.iterations)
    res = qnm.optimize_from_state(absorbed, first.state, tol=0.0,
                                  value_and_grad_fn=vag, stall_limit=20,
                                  max_iterations=500)
    # a full fresh stall budget ran (19 not 20: the resumed first
    # iteration compares against the carried state.fun, so it has no
    # free improved=True iteration the way a fresh solve's NaN fun does)
    assert int(res.iterations) - k1 >= 19

    # batched engine: same contract
    from quasinewtonmethods_jl_tpu.batched_solve import (
        optimize_batched_fused,
        optimize_batched_fused_from_state,
    )

    firstb = optimize_batched_fused(absorbed, jnp.asarray([[3.0, -2.0]]),
                                    tol=0.0, value_and_grad_fn=vag,
                                    stall_limit=20, max_iterations=500)
    k1 = int(firstb.iterations[0])
    resb = optimize_batched_fused_from_state(
        absorbed, firstb.state, tol=0.0, value_and_grad_fn=vag,
        stall_limit=20, max_iterations=500,
    )
    assert int(resb.iterations[0]) - k1 >= 19


def test_checkpoint_roundtrip_without_extension(rng, tmp_path):
    """np.savez silently appends .npz; save/load must round-trip on the
    same extensionless path."""
    from quasinewtonmethods_jl_tpu.utils import load_state, save_state

    res = qnm.optimize(rosenbrock_logdensity, jnp.asarray(rng.standard_normal(6)))
    p = tmp_path / "ckpt"  # no extension
    save_state(p, res.state)
    restored = load_state(p, qnm.BFGSState)
    np.testing.assert_array_equal(np.asarray(restored.x), np.asarray(res.state.x))


def test_implicit_compiles_once_per_obj_opts(rng):
    """optimize_implicit must hit the compilation cache across params
    values (it previously rebuilt a fresh closure per call, recompiling
    the entire solver every time)."""
    from quasinewtonmethods_jl_tpu.implicit import _solve_implicit_jit

    def f(x, p):
        return -0.5 * jnp.sum((x - p) ** 2)

    x0 = jnp.zeros(4)
    before = _solve_implicit_jit._cache_size()
    qnm.optimize_implicit(f, x0, jnp.asarray(0.5))
    after_first = _solve_implicit_jit._cache_size()
    qnm.optimize_implicit(f, x0, jnp.asarray(1.5))
    qnm.optimize_implicit(f, x0, jnp.asarray(-2.0))
    assert _solve_implicit_jit._cache_size() == after_first > before


def test_distributed_initialize_does_not_touch_backends():
    """initialize() must be callable as the program's first JAX call: its
    already-initialized guard previously called jax.process_count(), which
    initializes the backends and makes jax.distributed.initialize raise."""
    import subprocess
    import sys

    code = """
import jax
jax.config.update("jax_platforms", "cpu")
from quasinewtonmethods_jl_tpu.parallel import distributed as dist
import jax._src.xla_bridge as xb
assert not getattr(xb, "_backends", {}), "backends initialized too early"
dist.initialize()
assert not getattr(xb, "_backends", {}), "initialize() touched the backends"
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
        env={"PYTHONPATH": "/root/repo", "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin", "HOME": "/tmp"},
    )
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-1500:]


def test_chain_init_from_map_zero_converged_identity_mass(rng):
    """round-3 ADVICE: with zero converged lanes the averaged mass used to
    be all-zero (NaN momenta downstream); it must fall back to identity."""
    from quasinewtonmethods_jl_tpu.parallel.batch import (
        optimize_batched, optimize_lbfgs_batched,
    )
    from quasinewtonmethods_jl_tpu.sampling import chain_init_from_map

    def bad(x):  # non-finite everywhere: every lane fails immediately
        return jnp.nan * jnp.sum(x)

    x0 = jnp.asarray(rng.standard_normal((4, 6)))
    res = optimize_batched(bad, x0, max_iterations=3)
    assert not bool(jnp.any(res.status == qnm.Status.CONVERGED))
    x0s, mass = chain_init_from_map(res)
    np.testing.assert_allclose(np.asarray(mass), np.eye(6), atol=0)

    res_l = optimize_lbfgs_batched(bad, x0, history=3, max_iterations=3)
    _, mass_l = chain_init_from_map(res_l)
    np.testing.assert_allclose(np.asarray(mass_l), np.ones(6), atol=0)


def test_chain_init_from_map_jitter_without_key_raises(rng):
    from quasinewtonmethods_jl_tpu.parallel.batch import optimize_batched
    from quasinewtonmethods_jl_tpu.sampling import chain_init_from_map

    x0 = jnp.asarray(rng.standard_normal((4, 6))) + 1.0
    res = optimize_batched(rosenbrock_logdensity, x0)
    with pytest.raises(ValueError, match="jitter"):
        chain_init_from_map(res, jitter=0.1)


def test_objective_matmuls_traced_at_highest_precision():
    """An accelerator's reduced-precision default dot passes (TF32 on a
    GPU) put ~1e-3-relative noise on a dense quadratic's gradient, which
    makes tol=1e-3 unreachable. The objective wrappers must pin
    float32-accurate matmul precision, exactly like the engine's own
    einsum does."""
    from quasinewtonmethods_jl_tpu.api import (
        as_value_and_grad, as_value_fn,
    )

    Q = jnp.eye(4) * 2.0

    def quad(x):
        return -0.5 * x @ (Q @ x)

    def quad_vag(x):
        g = -(Q @ x)
        return -0.5 * x @ (Q @ x), g

    for fn in [
        as_value_and_grad(quad, None),
        as_value_and_grad(None, quad_vag),
        as_value_fn(quad, None),
    ]:
        jaxpr = jax.make_jaxpr(fn)(jnp.ones(4))
        precisions = [
            str(e.params.get("precision"))
            for e in jaxpr.jaxpr.eqns
            if e.primitive.name == "dot_general"
        ]
        assert precisions and all("HIGHEST" in p for p in precisions), (
            precisions
        )
