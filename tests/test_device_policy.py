"""Device policy, compile-cache helper and the GPU smoke script, on the CPU.

`utils.device` is the one place that decides by platform; these pin its
answers for accelerator and CPU platform names, and that the library's
platform-dependent defaults (``optimize_batched(backend="auto")``,
multistart's dtype) follow it when JAX reports a GPU. The smoke script
itself needs a GPU: here it must refuse to run.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import (
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu.utils import compile_cache, device

ROOT = Path(__file__).resolve().parent.parent
ACCELERATORS = ["gpu", "cuda", "rocm"]


@pytest.mark.parametrize("platform", ACCELERATORS)
def test_accelerator_platforms(platform):
    assert device.on_accelerator(platform)
    assert device.default_dtype(platform) == jnp.float32
    assert device.default_fleet_backend(platform) == "fused"


def test_cpu_platform():
    assert not device.on_accelerator("cpu")
    assert device.default_dtype("cpu") == jnp.float64
    assert device.default_fleet_backend("cpu") == "vmap"


def test_policy_defaults_to_jax_backend():
    # the test suite pins the CPU backend (conftest)
    assert jax.default_backend() == "cpu"
    assert not device.on_accelerator()
    assert device.default_dtype() == jnp.float64
    assert device.default_fleet_backend() == "vmap"


@pytest.mark.parametrize(
    "platform,expected", [("gpu", "fused"), ("cuda", "fused"), ("cpu", "vmap")]
)
def test_optimize_batched_auto_backend_follows_policy(
    platform, expected, monkeypatch, rng
):
    """backend='auto' takes the fused engine exactly when JAX reports an
    accelerator (the computation itself still runs on the CPU here)."""
    import quasinewtonmethods_jl_tpu.batched_solve as bs

    calls = []
    fused = bs.optimize_batched_fused

    def spy(*args, **kwargs):
        calls.append("fused")
        return fused(*args, **kwargs)

    monkeypatch.setattr(bs, "optimize_batched_fused", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    X0 = jnp.asarray(rng.standard_normal((4, 6)))
    res = qnm.optimize_batched(
        rosenbrock_logdensity, X0, tol=1e-6,
        value_and_grad_fn=rosenbrock_value_and_grad,
    )
    assert (calls == ["fused"]) == (expected == "fused")
    assert np.all(np.asarray(res.status) == qnm.Status.CONVERGED)


@pytest.mark.parametrize(
    "platform,dtype", [("gpu", jnp.float32), ("cpu", jnp.float64)]
)
def test_multistart_default_dtype_follows_policy(platform, dtype, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    res = qnm.optimize_multistart(
        lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0), n_starts=4, dim=3,
        tol=1e-3,
    )
    assert res.x.dtype == dtype
    assert int(res.n_converged) == 4


def test_batched_fused_has_no_kernel_option(rng):
    """One update remains: naming a kernel is an error, not a silent
    fallback."""
    X0 = jnp.asarray(rng.standard_normal((4, 6)))
    with pytest.raises(TypeError):
        qnm.optimize_batched_fused(rosenbrock_logdensity, X0, kernel="pallas")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path / "cache"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cache")
    # JAX reads the variable itself; the helper sets nothing else
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_path_is_fixed():
    """The path is part of the cache key: no pid, time or temp name."""
    a = compile_cache.default_cache_dir()
    b = compile_cache.default_cache_dir()
    assert a == b == str(ROOT / ".jax_cache")
    assert str(os.getpid()) not in a


def test_compile_cache_dir_is_git_ignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    assert "chiprun_out/" in ignored


def _run_smoke(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


@pytest.mark.parametrize("n", [2, 7, 60])
def test_chip_smoke_host_gradient_matches_analytic(chip_smoke, n, rng):
    """The smoke script's independent f64 certificate is the gradient of
    the same log-density the package's analytic gradient differentiates."""
    X = rng.standard_normal((3, n))
    ours = chip_smoke.rosenbrock_grad64(X)
    for lane in range(3):
        _, g = rosenbrock_value_and_grad(jnp.asarray(X[lane]))
        np.testing.assert_allclose(ours[lane], np.asarray(g), rtol=1e-12,
                                   atol=1e-12)


def test_chip_smoke_check_fleet_fails_on_unconverged(chip_smoke, rng):
    X0 = jnp.asarray(rng.standard_normal((4, 6)))
    res = qnm.optimize_batched(rosenbrock_logdensity, X0, max_iterations=2)
    with pytest.raises(SystemExit):
        chip_smoke.check_fleet("short fleet", res, qnm, 0.0)


def test_chip_smoke_check_fleet_passes_certified(chip_smoke, rng):
    X0 = jnp.asarray(rng.standard_normal((4, 6)))
    res = qnm.optimize_batched(rosenbrock_logdensity, X0, tol=1e-6)
    chip_smoke.check_fleet("certified fleet", res, qnm, 0.0)
