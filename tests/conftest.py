"""Test configuration: CPU backend, 8 virtual devices, float64.

Mirrors the reference's test philosophy (analytic fixtures, no cluster —
SURVEY.md §4): numerical-parity tests run in f64 on the CPU backend, and
multi-device sharding tests run on a virtual 8-device CPU mesh via
--xla_force_host_platform_device_count (the standard JAX way to test
shard_map/collectives without accelerator hardware).

Environment must be set before jax is imported, hence the module-level code.
"""

import os

# Force, don't setdefault: the suite is the CPU parity suite even on a host
# with an accelerator (GPU-only paths are covered by chip_smoke.py); the
# post-import config update below pins the CPU backend as well.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound per-process XLA state: with ~300 tests compiling hundreds of
    executables into one CPU client, the full suite started segfaulting
    inside backend_compile near the end of the run (reproducibly late,
    test-independent, with 125 GB RAM free — compiler-state accumulation,
    not OOM; every file passes standalone). Dropping the compilation
    caches at module boundaries keeps the client small; cross-module
    recompiles are cheap because modules rarely share jit signatures."""
    yield
    jax.clear_caches()
