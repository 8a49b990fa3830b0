"""Device policy: the one place that decides by platform.

Every platform-dependent default of the library asks this module. The
only distinction it draws is accelerator versus CPU:

* on an accelerator, fleets run on the fused batch-minor engine and default
  to float32 — the throughput contract;
* on the CPU, ``optimize_batched(backend="auto")`` takes the vmap-of-scalar
  engine and dtypes default to float64 — the reference-parity contract.

Each function takes an optional ``platform`` (a `jax.default_backend()`
name) so the policy can be checked without the device present.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["on_accelerator", "default_dtype", "default_fleet_backend"]


def on_accelerator(platform: Optional[str] = None) -> bool:
    """True unless ``platform`` (default: JAX's default backend) is the CPU."""
    if platform is None:
        platform = jax.default_backend()
    return platform != "cpu"


def default_dtype(platform: Optional[str] = None):
    """float32 on an accelerator, float64 on the CPU."""
    return jnp.float32 if on_accelerator(platform) else jnp.float64


def default_fleet_backend(platform: Optional[str] = None) -> str:
    """What ``optimize_batched(backend="auto")`` resolves to: the fused
    batch-minor driver on an accelerator, the vmap engine on the CPU."""
    return "fused" if on_accelerator(platform) else "vmap"
