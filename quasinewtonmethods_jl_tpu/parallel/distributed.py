"""Multi-host initialization helpers.

The reference has no distributed layer at all (SURVEY.md §2c); within one
host, `parallel.mesh` covers every local device. Across hosts, JAX's
own runtime does the heavy lifting — these helpers just make the framework's
entry points host-aware so a fleet script is identical on 1 host or 64:

    from quasinewtonmethods_jl_tpu.parallel import distributed as dist
    dist.initialize()                       # no-op on a single host
    mesh = make_mesh({"data": jax.device_count()})
    res = optimize_batched_sharded(obj, x0s, mesh)   # global arrays

Under multi-host JAX, every host runs the same program; jax.Arrays are
globally sharded and XLA routes the collectives over the devices'
interconnect within a host and the network across hosts — no framework
code changes.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize", "is_distributed", "host_count", "process_index"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX if a cluster is configured; no-op otherwise.

    With no arguments, initializes only when a coordinator address is
    set in the environment (``COORDINATOR_ADDRESS`` or
    ``JAX_COORDINATOR_ADDRESS``) and otherwise silently stays
    single-process.

    Must be callable as the first JAX call of the program: the
    already-initialized guard inspects the distributed client directly —
    jax.process_count() would itself initialize the XLA backends, after
    which jax.distributed.initialize() unconditionally raises.
    """
    if _client_initialized():
        return
    explicit = coordinator_address is not None
    # Conservative auto-detect: require an actual coordinator address env.
    auto = any(
        os.environ.get(v)
        for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    )
    if not (explicit or auto):
        return  # single host — nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _client_initialized() -> bool:
    # Backend-neutral "has jax.distributed.initialize already run": checks
    # the distributed service client without touching (and thereby
    # initializing) the XLA backends.
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:  # pragma: no cover — private-API drift fallback
        return False


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()
