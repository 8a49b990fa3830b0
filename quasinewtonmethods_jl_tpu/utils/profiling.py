"""Tracing / profiling support.

The reference's only performance instrumentation is BenchmarkTools
transcripts in its README and commented-out @show lines (SURVEY.md §5).
on an accelerator, the equivalents are:

  * `trace(...)` — a context manager around `jax.profiler` producing an
    XPlane/trace-viewer dump of the on-device solve (every kernel, every
    while-loop iteration);
  * per-solve counters carried functionally in the result (iterations,
    n_fev, n_gev, n_resets) — the reference's commented-out f_calls/g_calls
    counters (src/QuasiNewtonMethods.jl:251-252) made first-class, since
    prints don't exist inside jit;
  * `summarize_trace(...)` — aggregate kernel times from a captured trace
    (what found the 6-7x HBM-pass inefficiency that motivated the fused
    update kernel).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
from typing import Dict, Iterator, List, Tuple

import jax

__all__ = ["trace", "summarize_trace", "solve_stats", "practically_converged"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of everything run inside the block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def summarize_trace(log_dir: str, top: int = 20, min_count: int = 1) -> List[Tuple[str, float, int]]:
    """Aggregate (name, total_seconds, count) from the newest trace in
    ``log_dir``, sorted by total time. Device kernels that execute once per
    loop iteration show up with large counts — the per-iteration cost map."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**/*.trace.json.gz"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no trace found under {log_dir}")
    with gzip.open(paths[-1]) as f:
        tr = json.load(f)
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    rows = [
        (name, d / 1e6, cnt[name])
        for name, d in dur.most_common()
        if cnt[name] >= min_count
    ]
    return rows[:top]


def solve_stats(result) -> Dict[str, float]:
    """Flatten a solve result's functional counters into plain floats/ints
    (batched results are summarized with totals and maxima)."""
    import numpy as np

    def scalarize(v, red):
        a = np.asarray(v)
        return float(red(a)) if a.ndim else float(a)

    return {
        "iterations_max": scalarize(result.iterations, np.max),
        "n_fev_total": scalarize(result.n_fev, np.sum),
        "n_gev_total": scalarize(result.n_gev, np.sum),
        "n_resets_total": scalarize(result.n_resets, np.sum),
        "converged_fraction": scalarize(
            np.asarray(result.status) == 1, np.mean
        ),
    }


def practically_converged(result, tol: float, factor: float = 10.0):
    """Per-lane acceptance mask: strictly converged, OR stalled at the
    floating-point noise floor with a near-tolerance gradient.

    The backtracking line search cannot certify objective increases below
    ~eps(dtype)*|f|, so a lane one step short of a tight tolerance exits
    with LINESEARCH_FAILURE while its iterate is perfectly usable (the
    reference returns NaN in the identical situation). Acceptance rule:
    status == CONVERGED, or status == LINESEARCH_FAILURE with
    max|grad| < factor * tol. Works for scalar and batched results.
    """
    import numpy as np

    status = np.asarray(result.status)
    grad = np.asarray(result.grad)
    gradmax = np.abs(grad).max(axis=-1) if grad.ndim > 1 else np.abs(grad).max()
    converged = status == 1  # Status.CONVERGED
    stalled_ok = (status == 3) & (gradmax < factor * tol)
    return converged | stalled_ok
