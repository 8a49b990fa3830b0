"""Native host runtime bindings (ctypes over native/qnm_host.cpp).

The CPU-native execution path of the framework: a zero-allocation C++ BFGS
maximizer with the same numerical contract as the JAX drivers. Use it for
single low-latency solves (no XLA compile, no dispatch overhead — this path
beats the reference library's 330 us/solve headline benchmark), as an
independent parity oracle, or on hosts without an accelerator.

The shared library is built on demand with the system g++ (-O3
-march=native) and cached next to the source; no pip/pybind11 involved.
"""

from __future__ import annotations

import ctypes
import os
import platform
import subprocess
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np

__all__ = [
    "optimize_host",
    "optimize_lbfgs_host",
    "optimize_batch_host",
    "optimize_cg_host",
    "rosenbrock_host",
    "rosenbrock_lbfgs_host",
    "rosenbrock_batch_host",
    "rosenbrock_cg_host",
    "HostResult",
    "HostBatchResult",
    "lib_path",
    "load",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "qnm_host.cpp")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_LIB = os.path.join(_BUILD_DIR, "libqnm_host.so")

_lock = threading.Lock()
_lib = None

_VALUE_FN = ctypes.CFUNCTYPE(
    ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
    ctypes.c_void_p,
)
_VALUE_GRAD_FN = ctypes.CFUNCTYPE(
    ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_void_p,
)


class HostResult(NamedTuple):
    """Mirror of OptimizeResult for the native path (f64 only)."""

    x: np.ndarray
    fun: float  # converged value or NaN (same in-band contract)
    grad: np.ndarray  # gradient at x (stale only on MAX_ITERATIONS exit)
    status: int  # state.Status code
    iterations: int
    n_fev: int
    n_gev: int


class HostBatchResult(NamedTuple):
    """Per-lane outputs of the threaded native fleet drivers."""

    x: np.ndarray  # (batch, n)
    fun: np.ndarray  # (batch,) converged values / NaN (in-band contract)
    grad: np.ndarray  # (batch, n)
    status: np.ndarray  # (batch,) int32 state.Status codes
    iterations: np.ndarray  # (batch,) int32
    n_fev: np.ndarray  # (batch,) int64
    n_gev: np.ndarray  # (batch,) int64
    n_converged: int


def lib_path() -> str:
    return _LIB


def _build() -> str:
    if not os.path.exists(_SRC):
        raise RuntimeError(
            "native host runtime unavailable: C++ source not found at "
            f"{_SRC} (the native/ tree ships with the repository layout, "
            "not with installed site-packages)"
        )
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Staleness key includes the flags: a cached .so built with different
    # QNM_HOST_CXXFLAGS (or auto-detected flags) must not be silently
    # reused after the env var changes.
    stamp = _LIB + ".flags"
    flags_now = os.environ.get("QNM_HOST_CXXFLAGS", f"<auto:{platform.machine()}>")
    stamp_ok = (
        os.path.exists(stamp) and open(stamp).read() == flags_now
    )
    if (
        stamp_ok
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    # Architecture-specific tuning flags only where they exist; everything
    # else (including arm64 macOS) builds with plain -O3. Override with
    # QNM_HOST_CXXFLAGS (space-separated) for cross-compilation setups.
    extra = os.environ.get("QNM_HOST_CXXFLAGS")
    if extra is not None:
        arch_flags = extra.split()
    elif platform.machine() in ("x86_64", "AMD64"):
        arch_flags = ["-march=native", "-mprefer-vector-width=512"]
    else:
        arch_flags = ["-mcpu=native"] if platform.machine().startswith(("arm", "aarch")) else []
    cmd = [
        "g++", "-O3", *arch_flags,
        "-funroll-loops", "-fopenmp-simd", "-pthread",
        "-std=c++17", "-shared", "-fPIC", _SRC, "-o", _LIB,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        # Retry without the AUTO-DETECTED tuning flags only; explicit
        # QNM_HOST_CXXFLAGS are the user's contract — never silently
        # replaced with host defaults.
        if arch_flags and extra is None:
            cmd = [
                "g++", "-O3", "-funroll-loops", "-fopenmp-simd",
                "-pthread", "-std=c++17", "-shared", "-fPIC", _SRC,
                "-o", _LIB,
            ]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except subprocess.CalledProcessError as e2:
                raise RuntimeError(f"native build failed: {e2.stderr}") from e2
        else:
            raise RuntimeError(f"native build failed: {e.stderr}") from e
    with open(stamp, "w") as fh:
        fh.write(flags_now)
    return _LIB


def load() -> ctypes.CDLL:
    """Build (if stale) and load the native library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            D = ctypes.POINTER(ctypes.c_double)
            lib.qnm_bfgs_optimize.restype = ctypes.c_double
            lib.qnm_bfgs_optimize.argtypes = [
                _VALUE_GRAD_FN, _VALUE_FN, ctypes.c_void_p, ctypes.c_int32, D,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int32, D, D,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.qnm_bfgs_optimize_rosenbrock.restype = ctypes.c_double
            lib.qnm_bfgs_optimize_rosenbrock.argtypes = [
                ctypes.c_int32, D, ctypes.c_int32, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int32, D, D,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.qnm_lbfgs_optimize.restype = ctypes.c_double
            lib.qnm_lbfgs_optimize.argtypes = [
                _VALUE_GRAD_FN, _VALUE_FN, ctypes.c_void_p, ctypes.c_int32, D,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_int32,
                ctypes.c_double, ctypes.c_int32, D, D,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.qnm_lbfgs_optimize_rosenbrock.restype = ctypes.c_double
            lib.qnm_lbfgs_optimize_rosenbrock.argtypes = [
                ctypes.c_int32, D, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double, ctypes.c_int32, D, D,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            I32 = ctypes.POINTER(ctypes.c_int32)
            I64 = ctypes.POINTER(ctypes.c_int64)
            lib.qnm_cg_optimize.restype = ctypes.c_double
            lib.qnm_cg_optimize.argtypes = [
                _VALUE_GRAD_FN, ctypes.c_void_p, ctypes.c_int32, D,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_int32,
                D, D, I32, I32, I64, I64,
            ]
            lib.qnm_cg_optimize_rosenbrock.restype = ctypes.c_double
            lib.qnm_cg_optimize_rosenbrock.argtypes = [
                ctypes.c_int32, D, ctypes.c_int32, ctypes.c_double,
                ctypes.c_int32, D, D, I32, I32, I64, I64,
            ]
            lib.qnm_bfgs_optimize_batch.restype = ctypes.c_int32
            lib.qnm_bfgs_optimize_batch.argtypes = [
                _VALUE_GRAD_FN, _VALUE_FN, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, D, ctypes.c_int32, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_int32,
                ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, D, D, D, I32, I32, I64, I64,
            ]
            lib.qnm_lbfgs_optimize_batch.restype = ctypes.c_int32
            lib.qnm_lbfgs_optimize_batch.argtypes = [
                _VALUE_GRAD_FN, _VALUE_FN, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, D, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
                ctypes.c_int32, D, D, D, I32, I32, I64, I64,
            ]
            lib.qnm_bfgs_optimize_rosenbrock_batch.restype = ctypes.c_int32
            lib.qnm_bfgs_optimize_rosenbrock_batch.argtypes = [
                ctypes.c_int32, ctypes.c_int32, D, ctypes.c_int32,
                ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, D, D, D, I32, I32, I64, I64,
            ]
            _lib = lib
    return _lib


def _outputs(n):
    out_x = np.empty(n, np.float64)
    out_g = np.empty(n, np.float64)
    status = ctypes.c_int32()
    iters = ctypes.c_int32()
    nfev = ctypes.c_int64()
    ngev = ctypes.c_int64()
    return out_x, out_g, status, iters, nfev, ngev


def _as_c(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rosenbrock_host(
    x0: np.ndarray,
    order: int = 2,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
    h0_scale: bool = True,
) -> HostResult:
    """Fully-native solve of the built-in Rosenbrock fixture (the reference's
    README benchmark workload — no Python crosses the hot path)."""
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]
    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_bfgs_optimize_rosenbrock(
        n, _as_c(x0), order, tol, max_iterations, int(h0_scale),
        _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


def optimize_host(
    value_and_grad: Callable[[np.ndarray], tuple],
    x0: np.ndarray,
    value: Optional[Callable[[np.ndarray], float]] = None,
    order: int = 2,
    c1: float = 1e-4,
    rho_hi: float = 0.5,
    rho_lo: float = 0.1,
    ls_iterations: int = 1000,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
    h0_scale: bool = True,
) -> HostResult:
    """Native solve with Python objective callbacks.

    The callback crossing costs ~1 us/eval — use `rosenbrock_host`-style
    all-native objectives (or the JAX path) when the objective is trivial;
    use this when the objective is a real computation implemented in
    numpy/C and single-solve latency matters.
    """
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]

    if value is None:
        value = lambda x: value_and_grad(x)[0]

    # Callback hygiene (both verified failure modes):
    #  * a Python exception escaping a ctypes callback is swallowed and the
    #    C return value is undefined — the solver then reads a zeroed
    #    gradient buffer and reports a silent false CONVERGED. Exceptions
    #    convert to an in-band NaN value instead, so the C++ driver exits
    #    NONFINITE_VALUE (the framework's documented failure contract).
    #  * the x view aliases the solver's internal iterate buffer; it is
    #    handed out read-only so user code cannot mutate the iterate
    #    mid-iteration (copy it if you need to retain it).
    nan = float("nan")

    def _ro_view(ptr, n_):
        arr = np.ctypeslib.as_array(ptr, (n_,))
        arr.flags.writeable = False
        return arr

    @_VALUE_GRAD_FN
    def fg_cb(grad_ptr, x_ptr, n_, _user):
        try:
            v, g = value_and_grad(_ro_view(x_ptr, n_))
            np.ctypeslib.as_array(grad_ptr, (n_,))[:] = g
            return float(v)
        except Exception:
            return nan

    @_VALUE_FN
    def f_cb(x_ptr, n_, _user):
        try:
            return float(value(_ro_view(x_ptr, n_)))
        except Exception:
            return nan

    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_bfgs_optimize(
        fg_cb, f_cb, None, n, _as_c(x0), order, c1, rho_hi, rho_lo,
        ls_iterations, tol, max_iterations, int(h0_scale),
        _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


def rosenbrock_lbfgs_host(
    x0: np.ndarray,
    history: int = 10,
    order: int = 2,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
) -> HostResult:
    """Fully-native L-BFGS solve of the built-in Rosenbrock fixture."""
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]
    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_lbfgs_optimize_rosenbrock(
        n, _as_c(x0), history, order, tol, max_iterations,
        _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


def optimize_lbfgs_host(
    value_and_grad: Callable[[np.ndarray], tuple],
    x0: np.ndarray,
    value: Optional[Callable[[np.ndarray], float]] = None,
    history: int = 10,
    order: int = 2,
    c1: float = 1e-4,
    rho_hi: float = 0.5,
    rho_lo: float = 0.1,
    ls_iterations: int = 1000,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
) -> HostResult:
    """Native L-BFGS solve with Python objective callbacks — the large-n
    counterpart of `optimize_host` (O(history*n) memory, circular ring,
    cautious push, BB gamma H0; same semantics as the JAX scalar L-BFGS
    driver). Callback hygiene identical to `optimize_host` (exceptions
    become an in-band NaN value; x views are read-only)."""
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]

    if value is None:
        value = lambda x: value_and_grad(x)[0]

    nan = float("nan")

    def _ro_view(ptr, n_):
        arr = np.ctypeslib.as_array(ptr, (n_,))
        arr.flags.writeable = False
        return arr

    @_VALUE_GRAD_FN
    def fg_cb(grad_ptr, x_ptr, n_, _user):
        try:
            v, g = value_and_grad(_ro_view(x_ptr, n_))
            np.ctypeslib.as_array(grad_ptr, (n_,))[:] = g
            return float(v)
        except Exception:
            return nan

    @_VALUE_FN
    def f_cb(x_ptr, n_, _user):
        try:
            return float(value(_ro_view(x_ptr, n_)))
        except Exception:
            return nan

    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_lbfgs_optimize(
        fg_cb, f_cb, None, n, _as_c(x0), history, order, c1, rho_hi, rho_lo,
        ls_iterations, tol, max_iterations,
        _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


def _batch_outputs(batch, n):
    out_f = np.empty(batch, np.float64)
    out_x = np.empty((batch, n), np.float64)
    out_g = np.empty((batch, n), np.float64)
    status = np.empty(batch, np.int32)
    iters = np.empty(batch, np.int32)
    nfev = np.empty(batch, np.int64)
    ngev = np.empty(batch, np.int64)
    return out_f, out_x, out_g, status, iters, nfev, ngev


def _as_i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_i64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def rosenbrock_batch_host(
    x0s: np.ndarray,
    order: int = 2,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
    h0_scale: bool = True,
    threads: int = 0,
) -> HostBatchResult:
    """Threaded native fleet on the built-in Rosenbrock: the host-side
    counterpart of the accelerator fleet benchmark, and the native realization of
    the reference's intended multi-thread pattern (one self-contained
    zero-allocation state per thread — PtrBFGSState,
    src/QuasiNewtonMethods.jl:117-121). Lanes are pulled from an atomic
    counter by ``threads`` std::threads (0 = all hardware threads); no
    Python crosses the hot path, so the pool scales to the core count.
    Each lane is bitwise-identical to a `rosenbrock_host` call on its row.
    """
    lib = load()
    x0s = np.ascontiguousarray(x0s, np.float64)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    batch, n = x0s.shape
    out_f, out_x, out_g, status, iters, nfev, ngev = _batch_outputs(batch, n)
    n_conv = lib.qnm_bfgs_optimize_rosenbrock_batch(
        n, batch, _as_c(x0s), order, tol, max_iterations, int(h0_scale),
        int(threads), _as_c(out_f), _as_c(out_x), _as_c(out_g),
        _as_i32(status), _as_i32(iters), _as_i64(nfev), _as_i64(ngev),
    )
    return HostBatchResult(out_x, out_f, out_g, status, iters, nfev, ngev,
                           int(n_conv))


def optimize_batch_host(
    value_and_grad: Callable[[np.ndarray], tuple],
    x0s: np.ndarray,
    value: Optional[Callable[[np.ndarray], float]] = None,
    engine: str = "bfgs",
    history: int = 10,
    order: int = 2,
    c1: float = 1e-4,
    rho_hi: float = 0.5,
    rho_lo: float = 0.1,
    ls_iterations: int = 1000,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
    h0_scale: bool = True,
    threads: int = 1,
) -> HostBatchResult:
    """Native fleet solve with Python objective callbacks.

    ``engine``: 'bfgs' (dense, small n) or 'lbfgs' (O(history·n), large
    n). ``threads`` defaults to 1 because a Python (ctypes) callback
    serializes every evaluation on the GIL — a bigger pool is CORRECT but
    buys nothing until the objective itself releases the GIL (numpy does
    for large arrays) or is native; `rosenbrock_batch_host` shows the
    all-native scaling. Callback hygiene matches `optimize_host`
    (exceptions become an in-band NaN; x views are read-only — note the
    callbacks run on pool threads, so user code must be thread-safe when
    ``threads != 1``).
    """
    if engine not in ("bfgs", "lbfgs"):
        raise ValueError(f"engine must be 'bfgs' or 'lbfgs', got {engine!r}")
    lib = load()
    x0s = np.ascontiguousarray(x0s, np.float64)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {x0s.shape}")
    batch, n = x0s.shape

    if value is None:
        value = lambda x: value_and_grad(x)[0]

    nan = float("nan")

    def _ro_view(ptr, n_):
        arr = np.ctypeslib.as_array(ptr, (n_,))
        arr.flags.writeable = False
        return arr

    @_VALUE_GRAD_FN
    def fg_cb(grad_ptr, x_ptr, n_, _user):
        try:
            v, g = value_and_grad(_ro_view(x_ptr, n_))
            np.ctypeslib.as_array(grad_ptr, (n_,))[:] = g
            return float(v)
        except Exception:
            return nan

    @_VALUE_FN
    def f_cb(x_ptr, n_, _user):
        try:
            return float(value(_ro_view(x_ptr, n_)))
        except Exception:
            return nan

    out_f, out_x, out_g, status, iters, nfev, ngev = _batch_outputs(batch, n)
    if engine == "bfgs":
        n_conv = lib.qnm_bfgs_optimize_batch(
            fg_cb, f_cb, None, n, batch, _as_c(x0s), order, c1, rho_hi,
            rho_lo, ls_iterations, tol, max_iterations, int(h0_scale),
            int(threads), _as_c(out_f), _as_c(out_x), _as_c(out_g),
            _as_i32(status), _as_i32(iters), _as_i64(nfev), _as_i64(ngev),
        )
    else:
        n_conv = lib.qnm_lbfgs_optimize_batch(
            fg_cb, f_cb, None, n, batch, _as_c(x0s), history, order, c1,
            rho_hi, rho_lo, ls_iterations, tol, max_iterations,
            int(threads), _as_c(out_f), _as_c(out_x), _as_c(out_g),
            _as_i32(status), _as_i32(iters), _as_i64(nfev), _as_i64(ngev),
        )
    return HostBatchResult(out_x, out_f, out_g, status, iters, nfev, ngev,
                           int(n_conv))


_CG_METHODS = {"hz": 0, "pr": 1, "fr": 2, "dy": 3}


def rosenbrock_cg_host(
    x0: np.ndarray,
    method: str = "hz",
    tol: float = 1e-8,
    max_iterations: int = 10_000,
) -> HostResult:
    """Fully-native nonlinear-CG solve of the built-in Rosenbrock fixture
    (Hager-Zhang default, approximate-Wolfe acceptance on — the JAX
    `optimize_cg` defaults)."""
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]
    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_cg_optimize_rosenbrock(
        n, _as_c(x0), _CG_METHODS[method], tol, max_iterations,
        _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


def optimize_cg_host(
    value_and_grad: Callable[[np.ndarray], tuple],
    x0: np.ndarray,
    method: str = "hz",
    c1: float = 1e-4,
    c2: float = 0.9,
    ls_iterations: int = 50,
    approx_wolfe: bool = True,
    approx_eps: float = 1e-6,
    restart_nu: float = 0.2,
    tol: float = 1e-8,
    max_iterations: int = 10_000,
) -> HostResult:
    """Native nonlinear-CG solve with a Python value_and_grad callback —
    the O(n)-state member of the native engine family (BFGS O(n²),
    L-BFGS O(history·n), CG one vector). Semantics mirror the JAX
    `optimize_cg` engine: Hager-Zhang/PR+/FR/DY betas (maximization
    form), in-band steepest resets, Powell restarts for fr/pr, the
    warm-start scale riding the direction, weak-Wolfe search with the
    Hager-Zhang approximate acceptance on by default (the endgame that
    certifies 1e-8 where plain Armijo stalls at ~1e-6 on stiff
    quadratics). Callback hygiene matches `optimize_host` (exceptions
    become an in-band NaN value; x views are read-only). Note CG's
    Wolfe search evaluates value+grad at every trial — there is no
    value-only callback."""
    if method not in _CG_METHODS:
        raise ValueError(
            f"method must be one of {sorted(_CG_METHODS)}, got {method!r}"
        )
    lib = load()
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]

    nan = float("nan")

    def _ro_view(ptr, n_):
        arr = np.ctypeslib.as_array(ptr, (n_,))
        arr.flags.writeable = False
        return arr

    @_VALUE_GRAD_FN
    def fg_cb(grad_ptr, x_ptr, n_, _user):
        try:
            v, g = value_and_grad(_ro_view(x_ptr, n_))
            np.ctypeslib.as_array(grad_ptr, (n_,))[:] = g
            return float(v)
        except Exception:
            return nan

    out_x, out_g, status, iters, nfev, ngev = _outputs(n)
    fun = lib.qnm_cg_optimize(
        fg_cb, None, n, _as_c(x0), _CG_METHODS[method], c1, c2,
        ls_iterations, int(approx_wolfe), approx_eps, restart_nu, tol,
        max_iterations, _as_c(out_x), _as_c(out_g),
        ctypes.byref(status), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostResult(out_x, fun, out_g, status.value, iters.value,
                      nfev.value, ngev.value)


# ---------------------------------------------------------------------------
# Constrained optimization (round 5): the native PHR augmented Lagrangian
# ---------------------------------------------------------------------------

class HostAugLagResult(NamedTuple):
    """Native constrained result — the in-band contract of `AugLagResult`:
    ``fun`` is f(x) on the KKT certificate and NaN otherwise."""

    x: np.ndarray
    fun: float
    grad: np.ndarray
    lam: np.ndarray
    mu: np.ndarray
    viol: float
    rho: float
    status: int
    n_outer: int
    iterations: int
    n_fev: int
    n_gev: int


def _bind_auglag(lib):
    if getattr(lib, "_auglag_bound", False):
        return
    D = ctypes.POINTER(ctypes.c_double)
    I32 = ctypes.POINTER(ctypes.c_int32)
    I64 = ctypes.POINTER(ctypes.c_int64)
    VJP = ctypes.CFUNCTYPE(
        None, D, D, D, ctypes.c_int32, ctypes.c_void_p
    )
    CON = ctypes.CFUNCTYPE(None, D, D, ctypes.c_int32, ctypes.c_void_p)
    lib._AUGLAG_CON = CON
    lib._AUGLAG_VJP = VJP
    lib.qnm_auglag_optimize.restype = ctypes.c_double
    lib.qnm_auglag_optimize.argtypes = [
        _VALUE_GRAD_FN, _VALUE_FN, ctypes.c_void_p, ctypes.c_int32,
        CON, VJP, ctypes.c_int32,
        CON, VJP, ctypes.c_int32,
        D, D, D,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        D, D, D, D, D, D, I32, I32, I32, I64, I64,
    ]
    lib._auglag_bound = True


_AUGLAG_ENGINES = {"bfgs": 0, "lbfgs": 1, "cg": 2}


def optimize_auglag_host(
    value_and_grad: Callable[[np.ndarray], tuple],
    x0: np.ndarray,
    eq: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    eq_vjp: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    ineq: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ineq_vjp: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    value: Optional[Callable[[np.ndarray], float]] = None,
    engine: str = "cg",
    tol: float = 1e-8,
    ctol: float = 1e-8,
    rho0: float = 10.0,
    rho_growth: float = 10.0,
    rho_max: float = 1e8,
    viol_decrease: float = 0.25,
    max_outer: int = 20,
    max_iterations: int = 10_000,
    lam0: Optional[np.ndarray] = None,
    mu0: Optional[np.ndarray] = None,
    history: int = 10,
    order: int = 2,
) -> HostAugLagResult:
    """Native constrained maximize: f(x) s.t. eq(x) = 0, ineq(x) >= 0 —
    the C++ counterpart of `qnm.optimize_auglag` (same PHR multiplier
    updates, violation measure, rho schedule, in-band contracts), for the
    low-latency single-solve regime the native runtime serves.

    Constraint callbacks: ``eq(x) -> (m,)`` values and
    ``eq_vjp(x, w) -> (n,)`` returning J(x)^T w (the VJP an AD system
    would produce — for linear constraints a constant matrix-vector
    product). Each given constraint requires its vjp. ``engine``:
    'cg' (default — HZ approximate Wolfe, the |F*|>0 endgame rationale
    of the JAX auglag), 'bfgs', or 'lbfgs' (backtracking line search,
    ``order``/``history`` apply).
    """
    lib = load()
    _bind_auglag(lib)
    x0 = np.ascontiguousarray(x0, np.float64)
    n = x0.shape[0]
    if engine not in _AUGLAG_ENGINES:
        raise ValueError(f"engine must be one of {sorted(_AUGLAG_ENGINES)}")
    if eq is None and ineq is None:
        raise ValueError("at least one of eq=/ineq= is required")
    if (eq is None) != (eq_vjp is None) or (ineq is None) != (
        ineq_vjp is None
    ):
        raise ValueError("each constraint needs its matching *_vjp")
    if value is None:
        value = lambda x: value_and_grad(x)[0]  # noqa: E731

    m_eq = int(np.atleast_1d(eq(x0)).shape[0]) if eq is not None else 0
    m_in = int(np.atleast_1d(ineq(x0)).shape[0]) if ineq is not None else 0

    nan = float("nan")

    def _ro_view(ptr, n_):
        arr = np.ctypeslib.as_array(ptr, (n_,))
        arr.flags.writeable = False
        return arr

    @_VALUE_GRAD_FN
    def fg_cb(grad_ptr, x_ptr, n_, _user):
        try:
            v, g = value_and_grad(_ro_view(x_ptr, n_))
            np.ctypeslib.as_array(grad_ptr, (n_,))[:] = g
            return float(v)
        except Exception:
            return nan

    @_VALUE_FN
    def f_cb(x_ptr, n_, _user):
        try:
            return float(value(_ro_view(x_ptr, n_)))
        except Exception:
            return nan

    CON, VJP = lib._AUGLAG_CON, lib._AUGLAG_VJP

    def _con_cb(fn, m):
        @CON
        def cb(out_ptr, x_ptr, n_, _user):
            try:
                np.ctypeslib.as_array(out_ptr, (m,))[:] = np.atleast_1d(
                    fn(_ro_view(x_ptr, n_))
                )
            except Exception:
                np.ctypeslib.as_array(out_ptr, (m,))[:] = nan

        return cb

    def _vjp_cb(fn, m):
        @VJP
        def cb(accum_ptr, x_ptr, w_ptr, n_, _user):
            try:
                jtw = np.asarray(
                    fn(_ro_view(x_ptr, n_), _ro_view(w_ptr, m)), np.float64
                )
                np.ctypeslib.as_array(accum_ptr, (n_,))[:] += jtw
            except Exception:
                np.ctypeslib.as_array(accum_ptr, (n_,))[:] = nan

        return cb

    null_con = ctypes.cast(None, CON)
    null_vjp = ctypes.cast(None, VJP)
    eq_cb = _con_cb(eq, m_eq) if eq is not None else null_con
    eq_vjp_cb = _vjp_cb(eq_vjp, m_eq) if eq_vjp is not None else null_vjp
    in_cb = _con_cb(ineq, m_in) if ineq is not None else null_con
    in_vjp_cb = _vjp_cb(ineq_vjp, m_in) if ineq_vjp is not None else null_vjp

    lam0_a = np.ascontiguousarray(
        lam0 if lam0 is not None else np.zeros(m_eq), np.float64
    )
    mu0_a = np.ascontiguousarray(
        mu0 if mu0 is not None else np.zeros(m_in), np.float64
    )
    if lam0_a.shape != (m_eq,):
        raise ValueError(f"lam0 shape {lam0_a.shape} != ({m_eq},)")
    if mu0_a.shape != (m_in,):
        raise ValueError(f"mu0 shape {mu0_a.shape} != ({m_in},)")
    if m_in and bool((mu0_a < 0).any()):
        raise ValueError("mu0 must be elementwise >= 0")

    out_x = np.empty(n, np.float64)
    out_g = np.empty(n, np.float64)
    out_lam = np.empty(max(m_eq, 1), np.float64)
    out_mu = np.empty(max(m_in, 1), np.float64)
    out_viol = ctypes.c_double()
    out_rho = ctypes.c_double()
    status = ctypes.c_int32()
    n_outer = ctypes.c_int32()
    iters = ctypes.c_int32()
    nfev = ctypes.c_int64()
    ngev = ctypes.c_int64()
    fun = lib.qnm_auglag_optimize(
        fg_cb, f_cb, None, n,
        eq_cb, eq_vjp_cb, m_eq,
        in_cb, in_vjp_cb, m_in,
        _as_c(x0), _as_c(lam0_a), _as_c(mu0_a),
        rho0, rho_growth, rho_max, viol_decrease, tol, ctol,
        max_outer, _AUGLAG_ENGINES[engine], history, order,
        1e-4, 0.5, 0.1, 1000, max_iterations,
        _as_c(out_x), _as_c(out_g), _as_c(out_lam), _as_c(out_mu),
        ctypes.byref(out_viol), ctypes.byref(out_rho),
        ctypes.byref(status), ctypes.byref(n_outer), ctypes.byref(iters),
        ctypes.byref(nfev), ctypes.byref(ngev),
    )
    return HostAugLagResult(
        out_x, fun, out_g, out_lam[:m_eq], out_mu[:m_in],
        out_viol.value, out_rho.value, status.value, n_outer.value,
        iters.value, nfev.value, ngev.value,
    )


__all__ += ["optimize_auglag_host", "HostAugLagResult"]
