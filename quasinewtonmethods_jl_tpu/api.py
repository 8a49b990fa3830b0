"""User-facing objective protocol.

The reference's user API is a two-generic-function callback protocol —
``logdensity(obj, θ)`` returning a scalar and ``∂logdensity!(∇, obj, θ)``
filling the gradient in place (reference: src/QuasiNewtonMethods.jl:8-9) —
plus the ``AbstractProbabilityModel{D}`` tag supertype (:14-19) that
ProbabilityModels.jl hooks into.

on an accelerator the protocol is: the user supplies a *pure* ``logdensity(θ)``
function and the library derives the gradient with ``jax.value_and_grad``
(the analog of ∂logdensity!); an analytic/custom gradient is supported by
passing ``value_and_grad_fn`` explicitly, exactly like extending
∂logdensity! in the reference. Both plain callables and ProbabilityModel
objects are accepted everywhere an objective is.

The maximization convention is preserved throughout: objectives are
log-densities to be *maximized*.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax

__all__ = ["ProbabilityModel", "as_value_and_grad", "as_logdensity"]


def _pin_matmul_precision(fn):
    """Trace the objective under float32-accurate matmul precision.

    An accelerator's default float32 `dot_general` may run in reduced
    precision (TF32 on an NVIDIA GPU keeps ~3 decimal digits): an
    objective like ``x @ (Q @ x)`` then carries ~1e-3-relative gradient
    noise, and a gradient-norm tolerance of 1e-3 becomes unreachable.
    Under "highest" a GPU computes full float32 products, which is the
    precision the certificates assume. The solver's own fused update pins
    Precision.HIGHEST for the same reason (ops/bfgs.py); the user
    objective gets the same treatment or the certificate max|∇| < tol is
    measuring noise. Explicit per-op ``precision=`` in user code still
    wins (the context only sets the default)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


class ProbabilityModel:
    """Dimension-tagged log-density model.

    Mirror of ``AbstractProbabilityModel{D}`` (src/QuasiNewtonMethods.jl:14-19):
    ``dimension``/``__len__`` report D and ``repr`` matches the reference's
    show method. Subclasses implement ``logdensity(theta) -> scalar`` (pure,
    traceable) and may override ``logdensity_and_gradient`` with an analytic
    gradient; the default derives it via jax.value_and_grad.
    """

    def __init__(self, dimension: int):
        self._dimension = int(dimension)

    @property
    def dimension(self) -> int:
        return self._dimension

    def __len__(self) -> int:
        return self._dimension

    def __repr__(self) -> str:  # reference :17-18
        return f"{self._dimension}-dimensional Probability Model"

    def logdensity(self, theta: jax.Array) -> jax.Array:
        raise NotImplementedError(
            f"{type(self).__name__} must implement logdensity(theta)"
        )

    def logdensity_and_gradient(
        self, theta: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """Analog of ∂logdensity!: returns (value, gradient)."""
        return jax.value_and_grad(self.logdensity)(theta)


def as_logdensity(obj) -> Callable[[jax.Array], jax.Array]:
    """Normalize a callable or ProbabilityModel into ``f(theta) -> scalar``
    (traced under float32-accurate matmul precision — see
    `_pin_matmul_precision`)."""
    if isinstance(obj, ProbabilityModel) or hasattr(obj, "logdensity"):
        return _pin_matmul_precision(obj.logdensity)
    if callable(obj):
        return _pin_matmul_precision(obj)
    raise TypeError(
        f"objective must be callable or define .logdensity, got {type(obj)!r}"
    )


def as_value_fn(obj, value_and_grad_fn: Optional[Callable] = None):
    """Value-only objective for line-search trials (the `step!` path,
    reference src/QuasiNewtonMethods.jl:157-162, which calls `logdensity`,
    NOT ∂logdensity!).

    Performance-critical on an accelerator: a line-search trial must not
    pay for the backward pass, and per-kernel launch overhead inside
    `lax.while_loop` bodies dominates small-batch math — so we prefer the
    user's plain logdensity and only fall back to dropping the gradient of an
    explicit value_and_grad_fn when no value-only form exists.
    """
    if isinstance(obj, ProbabilityModel) or hasattr(obj, "logdensity") or callable(obj):
        return as_logdensity(obj)
    if value_and_grad_fn is not None:
        return _pin_matmul_precision(lambda theta: value_and_grad_fn(theta)[0])
    raise TypeError(
        f"objective must be callable or define .logdensity, got {type(obj)!r}"
    )


def as_value_and_grad(
    obj, value_and_grad_fn: Optional[Callable] = None
) -> Callable[[jax.Array], Tuple[jax.Array, jax.Array]]:
    """Normalize into ``f(theta) -> (value, gradient)``.

    Resolution order: explicit value_and_grad_fn > the object's own
    logdensity_and_gradient (analytic-override hook) > jax.value_and_grad of
    the logdensity.
    """
    if value_and_grad_fn is not None:
        return _pin_matmul_precision(value_and_grad_fn)
    if hasattr(obj, "logdensity_and_gradient"):
        return _pin_matmul_precision(obj.logdensity_and_gradient)
    return jax.value_and_grad(as_logdensity(obj))
