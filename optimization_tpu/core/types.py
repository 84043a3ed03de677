"""Core parameter / result / status vocabulary shared by every solver.

This is the JAX counterpart of the reference's params-struct hierarchy
(``Base/Concepts.h:42-88`` and ``Riemannian/Concepts.h:116-148`` in
david-m-rosen/Optimization): frozen dataclasses with *identical field names and
defaults* (they are part of the behavioral contract), plus result PyTrees whose
per-iteration traces are fixed-length stacked arrays (filled with NaN beyond
``num_iterations``) instead of dynamically-grown ``std::vector``s, so that an
entire solve — traces included — stays inside one compiled XLA program.

Status enums mirror the reference's termination-status enums
(``TNT.h:134-164``, ``TNLS.h:171-204``, ``GradientDescent.h:62-85``,
``ProximalGradient.h:103-108``, ``ADMM.h:186-198``) and are carried through
``lax.while_loop`` bodies as int32 codes.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, NamedTuple

import jax.numpy as jnp

__all__ = [
    "OptimizerParams",
    "SmoothOptimizerParams",
    "GradientDescentStatus",
    "TNTStatus",
    "TNLSStatus",
    "ProximalGradientStatus",
    "ADMMStatus",
    "RUNNING",
]

# Sentinel status value used inside while_loop carries ("no stopping criterion
# has fired yet").  Every per-solver enum reserves 0 for this.
RUNNING = 0


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    """Basic configuration common to all iterative optimizers.

    Mirrors ``OptimizerParams`` (reference ``Base/Concepts.h:42-60``): same
    fields, same defaults.  ``max_computation_time`` is honored by the
    host-chunked drivers (wall-clock checks cannot live inside a compiled
    loop); the fully-jitted solvers honor every other criterion on-device.
    """

    max_iterations: int = 100
    max_computation_time: float = math.inf
    log_iterates: bool = False
    verbose: bool = False
    precision: int = 3

    def validate(self) -> None:
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be a nonnegative integer")
        if self.max_computation_time < 0:
            raise ValueError(
                "Maximum computation time must be a nonnegative real value")


@dataclasses.dataclass(frozen=True)
class SmoothOptimizerParams(OptimizerParams):
    """Configuration for smooth (first-/second-order) optimizers.

    Mirrors ``SmoothOptimizerParams`` (reference
    ``Riemannian/Concepts.h:116-131``).
    """

    gradient_tolerance: float = 1e-6
    relative_decrease_tolerance: float = 1e-6
    stepsize_tolerance: float = 1e-6

    def validate(self) -> None:
        super().validate()
        if self.gradient_tolerance < 0:
            raise ValueError("Gradient tolerance must be a nonnegative real value")
        if self.relative_decrease_tolerance < 0:
            raise ValueError(
                "Relative decrease tolerance must be a nonnegative real value")
        if self.stepsize_tolerance < 0:
            raise ValueError("Stepsize tolerance must be a nonnegative real value")


class GradientDescentStatus(enum.IntEnum):
    """Termination statuses for gradient descent (ref ``GradientDescent.h:62-85``)."""

    RUNNING = 0
    GRADIENT = 1
    RELATIVE_DECREASE = 2
    STEPSIZE = 3
    LINE_SEARCH = 4
    ITERATION_LIMIT = 5
    ELAPSED_TIME = 6
    # Extension beyond the reference enum (GradientDescent.h:62-85 has no
    # user stop): our GD takes a *terminating* jittable user_function like
    # the other five engines; the reference's void per-iteration callback
    # semantics are recovered by the host driver's observer= at
    # chunk_iterations=1 (tests/test_driver.py pins the equivalence).
    USER_FUNCTION = 7


class TNTStatus(enum.IntEnum):
    """Termination statuses for TNT (ref ``TNT.h:134-164``)."""

    RUNNING = 0
    GRADIENT = 1
    PRECONDITIONED_GRADIENT = 2
    RELATIVE_DECREASE = 3
    STEPSIZE = 4
    TRUST_REGION = 5
    ITERATION_LIMIT = 6
    ELAPSED_TIME = 7
    USER_FUNCTION = 8


class TNLSStatus(enum.IntEnum):
    """Termination statuses for TNLS (ref ``TNLS.h:171-204``)."""

    RUNNING = 0
    ROOT = 1
    GRADIENT = 2
    RELATIVE_DECREASE = 3
    STEPSIZE = 4
    TRUST_REGION = 5
    ITERATION_LIMIT = 6
    ELAPSED_TIME = 7
    USER_FUNCTION = 8


class ProximalGradientStatus(enum.IntEnum):
    """Termination statuses for proximal gradient (ref ``ProximalGradient.h:103-108``)."""

    RUNNING = 0
    PROX_GRAD_RESIDUAL = 1
    ITERATION_LIMIT = 2
    LINESEARCH = 3
    ELAPSED_TIME = 4
    # Extension beyond the reference enum: the reference's
    # ``ProximalGradientUserFunction`` (``ProximalGradient.h:45-49``) is a
    # void per-iteration observer; ours is a *terminating* jittable
    # predicate like the other engines', and the reference's observer
    # semantics (incl. ``linesearch_iters``/``dx``) are recovered by the
    # host driver's observer= at chunk_iterations=1.
    USER_FUNCTION = 5


class ADMMStatus(enum.IntEnum):
    """Termination statuses for ADMM (ref ``ADMM.h:186-198``)."""

    RUNNING = 0
    RESIDUAL_TOLERANCE = 1
    ITERATION_LIMIT = 2
    ELAPSED_TIME = 3
    # Extension beyond the reference enum: the reference's
    # ``ADMMUserFunction`` (``ADMM.h:71-76``) is a void per-iteration
    # observer; ours is a *terminating* jittable predicate like the other
    # engines', and the reference's observer semantics (incl. the ``r``/``s``
    # residual VECTORS) are recovered by the host driver's observer= at
    # chunk_iterations=1.
    USER_FUNCTION = 4


class ADMMIterationType(enum.IntEnum):
    """Per-iteration classification for ADMM (ref ``ADMM.h:200-212``)."""

    ACCELERATED = 0
    STANDARD = 1
    RESTART = 2


def trace_fill(n: int, dtype: Any = jnp.float32) -> jnp.ndarray:
    """A trace buffer of length ``n`` (written in-place by solvers): NaN-filled
    by the result contract (entries beyond ``num_iterations`` are unread), or
    zero-filled under the OPTTPU_DEBUG_NANS sanitizer tier (core/debug.py)."""
    from .debug import pad_value
    return jnp.full((n,), pad_value(), dtype=dtype)


class SolveInfo(NamedTuple):
    """Host-side metadata attached to results by the chunked drivers."""

    elapsed_time: float
    chunks: int
