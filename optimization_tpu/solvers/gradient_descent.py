"""Riemannian gradient descent with Armijo backtracking line search.

JAX re-design of the reference ``GradientDescent``
(``Riemannian/GradientDescent.h:124-434``): the outer iteration and the
backtracking line search are nested ``lax.while_loop``s inside a single jitted
program; per-iteration traces are written into preallocated on-device buffers
(the analog of the reference's ``std::vector`` traces,
``Base/Concepts.h:76-87``); termination statuses are carried as int32 codes.

Functional contract (matching the reference exactly):

- Armijo accept rule   f(x) - f(R_x(-t g)) > sigma * t * |g|^2   with
  t <- beta * t starting from t = alpha (``GradientDescent.h:263-286``);
- stopping criteria: |g| < gradient_tolerance, relative decrease, stepsize,
  line-search failure, iteration limit (``GradientDescent.h:256-339``);
- identical parameter names/defaults (``GradientDescent.h:44-58``).

Because the whole solve is one XLA program, batching a fleet of instances is
``jax.vmap(solve, ...)`` and scenario-sharding them across a device mesh is a
``NamedSharding`` on the batched arguments.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.debug import pad_value
from ..core.problem import RiemannianProblem
from ..core.tree import tree_scale, tree_where
from ..core.types import GradientDescentStatus, SmoothOptimizerParams

__all__ = ["GradientDescentParams", "GradientDescentResult", "solve"]


@dataclasses.dataclass(frozen=True)
class GradientDescentParams(SmoothOptimizerParams):
    """Mirrors ``GradientDescentParams`` (reference ``GradientDescent.h:44-58``)."""

    alpha: float = 1.0           # initial stepsize
    beta: float = 0.5            # backtracking shrink factor
    sigma: float = 0.5           # Armijo sufficient-decrease fraction
    max_ls_iterations: int = 100

    def validate(self) -> None:
        super().validate()
        if self.alpha <= 0:
            raise ValueError("Initial stepsize (alpha) must be a positive real value")
        if not (0 < self.beta < 1):
            raise ValueError("Stepsize reduction factor (beta) must be in (0,1)")
        if not (0 < self.sigma < 1):
            raise ValueError("Sufficient decrease parameter (sigma) must be in (0,1)")


class GradientDescentResult(NamedTuple):
    x: Any
    f: jnp.ndarray
    gradfx_norm: jnp.ndarray
    status: jnp.ndarray            # GradientDescentStatus code
    num_iterations: jnp.ndarray    # completed outer iterations
    # Traces: entries [0, num_iterations] are valid; NaN beyond.
    objective_values: jnp.ndarray
    gradient_norms: jnp.ndarray
    update_step_norms: jnp.ndarray       # per completed iteration
    linesearch_iterations: jnp.ndarray   # per completed iteration
    # Wall-clock seconds per recorded iteration; NaN from the jitted solve,
    # filled by the host-chunked driver (core/driver.py).
    times: jnp.ndarray
    iterates: Optional[Any] = None       # only when params.log_iterates


class _State(NamedTuple):
    k: jnp.ndarray
    x: Any
    f: jnp.ndarray
    grad: Any
    gradnorm: jnp.ndarray
    status: jnp.ndarray
    objective_values: jnp.ndarray
    gradient_norms: jnp.ndarray
    update_step_norms: jnp.ndarray
    linesearch_iterations: jnp.ndarray
    iterates: Optional[Any]


def solve(
    problem: RiemannianProblem,
    x0: Any,
    params: GradientDescentParams = GradientDescentParams(),
    data: Any = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
) -> GradientDescentResult:
    """Minimize ``problem`` from ``x0``.  Fully jitted; vmappable over batches.

    ``user_function(k, t, x, f, grad, h, df) -> bool`` is an optional pure
    stopping predicate evaluated once per outer iteration with the
    arguments of the reference's ``GradientDescentUserFunction``
    (``GradientDescent.h:22-40``: iteration, accepted stepsize, iterate,
    objective, gradient, update step, objective decrease) — but
    *terminating*, like the other five engines' user functions (the
    reference's is a void observer; its exact per-iteration observation
    semantics live in the host driver's ``observer=`` at
    ``chunk_iterations=1``).  A True return stops the solve BEFORE the
    update is applied, with status ``USER_FUNCTION``.

    For wall-clock limits (``max_computation_time``), per-iteration verbose
    output, ``result.times``, and host observers, run through
    :func:`optimization_tpu.core.driver.drive` — host facilities cannot live
    inside a compiled loop without synchronizing every iteration).
    """
    params.validate()
    return _solve(problem, params, user_function, x0, data)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _solve(problem: RiemannianProblem, params: GradientDescentParams,
           user_function, x0: Any, data: Any) -> GradientDescentResult:
    M = problem.manifold
    n_trace = params.max_iterations + 1

    f0 = jnp.asarray(problem.value(x0, data))
    dtype = f0.dtype
    g0 = problem.rgrad(x0, data)
    gn0 = jnp.sqrt(M.inner(x0, g0, g0))
    sqrt_eps = jnp.sqrt(jnp.finfo(dtype).eps)

    nan_trace = jnp.full((n_trace,), pad_value(), dtype)
    iterates0 = (jax.tree_util.tree_map(
        lambda l: jnp.zeros((n_trace,) + jnp.shape(l), jnp.asarray(l).dtype), x0)
        if params.log_iterates else None)

    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        x=x0, f=f0, grad=g0, gradnorm=gn0,
        status=jnp.asarray(GradientDescentStatus.RUNNING.value, jnp.int32),
        objective_values=nan_trace,
        gradient_norms=nan_trace,
        # max(1, .) so zero-iteration solves still trace (the loop body
        # indexes these even though it never executes)
        update_step_norms=jnp.full((max(params.max_iterations, 1),), pad_value(),
                                   dtype),
        linesearch_iterations=jnp.zeros((max(params.max_iterations, 1),),
                                        jnp.int32),
        iterates=iterates0,
    )

    def record(st: _State) -> _State:
        it = st.iterates
        if it is not None:
            it = jax.tree_util.tree_map(
                lambda tr, l: tr.at[st.k].set(l), it, st.x)
        return st._replace(
            objective_values=st.objective_values.at[st.k].set(st.f),
            gradient_norms=st.gradient_norms.at[st.k].set(st.gradnorm),
            iterates=it,
        )

    def linesearch(x, f, grad, gradnorm):
        """Armijo backtracking (reference GradientDescent.h:263-286)."""

        def ls_cond(c):
            t, ls_iters, accept, x_prop, f_prop, df = c
            return (~accept) & (ls_iters < params.max_ls_iterations)

        def ls_body(c):
            t, ls_iters, accept, x_prop, f_prop, df = c
            t = t * params.beta
            h = tree_scale(-t, grad)
            x_new = M.retract(x, h)
            f_new = jnp.asarray(problem.value(x_new, data))
            df_new = f - f_new
            accept = df_new > params.sigma * t * gradnorm * gradnorm
            return (t, ls_iters + 1, accept, x_new, f_new, df_new)

        t0 = jnp.asarray(params.alpha / params.beta, dtype)
        c0 = (t0, jnp.zeros((), jnp.int32), jnp.asarray(False), x, f,
              jnp.zeros((), dtype))
        return jax.lax.while_loop(ls_cond, ls_body, c0)

    def iterate(st: _State) -> _State:
        t, ls_iters, accept, x_prop, f_prop, df = linesearch(
            st.x, st.f, st.grad, st.gradnorm)

        # Line-search failure: keep the current iterate, flag, and stop
        # (reference GradientDescent.h:294-298).
        ls_failed = ~accept

        h_norm = t * st.gradnorm
        relative_decrease = df / (jnp.abs(st.f) + sqrt_eps)

        if user_function is not None:
            h = tree_scale(-t, st.grad)
            user_stop = jnp.asarray(user_function(
                st.k, t, st.x, st.f, st.grad, h, df))
            accept = accept & ~user_stop
        else:
            user_stop = jnp.asarray(False)

        x_new = tree_where(accept, x_prop, st.x)
        f_new = jnp.where(accept, f_prop, st.f)
        g_new = problem.rgrad(x_new, data)
        gn_new = jnp.sqrt(M.inner(x_new, g_new, g_new))
        g_new = tree_where(accept, g_new, st.grad)
        gn_new = jnp.where(accept, gn_new, st.gradnorm)

        status = jnp.where(
            user_stop,
            GradientDescentStatus.USER_FUNCTION.value,
            jnp.where(
                ls_failed,
                GradientDescentStatus.LINE_SEARCH.value,
                jnp.where(
                    relative_decrease < params.relative_decrease_tolerance,
                    GradientDescentStatus.RELATIVE_DECREASE.value,
                    jnp.where(h_norm < params.stepsize_tolerance,
                              GradientDescentStatus.STEPSIZE.value,
                              GradientDescentStatus.RUNNING.value)))
        ).astype(jnp.int32)

        return st._replace(
            k=jnp.where(ls_failed | user_stop, st.k, st.k + 1),
            x=x_new, f=f_new, grad=g_new, gradnorm=gn_new,
            status=status,
            update_step_norms=st.update_step_norms.at[st.k].set(
                jnp.where(accept, h_norm, pad_value())),
            linesearch_iterations=st.linesearch_iterations.at[st.k].set(ls_iters),
        )

    def body(st: _State) -> _State:
        st = record(st)
        grad_conv = st.gradnorm < params.gradient_tolerance

        def converged(s):
            return s._replace(status=jnp.asarray(
                GradientDescentStatus.GRADIENT.value, jnp.int32))

        return jax.lax.cond(grad_conv, converged, iterate, st)

    def cond(st: _State):
        return ((st.k < params.max_iterations)
                & (st.status == GradientDescentStatus.RUNNING.value))

    st = jax.lax.while_loop(cond, body, st0)

    # Iteration limit is the default status (reference GradientDescent.h:207)
    status = jnp.where(st.status == GradientDescentStatus.RUNNING.value,
                       GradientDescentStatus.ITERATION_LIMIT.value,
                       st.status).astype(jnp.int32)

    # Final trace entry (reference appends final values post-loop,
    # GradientDescent.h:346-358).  The slot st.k may duplicate an in-loop
    # record when a top-of-loop criterion fired; that matches the reference.
    st = record(st)

    return GradientDescentResult(
        x=st.x, f=st.f, gradfx_norm=st.gradnorm, status=status,
        num_iterations=st.k,
        objective_values=st.objective_values,
        gradient_norms=st.gradient_norms,
        update_step_norms=st.update_step_norms,
        linesearch_iterations=st.linesearch_iterations,
        times=jnp.full((n_trace,), pad_value(), jnp.float32),
        iterates=st.iterates,
    )
