"""Proximal gradient (ISTA) and accelerated proximal gradient (FISTA).

JAX re-design of the reference ``ProximalGradient``
(``Convex/ProximalGradient.h:149-448``): minimizes h(x) = f(x) + g(x) with f
smooth and g prox-friendly, as one jitted ``lax.while_loop`` (with the
Beck-Teboulle backtracking line search as a bounded inner while-loop).
Batched scenario fleets are a ``jax.vmap``; scenario sharding over a
device mesh is a ``NamedSharding`` on the batched data.

Functional contract (matching the reference):

- FISTA momentum  t+ = (1 + sqrt(1 + 4 t^2)) / 2,
  y = x + ((t - 1)/t+) (x - x_prev)  (``ProximalGradient.h:389-390``);
- O'Donoghue-Candes adaptive restart iff <dx, y - x> > 0
  (``ProximalGradient.h:380-387``);
- composite gradient  G_lam = -(x - y)/lam  and the Goldstein FASTA eq. (42)
  relative criterion with the +1e-6 floor (``ProximalGradient.h:314-329``);
- stepsize lam persists (only shrinks) across iterations;
- identical parameter names/defaults (``ProximalGradient.h:60-101``).

Deviation (documented): the reference's backtracking test uses |x - y|
(``ProximalGradient.h:276-279``) where Beck-Teboulle's quadratic model
requires |x - y|^2; we implement the correct squared form.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.debug import pad_value
from ..core.problem import CompositeProblem
from ..core.tree import tree_axpy, tree_dot, tree_sub, tree_where
from ..core.types import OptimizerParams, ProximalGradientStatus

__all__ = ["ProximalGradientMode", "ProximalGradientParams",
           "ProximalGradientResult", "solve"]


class ProximalGradientMode(enum.Enum):
    SIMPLE = "simple"
    ACCELERATED = "accelerated"


@dataclasses.dataclass(frozen=True)
class ProximalGradientParams(OptimizerParams):
    """Mirrors ``ProximalGradientParams`` (reference ``ProximalGradient.h:60-101``)."""

    mode: ProximalGradientMode = ProximalGradientMode.ACCELERATED
    L: float = 1.0                   # Lipschitz estimate for grad f
    linesearch: bool = True
    beta: float = 0.5                # stepsize shrink factor
    adaptive_restart: bool = True
    max_LS_iterations: int = 100
    composite_gradient_tolerance: float = 1e-3
    relative_composite_gradient_tolerance: float = 1e-3

    def validate(self) -> None:
        super().validate()
        if self.L <= 0:
            raise ValueError("Lipschitz estimate (L) must be a positive real value")
        if not (0 < self.beta < 1):
            raise ValueError("Stepsize shrink factor (beta) must be in (0,1)")


class ProximalGradientResult(NamedTuple):
    x: Any
    f: jnp.ndarray                  # composite objective at x
    status: jnp.ndarray
    num_iterations: jnp.ndarray
    objective_values: jnp.ndarray
    composite_gradient_norms: jnp.ndarray
    relative_composite_gradient_norms: jnp.ndarray
    # Backtracking line-search iterations per outer iteration (zero when
    # ``linesearch=False``) — the reference callback's ``linesearch_iters``
    # (``ProximalGradient.h:45-49``); entries [0, num_iterations) valid.
    linesearch_iterations: Optional[jnp.ndarray] = None
    # The LAST iteration's composite update step dx = x_k - x_{k-1} (the
    # reference callback's ``dx``); at chunk_iterations=1 the host driver's
    # observer sees it per iteration.
    dx: Optional[Any] = None
    # Wall-clock seconds per recorded iteration; NaN from the jitted solve,
    # filled by the host-chunked driver (core/driver.py).
    times: Optional[jnp.ndarray] = None
    # (x_prev, y, t_prev, lam): pass back as ``warm_start=`` to resume the
    # momentum sequence exactly (used by the host-chunked driver).
    warm_start: Optional[tuple] = None
    iterates: Optional[Any] = None


class _State(NamedTuple):
    k: jnp.ndarray
    x: Any               # current iterate (result of the prox step)
    x_prev: Any
    y: Any               # extrapolated evaluation point
    F_x: jnp.ndarray
    F_prev: jnp.ndarray
    lam: jnp.ndarray
    t_prev: jnp.ndarray
    status: jnp.ndarray
    objective_values: jnp.ndarray
    composite_gradient_norms: jnp.ndarray
    relative_composite_gradient_norms: jnp.ndarray
    linesearch_iterations: jnp.ndarray
    dx: Any              # last composite update step x_k - x_{k-1}
    iterates: Optional[Any]


def solve(
    problem: CompositeProblem,
    x0: Any,
    params: ProximalGradientParams = ProximalGradientParams(),
    data: Any = None,
    warm_start: Optional[tuple] = None,
    user_function: Optional[Any] = None,
) -> ProximalGradientResult:
    """``warm_start`` is a ``result.warm_start`` tuple from a previous solve:
    resumes the FISTA momentum sequence and stepsize exactly (the seam used by
    the host-chunked driver, core/driver.py).

    ``user_function(k, x, F, G_lambda, linesearch_iters, dx, dF) -> bool`` is
    an optional pure stopping predicate evaluated once per iteration with the
    arguments of the reference's ``ProximalGradientUserFunction``
    (``ProximalGradient.h:45-49``: iteration, iterate at the start of the
    iteration, its objective value, composite gradient norm, line-search
    iterations, composite update step, objective decrease) — but
    *terminating*, like the other engines' user functions (the reference's is
    a void observer; elapsed time ``t`` cannot exist inside a compiled loop —
    the host driver's observer at ``chunk_iterations=1`` supplies it).  A
    True return stops the solve with status USER_FUNCTION before the update
    is applied."""
    params.validate()
    return _solve(problem, params, user_function, x0, data, warm_start)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _solve(problem: CompositeProblem, params: ProximalGradientParams,
           user_function, x0: Any, data: Any,
           warm_start) -> ProximalGradientResult:
    n_trace = max(params.max_iterations, 1)  # 0-iteration solves must trace
    accelerated = params.mode == ProximalGradientMode.ACCELERATED

    F0 = jnp.asarray(problem.value(x0, data))
    dtype = F0.dtype
    nan_trace = jnp.full((n_trace,), pad_value(), dtype)
    iterates0 = (jax.tree_util.tree_map(
        lambda l: jnp.zeros((n_trace,) + jnp.shape(l), jnp.asarray(l).dtype), x0)
        if params.log_iterates else None)

    if warm_start is None:
        x_prev0, y0 = x0, x0
        t0 = jnp.ones((), dtype)
        lam0 = jnp.asarray(1.0 / params.L, dtype)
    else:
        x_prev0, y0, t0, lam0 = warm_start

    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        x=x0, x_prev=x_prev0, y=y0,
        F_x=F0, F_prev=F0,
        lam=lam0,
        t_prev=t0,
        status=jnp.asarray(ProximalGradientStatus.RUNNING.value, jnp.int32),
        objective_values=nan_trace,
        composite_gradient_norms=nan_trace,
        relative_composite_gradient_norms=nan_trace,
        linesearch_iterations=jnp.zeros((n_trace,), jnp.int32),
        dx=jax.tree_util.tree_map(jnp.zeros_like, x0),
        iterates=iterates0,
    )

    def prox_step(y, grad_f_y, lam):
        hat_y = tree_axpy(-lam, grad_f_y, y)
        x = problem.prox(hat_y, lam, data)
        return hat_y, x, jnp.asarray(problem.value(x, data))

    def body(st: _State) -> _State:
        y = st.y
        grad_f_y = problem.gradient_f(y, data)
        hat_y, x, F_x = prox_step(y, grad_f_y, st.lam)
        lam = st.lam

        if params.linesearch:
            f_y = jnp.asarray(problem.value_f(y, data))
            # Rounding slack: near convergence F_x - Q(x,y) sinks below the
            # floating-point resolution of the objective (acute in f32);
            # without this the backtracking loop chatters to failure.
            eps = jnp.finfo(F0.dtype).eps

            def violated(c):
                lam, ls, x, hat_y, F_x = c
                xmy = tree_sub(x, y)
                q = (f_y + tree_dot(xmy, grad_f_y)
                     + tree_dot(xmy, xmy) / (2.0 * lam)
                     + jnp.asarray(problem.value_g(x, data)))
                slack = 10.0 * eps * (jnp.abs(F_x) + jnp.abs(f_y))
                return F_x > q + slack

            def ls_cond(c):
                lam, ls, x, hat_y, F_x = c
                return violated(c) & (ls <= params.max_LS_iterations)

            def ls_body(c):
                lam, ls, x, hat_y, F_x = c
                lam = lam * params.beta
                hat_y, x, F_x = prox_step(y, grad_f_y, lam)
                return (lam, ls + 1, x, hat_y, F_x)

            lam, ls_iters, x, hat_y, F_x = jax.lax.while_loop(
                ls_cond, ls_body,
                (lam, jnp.zeros((), jnp.int32), x, hat_y, F_x))
            ls_failed = ls_iters > params.max_LS_iterations
        else:
            ls_iters = jnp.zeros((), jnp.int32)
            ls_failed = jnp.asarray(False)

        # --- iteration analysis (reference ProximalGradient.h:304-329) ---
        dx = tree_sub(x, st.x_prev)
        x_minus_y = tree_sub(x, y)
        G = tree_dot(x_minus_y, x_minus_y)
        composite_gradient_norm = jnp.sqrt(G) / lam
        grad_f_x = problem.gradient_f(x, data)
        subgrad_g_x = jax.tree_util.tree_map(
            lambda hy, xi: (hy - xi) / lam, hat_y, x)
        denom = jnp.maximum(jnp.sqrt(tree_dot(grad_f_x, grad_f_x)),
                            jnp.sqrt(tree_dot(subgrad_g_x, subgrad_g_x))) + 1e-6
        relative_norm = composite_gradient_norm / denom

        # --- record traces (reference records the *previous* objective) ---
        it = st.iterates
        if it is not None:
            it = jax.tree_util.tree_map(
                lambda tr, l: tr.at[st.k].set(l), it, st.x_prev)
        traces = dict(
            objective_values=st.objective_values.at[st.k].set(st.F_prev),
            composite_gradient_norms=(
                st.composite_gradient_norms.at[st.k].set(
                    composite_gradient_norm)),
            relative_composite_gradient_norms=(
                st.relative_composite_gradient_norms.at[st.k].set(
                    relative_norm)),
            linesearch_iterations=(
                st.linesearch_iterations.at[st.k].set(ls_iters)),
            iterates=it,
        )

        # Terminating user predicate with the reference callback's state
        # (``ProximalGradient.h:45-49``; see solve()): iterate/objective at
        # the START of the iteration, this iteration's composite gradient
        # norm, line-search count, update step, and objective decrease.
        if user_function is not None:
            user_stop = jnp.asarray(user_function(
                st.k, st.x_prev, st.F_prev, composite_gradient_norm,
                ls_iters, dx, st.F_prev - F_x))
        else:
            user_stop = jnp.asarray(False)

        converged = ((composite_gradient_norm
                      < params.composite_gradient_tolerance)
                     | (relative_norm
                        < params.relative_composite_gradient_tolerance))
        status = jnp.where(
            user_stop,
            ProximalGradientStatus.USER_FUNCTION.value,
            jnp.where(
                ls_failed,
                ProximalGradientStatus.LINESEARCH.value,
                jnp.where(
                    converged,
                    ProximalGradientStatus.PROX_GRAD_RESIDUAL.value,
                    ProximalGradientStatus.RUNNING.value))).astype(jnp.int32)

        # --- momentum update (reference ProximalGradient.h:376-403) ---
        if accelerated:
            t_prev = st.t_prev
            if params.adaptive_restart:
                restart = tree_dot(dx, tree_sub(y, x)) > 0
                t_prev = jnp.where(restart, jnp.ones((), dtype), t_prev)
            t = (1.0 + jnp.sqrt(1.0 + 4.0 * t_prev * t_prev)) / 2.0
            y_new = tree_axpy((t_prev - 1.0) / t, dx, x)
            t_new = t
        else:
            y_new = x
            t_new = st.t_prev

        # On a line-search failure or a user stop the iterate is not advanced
        keep = ~ls_failed & ~user_stop
        return _State(
            k=st.k + 1,
            x=tree_where(keep, x, st.x),
            x_prev=tree_where(keep, x, st.x_prev),
            y=tree_where(keep, y_new, st.y),
            F_x=jnp.where(keep, F_x, st.F_x),
            F_prev=jnp.where(keep, F_x, st.F_prev),
            lam=lam,
            t_prev=jnp.where(keep, t_new, st.t_prev),
            status=status,
            dx=tree_where(keep, dx, st.dx),
            **traces,
        )

    def cond(st: _State):
        return ((st.k < params.max_iterations)
                & (st.status == ProximalGradientStatus.RUNNING.value))

    st = jax.lax.while_loop(cond, body, st0)
    status = jnp.where(st.status == ProximalGradientStatus.RUNNING.value,
                       ProximalGradientStatus.ITERATION_LIMIT.value,
                       st.status).astype(jnp.int32)

    return ProximalGradientResult(
        x=st.x, f=st.F_x, status=status, num_iterations=st.k,
        objective_values=st.objective_values,
        composite_gradient_norms=st.composite_gradient_norms,
        relative_composite_gradient_norms=(
            st.relative_composite_gradient_norms),
        linesearch_iterations=st.linesearch_iterations,
        dx=st.dx,
        times=jnp.full((n_trace,), pad_value(), jnp.float32),
        warm_start=(st.x_prev, st.y, st.t_prev, st.lam),
        iterates=st.iterates,
    )
