"""ADMM (alternating direction method of multipliers), optionally
Nesterov-accelerated, for problems of the form

    min  f(x) + g(y)   s.t.   A x + B y = c

JAX re-design of the reference ``ADMM`` (``Convex/ADMM.h:265-645``).
The user supplies the two augmented-Lagrangian minimizers ``minLx``/``minLy``
(reference ``ADMM.h:45-53``) plus the linear operators A, B, A'; the solver
owns the outer loop as a single jitted ``lax.while_loop``.  Consensus-form
scenario sharding (per-shard x-updates + psum averaging) is built on top in
``optimization_tpu.parallel.consensus``.

Functional contract (matching the reference exactly):

- dual update  lambda+ = lambda(+hat) + rho (A x + B y - c)  (``ADMM.h:399-402``);
- monotone merit  m_k = sqrt(rho |B dy|^2 + rho |r|^2); accelerated step
  accepted iff m_k < eta m_{k-1}, else restart with alpha = 1, y_hat = y_prev
  (Goldstein et al. Alg. 8; ``ADMM.h:404-451``);
- modified dual residual  s = rho A'(B y - B y_hat|B y_prev)  held over
  restart iterations (``ADMM.h:453-468``);
- combined absolute+relative stopping on primal/dual residuals
  (Boyd Sec. 3.3.1; ``ADMM.h:526-543``);
- He-Yang-Wang residual-balancing rho adaptation inside a window, which in
  accelerated mode forces a restart (``ADMM.h:545-566``);
- identical parameter names/defaults (``ADMM.h:104-183``).
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.debug import pad_value
from ..core.tree import tree_axpy, tree_dot, tree_sub, tree_where
from ..core.types import ADMMIterationType, ADMMStatus, OptimizerParams

__all__ = ["ADMMMode", "ADMMPenaltyAdaptation", "ADMMParams", "ADMMProblem",
           "ADMMResult", "solve"]


class ADMMMode(enum.Enum):
    SIMPLE = "simple"
    ACCELERATED = "accelerated"


class ADMMPenaltyAdaptation(enum.Enum):
    NONE = "none"
    RESIDUAL_BALANCE = "residual_balance"


@dataclasses.dataclass(frozen=True)
class ADMMParams(OptimizerParams):
    """Mirrors ``ADMMParams`` (reference ``ADMM.h:104-183``)."""

    rho: float = 1.0
    penalty_adaptation_mode: ADMMPenaltyAdaptation = ADMMPenaltyAdaptation.NONE
    penalty_adaptation_period: int = 2
    penalty_adaptation_window: int = 2**62
    residual_balance_mu: float = 10.0
    residual_balance_tau: float = 2.0
    mode: ADMMMode = ADMMMode.SIMPLE
    eta: float = 0.999
    eps_abs_pri: float = 1e-2
    eps_abs_dual: float = 1e-2
    eps_rel: float = 1e-3

    def validate(self) -> None:
        super().validate()
        if self.rho <= 0:
            raise ValueError("Penalty parameter (rho) must be a positive real value")
        if not (0 < self.eta < 1):
            raise ValueError("Acceleration acceptance threshold (eta) must be in (0,1)")
        if self.residual_balance_mu <= 1:
            raise ValueError("residual_balance_mu must be greater than 1")
        if self.residual_balance_tau <= 1:
            raise ValueError("residual_balance_tau must be greater than 1")


@dataclasses.dataclass(frozen=True, eq=False)
class ADMMProblem:
    """The user-supplied seam of the ADMM splitting (reference ``ADMM.h:45-53``).

    - ``minLx(y, lam, rho, data) -> x``: argmin_x L_rho(x, y; lam)
    - ``minLy(x, lam, rho, data) -> y``: argmin_y L_rho(x, y; lam)
    - ``A(x, data)``, ``B(y, data)``, ``At(r, data)``: linear operators.
    """

    minLx: Callable[..., Any]
    minLy: Callable[..., Any]
    A: Callable[..., Any]
    B: Callable[..., Any]
    At: Callable[..., Any]
    inner_x: Optional[Callable[..., Any]] = None
    inner_r: Optional[Callable[..., Any]] = None

    def ipx(self, u, v):
        return (self.inner_x or (lambda a, b: tree_dot(a, b)))(u, v)

    def ipr(self, u, v):
        return (self.inner_r or (lambda a, b: tree_dot(a, b)))(u, v)


class ADMMResult(NamedTuple):
    x: Any
    y: Any               # y_hat in accelerated mode (reference ADMM.h:592-593)
    lam: Any             # lambda_hat in accelerated mode
    status: jnp.ndarray
    num_iterations: jnp.ndarray
    primal_residuals: jnp.ndarray
    dual_residuals: jnp.ndarray
    m_k: jnp.ndarray
    penalty_parameters: jnp.ndarray
    iteration_types: jnp.ndarray   # ADMMIterationType codes
    # The LAST iteration's primal residual VECTOR r = Ax + By - c and
    # (restart-held) dual residual VECTOR s = rho A'(By - By_ref) — the
    # reference callback's ``r``/``s`` (``ADMM.h:71-76``); at
    # chunk_iterations=1 the host driver's observer sees them per iteration.
    r: Optional[Any] = None
    s: Optional[Any] = None
    # Wall-clock seconds per recorded iteration; NaN from the jitted solve,
    # filled by the host-chunked driver (core/driver.py).
    times: Optional[jnp.ndarray] = None
    # Per-iteration x history when ``params.log_iterates`` (reference
    # ``ADMM.h:514-515`` via ``Base/Concepts.h:50-52``); else None.
    iterates: Optional[Any] = None
    # Full internal loop state; pass back as ``warm_start=`` to resume the
    # iteration (including acceleration history) exactly.
    warm_start: Optional[tuple] = None


class _State(NamedTuple):
    k: jnp.ndarray
    x: Any
    y: Any
    lam: Any
    rho: jnp.ndarray
    y_prev: Any
    By_prev: Any
    y_hat: Any
    lam_hat: Any
    lam_prev: Any
    alpha: jnp.ndarray
    m_prev: jnp.ndarray
    dual_residual: jnp.ndarray
    iteration_type: jnp.ndarray
    r_vec: Any           # last primal residual vector
    s_vec: Any           # last (restart-held) dual residual vector
    status: jnp.ndarray
    primal_residuals: jnp.ndarray
    dual_residuals: jnp.ndarray
    m_trace: jnp.ndarray
    penalty_parameters: jnp.ndarray
    iteration_types: jnp.ndarray
    iterates: Optional[Any]


def solve(
    problem: ADMMProblem,
    c: Any,
    x0: Any,
    y0: Any,
    params: ADMMParams = ADMMParams(),
    data: Any = None,
    warm_start: Optional[tuple] = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
) -> ADMMResult:
    """``warm_start`` is a ``result.warm_start`` tuple from a previous solve:
    resumes the loop state (dual variable, penalty, acceleration history)
    exactly (the seam used by the host-chunked driver, core/driver.py).

    ``user_function(k, x, y, lam, rho, r, s) -> bool`` is an optional pure
    stopping predicate evaluated once per iteration with the arguments of the
    reference's ``ADMMUserFunction`` (``ADMM.h:71-76``: iteration, the
    iterates/dual/penalty at the END of the iteration, and the primal/dual
    residual VECTORS ``r``/``s``) — but *terminating*, like the other
    engines' user functions (the reference's is a void observer; elapsed
    time ``t`` cannot exist inside a compiled loop — the host driver's
    observer at ``chunk_iterations=1`` supplies it).  A True return stops
    the solve with status USER_FUNCTION after the iteration's updates."""
    params.validate()
    return _solve(problem, params, user_function, c, x0, y0, data, warm_start)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _solve(problem: ADMMProblem, params: ADMMParams, user_function,
           c: Any, x0: Any, y0: Any, data: Any,
           warm_start) -> ADMMResult:
    accelerated = params.mode == ADMMMode.ACCELERATED
    balance = (params.penalty_adaptation_mode
               == ADMMPenaltyAdaptation.RESIDUAL_BALANCE)
    n_trace = max(params.max_iterations, 1)  # 0-iteration solves must trace

    A = lambda x: problem.A(x, data)
    B = lambda y: problem.B(y, data)
    At = lambda r: problem.At(r, data)

    c_norm = jnp.sqrt(problem.ipr(c, c))
    dtype = c_norm.dtype
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    # --- initialization (reference ADMM.h:338-360) ---
    if warm_start is None:
        rho0 = jnp.asarray(params.rho, dtype)
        Ax0 = A(x0)
        By0 = B(y0)
        r0 = tree_sub(tree_axpy(1.0, Ax0, By0), c)
        lam0 = jax.tree_util.tree_map(lambda l: rho0 * l, r0)
        carry0 = dict(
            y_prev=y0, By_prev=By0, y_hat=y0, lam_hat=lam0, lam_prev=lam0,
            alpha=jnp.ones((), dtype), m_prev=big, dual_residual=big,
            iteration_type=jnp.asarray(
                (ADMMIterationType.RESTART if accelerated
                 else ADMMIterationType.STANDARD).value, jnp.int32))
    else:
        lam0, rho0, carry0 = warm_start

    nan_trace = jnp.full((n_trace,), pad_value(), dtype)
    iterates0 = (jax.tree_util.tree_map(
        lambda l: jnp.zeros((n_trace,) + jnp.shape(l), jnp.asarray(l).dtype),
        x0) if params.log_iterates else None)
    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        x=x0, y=y0, lam=lam0, rho=rho0,
        **carry0,
        r_vec=jax.tree_util.tree_map(jnp.zeros_like, c),
        s_vec=jax.tree_util.tree_map(jnp.zeros_like, x0),
        status=jnp.asarray(ADMMStatus.RUNNING.value, jnp.int32),
        primal_residuals=nan_trace,
        dual_residuals=nan_trace,
        m_trace=nan_trace,
        penalty_parameters=nan_trace,
        iteration_types=jnp.zeros((n_trace,), jnp.int32),
        iterates=iterates0,
    )

    def body(st: _State) -> _State:
        y_in = st.y_hat if accelerated else st.y
        lam_in = st.lam_hat if accelerated else st.lam

        # --- x / y / lambda updates (reference ADMM.h:378-402) ---
        x = problem.minLx(y_in, lam_in, st.rho, data)
        y = problem.minLy(x, lam_in, st.rho, data)
        Ax = A(x)
        By = B(y)
        r = tree_sub(tree_axpy(1.0, Ax, By), c)
        primal = jnp.sqrt(problem.ipr(r, r))
        lam = tree_axpy(st.rho, r, lam_in)

        # --- monotone merit m_k (reference ADMM.h:404-410) ---
        By_ref = B(st.y_hat) if accelerated else st.By_prev
        By_diff = tree_sub(By, By_ref)
        m_k = jnp.sqrt(st.rho * problem.ipr(r, r)
                       + st.rho * problem.ipr(By_diff, By_diff))

        # --- Nesterov acceleration / restart (reference ADMM.h:416-451) ---
        if accelerated:
            accept = m_k < params.eta * st.m_prev
            alpha_next_acc = (1.0 + jnp.sqrt(1.0 + 4.0 * st.alpha**2)) / 2.0
            w = (st.alpha - 1.0) / alpha_next_acc
            y_hat_acc = tree_axpy(w, tree_sub(y, st.y_prev), y)
            lam_hat_acc = tree_axpy(w, tree_sub(lam, st.lam_prev), lam)
            type_acc = jnp.where(
                st.iteration_type == ADMMIterationType.RESTART.value,
                ADMMIterationType.STANDARD.value,
                ADMMIterationType.ACCELERATED.value).astype(jnp.int32)

            alpha_next = jnp.where(accept, alpha_next_acc, 1.0)
            y_hat = tree_where(accept, y_hat_acc, st.y_prev)
            lam_hat = tree_where(accept, lam_hat_acc, lam)
            m_k = jnp.where(accept, m_k, st.m_prev)
            itype = jnp.where(accept, type_acc,
                              ADMMIterationType.RESTART.value).astype(jnp.int32)
        else:
            alpha_next = st.alpha
            y_hat = st.y_hat
            lam_hat = st.lam_hat
            itype = jnp.asarray(ADMMIterationType.STANDARD.value, jnp.int32)

        # --- dual residual, held over restarts (reference ADMM.h:461-468) ---
        dual_ref = tree_where(
            itype == ADMMIterationType.ACCELERATED.value,
            B(y_hat), st.By_prev) if accelerated else st.By_prev
        s = jax.tree_util.tree_map(
            lambda l: st.rho * l, At(tree_sub(By, dual_ref)))
        dual_now = jnp.sqrt(problem.ipx(s, s))
        is_restart = itype == ADMMIterationType.RESTART.value
        dual = jnp.where(is_restart, st.dual_residual, dual_now)
        # the dual residual VECTOR, held over restarts exactly like its norm
        # (exposed through the result / user callback, reference ADMM.h:71-76)
        s_held = tree_where(is_restart, st.s_vec, s)

        # --- record traces (iterate history per reference ADMM.h:514-515) ---
        traces = dict(
            primal_residuals=st.primal_residuals.at[st.k].set(primal),
            dual_residuals=st.dual_residuals.at[st.k].set(dual),
            m_trace=st.m_trace.at[st.k].set(m_k),
            penalty_parameters=st.penalty_parameters.at[st.k].set(st.rho),
            iteration_types=st.iteration_types.at[st.k].set(itype),
            iterates=(None if st.iterates is None else
                      jax.tree_util.tree_map(
                          lambda tr, l: tr.at[st.k].set(l), st.iterates, x)),
        )

        # --- stopping criteria (reference ADMM.h:526-543) ---
        Ax_norm = jnp.sqrt(problem.ipr(Ax, Ax))
        By_norm = jnp.sqrt(problem.ipr(By, By))
        eps_pri = (params.eps_abs_pri + params.eps_rel
                   * jnp.maximum(jnp.maximum(Ax_norm, By_norm), c_norm))
        At_lam = At(lam)
        eps_dual = (params.eps_abs_dual
                    + params.eps_rel * jnp.sqrt(problem.ipx(At_lam, At_lam)))
        stop = (primal < eps_pri) & (dual < eps_dual)
        status = jnp.where(stop, ADMMStatus.RESIDUAL_TOLERANCE.value,
                           ADMMStatus.RUNNING.value).astype(jnp.int32)

        # --- penalty adaptation (reference ADMM.h:545-566) ---
        rho = st.rho
        if balance:
            adapt = ((jnp.mod(st.k, params.penalty_adaptation_period) == 0)
                     & (st.k < params.penalty_adaptation_window) & ~stop)
            rho_up = jnp.where(primal > params.residual_balance_mu * dual,
                               rho * params.residual_balance_tau, rho)
            rho_new = jnp.where(dual > params.residual_balance_mu * primal,
                                rho / params.residual_balance_tau, rho_up)
            changed = adapt & (rho_new != rho)
            rho = jnp.where(adapt, rho_new, rho)
            if accelerated:
                # A rho change invalidates the merit history: force a restart
                alpha_next = jnp.where(changed, 1.0, alpha_next)
                y_hat = tree_where(changed, st.y_prev, y_hat)
                lam_hat = tree_where(changed, lam, lam_hat)
                itype = jnp.where(changed, ADMMIterationType.RESTART.value,
                                  itype).astype(jnp.int32)

        m_prev = (jnp.where(itype == ADMMIterationType.RESTART.value, big, m_k)
                  if accelerated else m_k)

        # Terminating user predicate with the reference callback's
        # end-of-iteration state (``ADMM.h:71-76``; see solve()) — evaluated
        # after the penalty adaptation so ``rho`` is the end-of-iteration
        # value, with the residual VECTORS r / (restart-held) s.
        if user_function is not None:
            user_stop = jnp.asarray(user_function(
                st.k, x, y, lam, rho, r, s_held))
            status = jnp.where(user_stop, ADMMStatus.USER_FUNCTION.value,
                               status).astype(jnp.int32)

        return _State(
            k=st.k + 1,
            x=x, y=y, lam=lam, rho=rho,
            y_prev=y, By_prev=By,
            y_hat=y_hat, lam_hat=lam_hat, lam_prev=lam,
            alpha=alpha_next, m_prev=m_prev,
            dual_residual=dual, iteration_type=itype,
            r_vec=r, s_vec=s_held, status=status,
            **traces,
        )

    def cond(st: _State):
        return ((st.k < params.max_iterations)
                & (st.status == ADMMStatus.RUNNING.value))

    st = jax.lax.while_loop(cond, body, st0)
    status = jnp.where(st.status == ADMMStatus.RUNNING.value,
                       ADMMStatus.ITERATION_LIMIT.value,
                       st.status).astype(jnp.int32)

    carry_out = dict(
        y_prev=st.y_prev, By_prev=st.By_prev, y_hat=st.y_hat,
        lam_hat=st.lam_hat, lam_prev=st.lam_prev, alpha=st.alpha,
        m_prev=st.m_prev, dual_residual=st.dual_residual,
        iteration_type=st.iteration_type)
    return ADMMResult(
        x=st.x,
        y=st.y_hat if accelerated else st.y,
        lam=st.lam_hat if accelerated else st.lam,
        status=status, num_iterations=st.k,
        primal_residuals=st.primal_residuals,
        dual_residuals=st.dual_residuals,
        m_k=st.m_trace,
        penalty_parameters=st.penalty_parameters,
        iteration_types=st.iteration_types,
        r=st.r_vec, s=st.s_vec,
        times=jnp.full((n_trace,), pad_value(), jnp.float32),
        iterates=st.iterates,
        warm_start=(st.lam, st.rho, carry_out),
    )
