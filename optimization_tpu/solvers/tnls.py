"""Truncated-Newton nonlinear least squares (TNLS) over LSQR.

JAX re-design of the reference ``TNLS`` (``Riemannian/TNLS.h:265-765``):
minimizes L(x) = |F(x)| for a residual map F from a Riemannian manifold into a
Euclidean space, with a trust-region outer loop (one jitted ``lax.while_loop``)
whose subproblems  min_h |gradF(x) h + F(x)|^2, |h| <= Delta  are solved by the
``lsqr`` while-loop engine.  Jacobian and adjoint products default to
``jax.jvp`` / ``jax.vjp`` of the residual map — the user writes F only.

Functional contract (matching the reference exactly):

- gradient of the loss  gradL = gradF(x)' F(x) / |F(x)|  (``TNLS.h:425,638``);
- inexact-Newton forcing term  eta_k = min(|F|^theta, kappa_fgr) used as
  LSQR's btol (``TNLS.h:525``);
- optional *right* preconditioner pair (M, M'): LSQR operates in
  preconditioned coordinates and the update is un-preconditioned afterwards
  (``TNLS.h:428-456,534-539``);
- gain ratio on *squared* residual norms
  rho = (|F|^2 - |F+|^2) / (|F|^2 - |gradF h + F|^2)  (``TNLS.h:562-583``);
- ``Root`` status when |F(x)| < root_tolerance (``TNLS.h:508-512``);
- NaN rho rejects the step and shrinks the radius (``TNLS.h:594,644-648``);
- identical parameter names/defaults (``TNLS.h:107-169``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.debug import pad_value
from ..core.problem import LeastSquaresProblem
from ..core.tree import tree_neg, tree_where
from ..core.types import SmoothOptimizerParams, TNLSStatus
from ..linalg.lsqr import lsqr
from .tnt import step_decision

__all__ = ["TNLSParams", "TNLSResult", "solve"]


@dataclasses.dataclass(frozen=True)
class TNLSParams(SmoothOptimizerParams):
    """Mirrors ``TNLSParams`` (reference ``TNLS.h:107-169``)."""

    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_LSQR_iterations: int = 1000
    kappa_fgr: float = 0.1
    theta: float = 0.5
    lam: float = 0.0          # Tikhonov regularization for the subproblem
    Atol: float = 1e-6
    Acond_limit: float = 1e8
    root_tolerance: float = 1e-6
    Delta_tolerance: float = 1e-6

    def validate(self) -> None:
        super().validate()
        if self.Delta0 <= 0:
            raise ValueError(
                "Initial trust-region radius must be a positive real value")
        if not (0 < self.eta1 < 1):
            raise ValueError("eta1 must satisfy 0 < eta1 < 1")
        if self.eta1 > self.eta2 or self.eta2 >= 1:
            raise ValueError("eta2 must satisfy eta1 <= eta2 < 1")
        if not (0 < self.alpha1 < 1):
            raise ValueError("alpha1 must satisfy 0 < alpha1 < 1")
        if self.alpha2 <= 1:
            raise ValueError("alpha2 must satisfy alpha2 > 1")
        if not (0 < self.kappa_fgr < 1):
            raise ValueError("kappa_fgr must satisfy 0 < kappa_fgr < 1")
        if self.theta < 0:
            raise ValueError("theta must be a nonnegative real number")
        if self.lam < 0:
            raise ValueError("lambda must be a nonnegative real value")
        if self.root_tolerance < 0:
            raise ValueError("root_tolerance must be a nonnegative real value")
        if self.Delta_tolerance < 0:
            raise ValueError("Delta_tolerance must be a nonnegative real value")


class TNLSResult(NamedTuple):
    x: Any
    f: jnp.ndarray                # |F(x)| at the returned iterate
    gradfx_norm: jnp.ndarray      # |gradL(x)|
    status: jnp.ndarray           # TNLSStatus code
    num_iterations: jnp.ndarray
    objective_values: jnp.ndarray     # |F| trace
    gradient_norms: jnp.ndarray
    trust_region_radius: jnp.ndarray
    inner_iterations: jnp.ndarray
    update_step_norms: jnp.ndarray
    rho: jnp.ndarray
    # Wall-clock seconds per recorded iteration; NaN from the jitted solve,
    # filled by the host-chunked driver (core/driver.py).
    times: Optional[jnp.ndarray] = None
    iterates: Optional[Any] = None


class _State(NamedTuple):
    k: jnp.ndarray
    x: Any
    Fx: Any
    Fx_norm: jnp.ndarray
    Fx_sq: jnp.ndarray
    gradL_norm: jnp.ndarray
    Delta: jnp.ndarray
    status: jnp.ndarray
    objective_values: jnp.ndarray
    gradient_norms: jnp.ndarray
    trust_region_radius: jnp.ndarray
    inner_iterations: jnp.ndarray
    update_step_norms: jnp.ndarray
    rho: jnp.ndarray
    iterates: Optional[Any]


def solve(
    problem: LeastSquaresProblem,
    x0: Any,
    params: TNLSParams = TNLSParams(),
    data: Any = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
    Delta0=None,
) -> TNLSResult:
    """Minimize |F(x)| from ``x0``.

    ``user_function(k, x, Fx, Delta, inner_iters, h, dL, rho, accepted) ->
    bool`` is an optional pure stopping predicate (jittable analog of
    ``TNLSUserFunction``, reference ``TNLS.h:95-102,604-613``).

    ``Delta0`` optionally overrides ``params.Delta0`` with a traced scalar
    (warm-start seam for the host-chunked driver, core/driver.py).
    """
    params.validate()
    return _solve(problem, params, user_function, x0, data, Delta0)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _solve(problem: LeastSquaresProblem, params: TNLSParams,
           user_function, x0: Any, data: Any, Delta0) -> TNLSResult:
    M = problem.manifold
    n_trace = params.max_iterations + 1
    n_step = max(params.max_iterations, 1)  # 0-iteration solves must trace

    def residual_norms(x):
        Fx = problem.F(x, data)
        Fx_sq = problem.inner_Y(Fx, Fx, data)
        return Fx, Fx_sq, jnp.sqrt(Fx_sq)

    def gradL_norm_at(x, Fx, Fx_norm):
        g = problem.Jt(x, Fx, data)
        denom = jnp.where(Fx_norm > 0, Fx_norm, 1.0)
        g = jax.tree_util.tree_map(lambda l: l / denom, g)
        return jnp.sqrt(M.inner(x, g, g))

    Fx0, Fx_sq0, Fn0 = residual_norms(x0)
    dtype = Fn0.dtype
    gln0 = gradL_norm_at(x0, Fx0, Fn0)
    sqrt_eps = jnp.sqrt(jnp.finfo(dtype).eps)

    nan_trace = jnp.full((n_trace,), pad_value(), dtype)
    nan_step = jnp.full((n_step,), pad_value(), dtype)
    iterates0 = (jax.tree_util.tree_map(
        lambda l: jnp.zeros((n_trace,) + jnp.shape(l), jnp.asarray(l).dtype), x0)
        if params.log_iterates else None)

    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        x=x0, Fx=Fx0, Fx_norm=Fn0, Fx_sq=Fx_sq0, gradL_norm=gln0,
        Delta=jnp.asarray(params.Delta0 if Delta0 is None else Delta0, dtype),
        status=jnp.asarray(TNLSStatus.RUNNING.value, jnp.int32),
        objective_values=nan_trace,
        gradient_norms=nan_trace,
        trust_region_radius=nan_trace,
        inner_iterations=jnp.zeros((n_step,), jnp.int32),
        update_step_norms=nan_step,
        rho=nan_step,
        iterates=iterates0,
    )

    def record(st: _State) -> _State:
        it = st.iterates
        if it is not None:
            it = jax.tree_util.tree_map(
                lambda tr, l: tr.at[st.k].set(l), it, st.x)
        return st._replace(
            objective_values=st.objective_values.at[st.k].set(st.Fx_norm),
            gradient_norms=st.gradient_norms.at[st.k].set(st.gradL_norm),
            trust_region_radius=st.trust_region_radius.at[st.k].set(st.Delta),
            iterates=it,
        )

    def do_iter(st: _State) -> _State:
        ridx = st.k - 1
        x, Fx = st.x, st.Fx

        # Jacobian pair built once per outer iterate (reference TNLS.h:422);
        # with a right preconditioner (Mp, Mpt) LSQR works in the
        # preconditioned coordinate system (reference TNLS.h:428-456)
        J_op, Jt_op = problem.jacobian(x, data)
        if problem.precon is not None:
            Mp, Mpt = problem.precon
            A_op = lambda v: J_op(Mp(x, v, data))
            At_op = lambda w: Mpt(x, Jt_op(w), data)
        else:
            A_op = J_op
            At_op = Jt_op
        inner_X = lambda u, v: M.inner(x, u, v)
        inner_Y = lambda u, v: problem.inner_Y(u, v, data)

        # Forcing term (reference TNLS.h:525)
        etak = jnp.minimum(st.Fx_norm**params.theta, params.kappa_fgr)

        ls = lsqr(A_op, At_op, tree_neg(Fx), inner_X, inner_Y,
                  max_iterations=params.max_LSQR_iterations,
                  lam=params.lam, btol=etak, Atol=params.Atol,
                  cond_limit=params.Acond_limit, Delta=st.Delta)
        h, h_M_norm = ls.x, ls.xnorm
        if problem.precon is not None:
            h = Mp(x, h, data)  # back to un-preconditioned coordinates
        h_norm = jnp.sqrt(M.inner(x, h, h))

        # Trial point and gain ratio on squared residuals (TNLS.h:551-583).
        # The linearized squared residual |J h + F|^2 comes from LSQR's
        # plane-rotation recurrence (lsqr.py: LSQRResult.rsq) instead of the
        # reference's explicit gradFx(x, h) product (TNLS.h:565-572) —
        # identical in exact arithmetic (incl. the TR-boundary clip), and it
        # removes one whole Jacobian application per outer iteration AND the
        # second J subgraph from the compiled program (the same
        # program-shrinking move as STPCG's predicted_decrease recurrence).
        x_prop = M.retract(x, h)
        Fx_prop, Fx_prop_sq, Fn_prop = residual_norms(x_prop)
        dq = st.Fx_sq - ls.rsq
        dL = st.Fx_norm - Fn_prop
        df2 = st.Fx_sq - Fx_prop_sq
        relative_decrease = dL / (sqrt_eps + st.Fx_norm)
        rho = df2 / dq
        # dq <= 0 is a numerical failure flag treated like a NaN rho
        # (reject + shrink) — see solvers/tnt.py:step_decision.
        accepted, very_successful, unsuccessful = step_decision(
            rho, dq, params.eta1, params.eta2)

        if user_function is not None:
            user_stop = jnp.asarray(user_function(
                ridx, x, Fx, st.Delta, ls.num_iterations, h, dL, rho, accepted))
        else:
            user_stop = jnp.asarray(False)

        apply = accepted & ~user_stop
        x_new = tree_where(apply, x_prop, x)
        Fx_new = tree_where(apply, Fx_prop, Fx)
        Fn_new = jnp.where(apply, Fn_prop, st.Fx_norm)
        Fsq_new = jnp.where(apply, Fx_prop_sq, st.Fx_sq)
        gln_acc = gradL_norm_at(x_new, Fx_new, Fn_new)
        gln_new = jnp.where(apply, gln_acc, st.gradL_norm)

        status = jnp.where(
            user_stop,
            TNLSStatus.USER_FUNCTION.value,
            jnp.where(
                apply & (relative_decrease < params.relative_decrease_tolerance),
                TNLSStatus.RELATIVE_DECREASE.value,
                jnp.where(apply & (h_norm < params.stepsize_tolerance),
                          TNLSStatus.STEPSIZE.value,
                          TNLSStatus.RUNNING.value))).astype(jnp.int32)

        # Trust-region radius update (same scheme as TNT; TNLS.h:643-657)
        Delta_new = jnp.where(
            very_successful,
            jnp.maximum(params.alpha2 * h_M_norm, st.Delta),
            jnp.where(unsuccessful, params.alpha1 * h_M_norm, st.Delta))
        tr_collapse = unsuccessful & (Delta_new < params.Delta_tolerance)
        running = status == TNLSStatus.RUNNING.value
        Delta_new = jnp.where(running, Delta_new, st.Delta)
        status = jnp.where(running & tr_collapse,
                           TNLSStatus.TRUST_REGION.value, status).astype(jnp.int32)

        return st._replace(
            x=x_new, Fx=Fx_new, Fx_norm=Fn_new, Fx_sq=Fsq_new,
            gradL_norm=gln_new, Delta=Delta_new, status=status,
            inner_iterations=st.inner_iterations.at[ridx].set(
                ls.num_iterations.astype(jnp.int32)),
            update_step_norms=st.update_step_norms.at[ridx].set(h_norm),
            rho=st.rho.at[ridx].set(rho),
        )

    def body(st: _State) -> _State:
        st = record(st)
        st = st._replace(k=st.k + 1)
        conv_status = jnp.where(
            st.Fx_norm < params.root_tolerance,
            TNLSStatus.ROOT.value,
            jnp.where(st.gradL_norm < params.gradient_tolerance,
                      TNLSStatus.GRADIENT.value,
                      TNLSStatus.RUNNING.value)).astype(jnp.int32)
        return jax.lax.cond(
            conv_status != TNLSStatus.RUNNING.value,
            lambda s: s._replace(status=conv_status),
            do_iter,
            st)

    def cond(st: _State):
        return ((st.k < params.max_iterations)
                & (st.status == TNLSStatus.RUNNING.value))

    st = jax.lax.while_loop(cond, body, st0)
    status = jnp.where(st.status == TNLSStatus.RUNNING.value,
                       TNLSStatus.ITERATION_LIMIT.value,
                       st.status).astype(jnp.int32)
    st = record(st)

    return TNLSResult(
        x=st.x, f=st.Fx_norm, gradfx_norm=st.gradL_norm,
        status=status, num_iterations=st.k,
        objective_values=st.objective_values,
        gradient_norms=st.gradient_norms,
        trust_region_radius=st.trust_region_radius,
        inner_iterations=st.inner_iterations,
        update_step_norms=st.update_step_norms,
        rho=st.rho,
        times=jnp.full((n_trace,), pad_value(), jnp.float32),
        iterates=st.iterates,
    )
