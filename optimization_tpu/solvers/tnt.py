"""Riemannian truncated-Newton trust-region (TNT) method.

JAX re-design of the reference ``TNT`` (``Riemannian/TNT.h:242-689``,
Algorithm 6.1.1 of Conn-Gould-Toint): the outer trust-region loop is a jitted
``lax.while_loop`` whose inner subproblem solve is the ``stpcg`` while-loop
engine, so a full solve — Hessian-vector products, CG recurrences, gain-ratio
logic, radius adaptation, traces — compiles to one XLA program.  The
Hessian-vector product defaults to ``jax.jvp`` of the Riemannian gradient
field (users never write a Hessian), and every inner-product reduction flows
through the manifold metric seam, which becomes a ``psum`` collective when the
tangent space is sharded over a mesh.

Functional contract (matching the reference exactly):

- model decrease  dm = -<g,h> - 1/2 <h,Hh>, gain ratio rho = df/dm, accept
  iff  !isnan(rho) && rho > eta1  (``TNT.h:511-532``);
- radius update: very successful (rho >= eta2) -> Delta = max(alpha2*|h|_M,
  Delta); unsuccessful -> Delta = alpha1*|h|_M with the TrustRegion stop when
  Delta < Delta_tolerance (``TNT.h:590-603``).  NaN rho rejects and shrinks;
- stopping: |g| < gradient_tolerance, |M^{-1}g| <
  preconditioned_gradient_tolerance, relative decrease, stepsize, trust
  region, iteration limit, user function (``TNT.h:134-164``);
- identical parameter names/defaults (``TNT.h:76-130``).

Deviation (documented): on an accepted step the reference defers the gradient
re-evaluation until after its relative-decrease/stepsize checks, so a solve
stopped by those criteria reports the *previous* iterate's gradient norm; we
always report the gradient at the returned iterate.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.debug import pad_value
from ..core.problem import RiemannianProblem
from ..core.tree import tree_where
from ..core.types import SmoothOptimizerParams, TNTStatus
from ..linalg.stpcg import stpcg

__all__ = ["TNTParams", "TNTResult", "solve", "solve_escalated",
           "EscalatedResult"]


@dataclasses.dataclass(frozen=True)
class TNTParams(SmoothOptimizerParams):
    """Mirrors ``TNTParams`` (reference ``TNT.h:76-130``)."""

    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_TPCG_iterations: int = 1000
    kappa_fgr: float = 0.1
    theta: float = 0.5
    preconditioned_gradient_tolerance: float = 1e-6
    Delta_tolerance: float = 1e-6
    # New (no reference counterpart): CG iterations advanced per reduction
    # sync in the flat engine (linalg/flat_cg.py s_steps; only used when
    # problem.flat_qm is set).  Default 1 = the pair-deferred engine, the
    # choice for huge-n subproblems (single XLA fusion per iteration);
    # s >= 2 (the coefficient-space s-step engine) can pay off only for
    # small-n / cheap-operator subproblems where the per-sync charge
    # dominates (see flat_cg.py module docstring).
    flat_s_steps: int = 1
    # New (no reference counterpart): drop the flat engine's kernel-of-H
    # epsilon safeguard (linalg/flat_cg.py stpcg_flat kernel_check),
    # pruning two reduction outputs + one A-application from the fused
    # pass.  No device measured yet has gained from it
    # (benchmarks/probe_ugroup.py), so the default stays True everywhere;
    # the flag is a tested, semantically-safe opt-in.
    # Only valid when the quadratic model certifies no eps-kernel along
    # CG directions; pair engine (flat_s_steps=1) only.
    flat_kernel_check: bool = True
    # New (documented extension, like the dm > 0 guard in
    # step_decision): sub-epsilon FLOOR ACCEPTANCE.  Near the optimum the
    # true per-step decrease can fall below the objective's floating-point
    # resolution while the gradient is still large in high-curvature
    # modes (observed: bf16->f32 escalation on the Rayleigh config — the
    # promoted iterate's error lives in modes where |grad| ~ 4e-3 but
    # f - f* ~ 4e-9 < eps_f32); the reference acceptance rho > eta1 then
    # rejects every Newton step (df rounds to 0) and collapses the trust
    # region, even though the steps are genuinely contracting |grad|.
    # With this flag, a step whose PREDICTED decrease is below objective
    # resolution (dm <= 4 eps (|f| + eps)) is accepted on the model's
    # word provided the objective did not measurably increase
    # (df >= -4 eps (|f| + eps)); the radius is left unchanged for such
    # steps.  The possible true increase is bounded by rounding scale.
    # Off by default (reference semantics); solve_escalated enables it
    # for the high-precision finishing stage.
    floor_acceptance: bool = False

    def validate(self) -> None:
        super().validate()
        if self.preconditioned_gradient_tolerance < 0:
            raise ValueError(
                "Preconditioned gradient tolerance must be a nonnegative real value")
        if self.Delta_tolerance < 0:
            raise ValueError(
                "Trust-region radius tolerance must be a nonnegative real value")
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
        if not (1 <= self.flat_s_steps <= 3):
            raise ValueError("flat_s_steps must be 1, 2, or 3")
        if not self.flat_kernel_check and self.flat_s_steps > 1:
            raise ValueError("flat_kernel_check=False requires the pair "
                             "engine (flat_s_steps=1)")


class TNTResult(NamedTuple):
    x: Any
    f: jnp.ndarray
    gradfx_norm: jnp.ndarray
    preconditioned_grad_f_x_norm: jnp.ndarray
    status: jnp.ndarray           # TNTStatus code
    num_iterations: jnp.ndarray   # outer iterations entered
    # Traces over outer iterations; entries [0, num_iterations] valid.
    objective_values: jnp.ndarray
    gradient_norms: jnp.ndarray
    preconditioned_gradient_norms: jnp.ndarray
    trust_region_radius: jnp.ndarray
    # Per attempted step (entries [0, num_iterations) valid):
    inner_iterations: jnp.ndarray
    update_step_norms: jnp.ndarray
    update_step_M_norms: jnp.ndarray
    gain_ratios: jnp.ndarray
    # Wall-clock seconds per recorded iteration; NaN from the jitted solve,
    # filled by the host-chunked driver (core/driver.py) — see core/host.py.
    times: Optional[jnp.ndarray] = None
    iterates: Optional[Any] = None


class _State(NamedTuple):
    k: jnp.ndarray
    x: Any
    f: jnp.ndarray
    grad: Any
    gradnorm: jnp.ndarray
    pgradnorm: jnp.ndarray
    Delta: jnp.ndarray
    status: jnp.ndarray
    objective_values: jnp.ndarray
    gradient_norms: jnp.ndarray
    preconditioned_gradient_norms: jnp.ndarray
    trust_region_radius: jnp.ndarray
    inner_iterations: jnp.ndarray
    update_step_norms: jnp.ndarray
    update_step_M_norms: jnp.ndarray
    gain_ratios: jnp.ndarray
    iterates: Optional[Any]
    # Auxiliary PyTree from problem.step_eval's optional 5th output,
    # threaded into flat_qm(x, data, aux); None when unused.
    aux: Optional[Any]


def step_decision(rho, dm, eta1, eta2):
    """Trust-region step decision ``(accepted, very_successful,
    unsuccessful)`` from the gain ratio and the model decrease.

    Reference semantics (``TNT.h:511-532,590-603``): accept iff
    ``!isnan(rho) && rho > eta1``; a NaN rho rejects and shrinks.  One
    extension: ``dm > 0`` is guaranteed for an exact-arithmetic
    STPCG/LSQR step, so a non-positive model decrease is a numerical
    failure flag treated exactly like a NaN rho.  The reference's f64
    arithmetic never trips the hole; in f32, ``df < 0`` with ``dm < 0``
    yields a large POSITIVE rho and, unguarded, accepts an
    objective-increasing step (observed: 10^4-pose marginalized SE-Sync,
    1000 capped inner CG iterations, rho = +7e4, |grad| 7e-3 -> 1.9e2).
    Shared by TNT and TNLS (there ``dm`` is the Gauss-Newton model
    decrease ``dq``; ``TNLS.h:562-594``).
    """
    model_ok = dm > 0
    accepted = ~jnp.isnan(rho) & (rho > eta1) & model_ok
    very_successful = ~jnp.isnan(rho) & (rho >= eta2) & model_ok
    unsuccessful = jnp.isnan(rho) | (rho < eta1) | ~model_ok
    return accepted, very_successful, unsuccessful


def solve(
    problem: RiemannianProblem,
    x0: Any,
    params: TNTParams = TNTParams(),
    data: Any = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
    Delta0=None,
) -> TNTResult:
    """Minimize ``problem`` from ``x0`` by truncated-Newton trust region.

    ``user_function(k, x, f, grad, Delta, inner_iters, h, df, rho, accepted)
    -> bool`` is an optional pure stopping predicate called once per outer
    iteration before the update is applied (jittable analog of
    ``TNTUserFunction``, reference ``TNT.h:64-71,545-552``).

    ``Delta0`` optionally overrides ``params.Delta0`` with a *traced* scalar —
    the warm-start seam used by the host-chunked driver (core/driver.py) to
    resume a solve without recompiling.
    """
    params.validate()
    return _solve(problem, params, user_function, x0, data, Delta0)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _solve(problem: RiemannianProblem, params: TNTParams,
           user_function, x0: Any, data: Any, Delta0) -> TNTResult:
    M = problem.manifold
    n_trace = params.max_iterations + 1
    # max(1, .) so zero-iteration solves still trace (the loop body indexes
    # the step traces even though it never executes)
    n_step = max(params.max_iterations, 1)

    def grad_and_norms(x):
        g = problem.rgrad(x, data)
        gn = jnp.sqrt(M.inner(x, g, g))
        if problem.precon is not None:
            pg = problem.apply_precon(x, g, data)
            pgn = jnp.sqrt(M.inner(x, pg, pg))
        else:
            pgn = gn
        return g, gn, pgn

    # Seed the step_eval aux carry (h = 0: the trial point is retract(x0,
    # 0), i.e. x0 up to the evaluator's normalization), and learn
    # statically whether the evaluator supplies one.  With an evaluator,
    # the initial point/objective/gradient are taken FROM the seed call:
    # one fused pass instead of separate value/grad passes, and — when the
    # aux carries a FlatCGInit — the seeded dot group is self-consistent
    # with the first subproblem's actual r0 = grad even if the caller's
    # x0 was not exactly on the manifold (the evaluator normalizes both).
    use_step_eval = (problem.step_eval is not None
                     and problem.precon is None)
    aux0 = None
    if use_step_eval:
        out0 = problem.step_eval(
            x0, jax.tree_util.tree_map(jnp.zeros_like, x0), data)
        x0, f0, g0, gn0 = out0[0], jnp.asarray(out0[1]), out0[2], out0[3]
        pgn0 = gn0
        if len(out0) >= 5:
            aux0 = out0[4]
    else:
        f0 = jnp.asarray(problem.value(x0, data))
        g0, gn0, pgn0 = grad_and_norms(x0)
    dtype = f0.dtype
    sqrt_eps = jnp.sqrt(jnp.finfo(dtype).eps)

    nan_trace = jnp.full((n_trace,), pad_value(), dtype)
    nan_step = jnp.full((n_step,), pad_value(), dtype)
    iterates0 = (jax.tree_util.tree_map(
        lambda l: jnp.zeros((n_trace,) + jnp.shape(l), jnp.asarray(l).dtype), x0)
        if params.log_iterates else None)

    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        x=x0, f=f0, grad=g0, gradnorm=gn0, pgradnorm=pgn0,
        Delta=jnp.asarray(params.Delta0 if Delta0 is None else Delta0, dtype),
        status=jnp.asarray(TNTStatus.RUNNING.value, jnp.int32),
        objective_values=nan_trace,
        gradient_norms=nan_trace,
        preconditioned_gradient_norms=nan_trace,
        trust_region_radius=nan_trace,
        inner_iterations=jnp.zeros((n_step,), jnp.int32),
        update_step_norms=nan_step,
        update_step_M_norms=nan_step,
        gain_ratios=nan_step,
        iterates=iterates0,
        aux=aux0,
    )

    def record(st: _State) -> _State:
        it = st.iterates
        if it is not None:
            it = jax.tree_util.tree_map(
                lambda tr, l: tr.at[st.k].set(l), it, st.x)
        return st._replace(
            objective_values=st.objective_values.at[st.k].set(st.f),
            gradient_norms=st.gradient_norms.at[st.k].set(st.gradnorm),
            preconditioned_gradient_norms=(
                st.preconditioned_gradient_norms.at[st.k].set(st.pgradnorm)),
            trust_region_radius=st.trust_region_radius.at[st.k].set(st.Delta),
            iterates=it,
        )

    def do_iter(st: _State) -> _State:
        ridx = st.k - 1  # per-step trace slot (k was already incremented)
        x, fx, grad = st.x, st.f, st.grad

        # Quadratic model built once per outer iterate (reference TNT.h:374-380):
        # the Hv closure reuses all x-dependent work across inner CG steps.
        inner = lambda u, v: M.inner(x, u, v)

        # STEP 2: trust-region subproblem (reference TNT.h:489-492) — via
        # the single-synchronization flat engine when the problem supplies
        # the structured Hessian (linalg/flat_cg.py), else generic STPCG.
        # A preconditioned problem stays on the flat engine iff it also
        # supplies the elementwise ``flat_prec`` seam (the hot-loop-native
        # preconditioning of reference IterativeSolvers.h:236-252,388-404).
        use_flat = problem.flat_qm is not None and (
            problem.precon is None or problem.flat_prec is not None)
        in_flat_branch = True
        if problem.flat_solve is not None and (
                problem.precon is None or problem.flat_prec is not None):
            # bring-your-own subproblem engine.  A preconditioned problem
            # stays on this branch iff it supplies the elementwise
            # flat_prec seam; the flat_solve closure is responsible for
            # folding it (e.g. ``stpcg_flat(prec=)``, the same contract as
            # the flat engine below).
            cg = problem.flat_solve(grad, x, data, st.aux, st.Delta,
                                    params)
            flat_dm = cg.predicted_decrease
        elif use_flat:
            from ..linalg.flat_cg import stpcg_flat

            if st.aux is not None:
                qm_out = problem.flat_qm(x, data, st.aux)
            else:
                qm_out = problem.flat_qm(x, data)
            # Optional 4th element: the engine's pre-loop dot group
            # (FlatCGInit), carried through the aux seam from step_eval so
            # the subproblem starts with zero reductions.  Pair engine
            # only — with s_steps >= 2 or a preconditioner it is dropped.
            A0, Uf, Bf = qm_out[:3]
            initd = qm_out[3] if len(qm_out) > 3 else None
            prec_fn = (problem.flat_prec(x, data)
                       if problem.flat_prec is not None else None)
            if params.flat_s_steps > 1 or prec_fn is not None:
                initd = None
            cg = stpcg_flat(grad, A0, Uf, Bf, st.Delta,
                            max_iterations=params.max_TPCG_iterations,
                            kappa_fgr=params.kappa_fgr, theta=params.theta,
                            s_steps=params.flat_s_steps, init=initd,
                            kernel_check=params.flat_kernel_check,
                            prec=prec_fn)
            flat_dm = cg.predicted_decrease
        else:
            in_flat_branch = False
            _, Hv = problem.qm(x, data)
            precon_fn = None
            if problem.precon is not None:
                precon_fn = lambda r: (problem.apply_precon(x, r, data), None)
            cg = stpcg(grad, Hv, inner, st.Delta,
                       max_iterations=params.max_TPCG_iterations,
                       kappa_fgr=params.kappa_fgr, theta=params.theta,
                       precon=precon_fn)
            # dm by the engine's scalar recurrence — algebraically the
            # reference's -<g,h> - 1/2 <h,Hh> (TNT.h:511-521) without a
            # second Hv: one fewer operator application per outer
            # iteration AND one fewer Hv subgraph in the compiled program
            # (for nested-solve operators like the marginalized SE-Sync
            # Hessian, the duplicate subgraph dominated compile time).
            flat_dm = cg.predicted_decrease
        h, h_M_norm = cg.s, cg.update_step_M_norm
        # In the unpreconditioned flat branch the metric is the ambient
        # Euclidean dot (part of the flat_qm contract), so |h| == |h|_M —
        # no extra pass.  With flat_prec (or in the generic branch, where
        # the M-norm is the metric/preconditioner norm) the Euclidean
        # step norm costs one extra reduction.
        h_norm = (h_M_norm
                  if in_flat_branch and problem.flat_prec is None
                  else jnp.sqrt(inner(h, h)))

        # STEP 3: trial point and gain ratio (reference TNT.h:505-532).
        # The flat engine tracks the model decrease by scalar recurrence
        # (algebraically the reference's dm, without the extra Hv product).
        # With a problem-supplied fused step evaluator, the retraction,
        # trial objective, and trial gradient come from one fused pass
        # (core/problem.py step_eval) instead of three separate ones.
        if use_step_eval:
            out = problem.step_eval(x, h, data)
            x_prop, fx_prop, g_acc, gn_acc = out[:4]
            aux_prop = out[4] if st.aux is not None else None
            fx_prop = jnp.asarray(fx_prop)
            pgn_acc = gn_acc
        else:
            aux_prop = None
            x_prop = M.retract(x, h)
            fx_prop = jnp.asarray(problem.value(x_prop, data))
        dm = flat_dm
        df = fx - fx_prop
        relative_decrease = df / (sqrt_eps + jnp.abs(fx))
        rho = df / dm
        accepted, very_successful, unsuccessful = step_decision(
            rho, dm, params.eta1, params.eta2)
        acc_floor = jnp.asarray(False)
        if params.floor_acceptance:
            # sub-epsilon model decrease: accept on the model's word, hold
            # the radius (see TNTParams.floor_acceptance)
            floor = 4.0 * jnp.finfo(dtype).eps * (jnp.abs(fx)
                                                  + jnp.finfo(dtype).eps)
            acc_floor = ((dm > 0) & (dm <= floor) & (df >= -floor)
                         & ~accepted)
            accepted = accepted | acc_floor
            very_successful = very_successful & ~acc_floor
            unsuccessful = unsuccessful & ~acc_floor

        if user_function is not None:
            user_stop = jnp.asarray(user_function(
                ridx, x, fx, grad, st.Delta, cg.num_iterations, h, df, rho,
                accepted))
        else:
            user_stop = jnp.asarray(False)

        # Accepted-step updates (reference TNT.h:555-585); a user stop fires
        # *before* the update is applied.  The gradient is evaluated at the
        # trial point and selected afterwards — same values as evaluating at
        # the accepted point, but the operator application is shared with
        # f(x_prop) by common-subexpression elimination instead of running
        # on the select's output.
        apply = accepted & ~user_stop
        x_new = tree_where(apply, x_prop, x)
        f_new = jnp.where(apply, fx_prop, fx)
        if not use_step_eval:
            g_acc, gn_acc, pgn_acc = grad_and_norms(x_prop)
        g_new = tree_where(apply, g_acc, grad)
        aux_new = (tree_where(apply, aux_prop, st.aux)
                   if aux_prop is not None else st.aux)
        gn_new = jnp.where(apply, gn_acc, st.gradnorm)
        pgn_new = jnp.where(apply, pgn_acc, st.pgradnorm)

        # Floor-accepted steps (sub-epsilon df, possibly df < 0 by a
        # rounding ulp) must NOT fire the relative-decrease stop — with
        # relative_decrease_tolerance = 0 a one-ulp-negative df would
        # otherwise terminate the solve exactly when floor acceptance is
        # keeping it alive.
        apply_meas = apply & ~acc_floor
        status = jnp.where(
            user_stop,
            TNTStatus.USER_FUNCTION.value,
            jnp.where(
                apply_meas
                & (relative_decrease < params.relative_decrease_tolerance),
                TNTStatus.RELATIVE_DECREASE.value,
                jnp.where(apply & (h_norm < params.stepsize_tolerance),
                          TNTStatus.STEPSIZE.value,
                          TNTStatus.RUNNING.value))).astype(jnp.int32)

        # STEP 4: trust-region radius update (reference TNT.h:590-603);
        # skipped when a stopping criterion already fired this iteration.
        Delta_new = jnp.where(
            very_successful,
            jnp.maximum(params.alpha2 * h_M_norm, st.Delta),
            jnp.where(unsuccessful, params.alpha1 * h_M_norm, st.Delta))
        tr_collapse = unsuccessful & (Delta_new < params.Delta_tolerance)
        running = status == TNTStatus.RUNNING.value
        Delta_new = jnp.where(running, Delta_new, st.Delta)
        status = jnp.where(running & tr_collapse,
                           TNTStatus.TRUST_REGION.value, status).astype(jnp.int32)

        return st._replace(
            x=x_new, f=f_new, grad=g_new, gradnorm=gn_new, pgradnorm=pgn_new,
            aux=aux_new,
            Delta=Delta_new, status=status,
            inner_iterations=st.inner_iterations.at[ridx].set(
                cg.num_iterations.astype(jnp.int32)),
            update_step_norms=st.update_step_norms.at[ridx].set(h_norm),
            update_step_M_norms=st.update_step_M_norms.at[ridx].set(h_M_norm),
            gain_ratios=st.gain_ratios.at[ridx].set(rho),
        )

    def body(st: _State) -> _State:
        st = record(st)
        st = st._replace(k=st.k + 1)
        conv_status = jnp.where(
            st.gradnorm < params.gradient_tolerance,
            TNTStatus.GRADIENT.value,
            jnp.where(
                st.pgradnorm < params.preconditioned_gradient_tolerance,
                TNTStatus.PRECONDITIONED_GRADIENT.value,
                TNTStatus.RUNNING.value)).astype(jnp.int32)

        return jax.lax.cond(
            conv_status != TNTStatus.RUNNING.value,
            lambda s: s._replace(status=conv_status),
            do_iter,
            st)

    def cond(st: _State):
        return ((st.k < params.max_iterations)
                & (st.status == TNTStatus.RUNNING.value))

    st = jax.lax.while_loop(cond, body, st0)

    status = jnp.where(st.status == TNTStatus.RUNNING.value,
                       TNTStatus.ITERATION_LIMIT.value,
                       st.status).astype(jnp.int32)

    # Final trace entry (reference TNT.h:616-624)
    st = record(st)

    return TNTResult(
        x=st.x, f=st.f, gradfx_norm=st.gradnorm,
        preconditioned_grad_f_x_norm=st.pgradnorm,
        status=status, num_iterations=st.k,
        objective_values=st.objective_values,
        gradient_norms=st.gradient_norms,
        preconditioned_gradient_norms=st.preconditioned_gradient_norms,
        trust_region_radius=st.trust_region_radius,
        inner_iterations=st.inner_iterations,
        update_step_norms=st.update_step_norms,
        update_step_M_norms=st.update_step_M_norms,
        gain_ratios=st.gain_ratios,
        times=jnp.full((n_trace,), pad_value(), jnp.float32),
        iterates=st.iterates,
    )


class EscalatedResult(NamedTuple):
    """Result of :func:`solve_escalated`: the final (f32) state plus both
    stage results and the iteration at which the dtype crossover fired."""

    x: Any
    f: jnp.ndarray
    gradfx_norm: jnp.ndarray
    status: jnp.ndarray           # final-stage TNTStatus
    num_iterations: jnp.ndarray   # total outer iterations across stages
    switch_iteration: jnp.ndarray  # bf16 iterations before promotion
    stage_low: TNTResult
    stage_high: TNTResult


def solve_escalated(
    problem: RiemannianProblem,
    x0: Any,
    params: TNTParams = TNTParams(),
    data: Any = None,
    *,
    low_dtype=jnp.bfloat16,
    high_dtype=jnp.float32,
    low_params: Optional[TNTParams] = None,
) -> EscalatedResult:
    """TNT with **dtype escalation**: run the fast low-precision storage
    tier until it stalls at its rounding floor, then promote the carry to
    ``high_dtype`` and finish to the caller's tolerances — the reference's
    converge-to-|grad|-tolerance termination contract (``TNT.h:122-125``)
    at (mostly) the low-tier's speed.

    Stage 1 (low) runs until the reference's own TRUST-REGION-collapse
    criterion fires: at the low dtype's floor, trial steps stop producing
    measurable decrease, get rejected, and the radius shrinks below
    ``Delta_tolerance`` — the natural floor detector, with no new
    semantics.  (The RelativeDecrease criterion is deliberately NOT used
    as the detector: on slowly-converging problems the per-step relative
    decrease drops below eps_low long before the storage floor is
    reached — measured on the kappa=1000 n=2^24 Rayleigh config it
    switched at outer 15 of ~170, forfeiting the low tier's speed.)
    A caller-supplied ``low_params`` overrides the whole stage-1 set.
    Stage 2 recasts the iterate and runs the unmodified params from a
    FRESH ``params.Delta0`` (the carried radius is collapsed by
    construction; TNT re-grows in a handful of very-successful steps).
    ``switch_iteration`` is where stage 1 stopped.
    """
    if low_params is None:
        low_params = dataclasses.replace(
            params,
            # the floor detector: reject-shrink until TR collapse
            relative_decrease_tolerance=0.0,
            stepsize_tolerance=0.0,
            Delta_tolerance=max(params.Delta_tolerance, 1e-6),
            # stage 1 may hit the final gradient tolerance early; keep it
            gradient_tolerance=params.gradient_tolerance,
        )
    # the finishing stage needs sub-epsilon floor acceptance: the promoted
    # iterate's residual error concentrates in high-curvature modes whose
    # objective contribution is below eps(high_dtype) (see
    # TNTParams.floor_acceptance)
    params = dataclasses.replace(params, floor_acceptance=True)

    cast = lambda dt: (lambda l: jnp.asarray(l).astype(dt))
    x_low = jax.tree_util.tree_map(cast(low_dtype), x0)
    res_low = solve(problem, x_low, low_params, data=data)

    # promote: iterate and trust region carry across the dtype boundary.
    # The low-precision iterate sits O(eps_low) OFF the manifold (e.g.
    # |x| = 1 +- 2^-9 on the sphere), where the unconstrained objective
    # can undercut the on-manifold minimum — stage 2 would then reject
    # every (re-normalized) trial point and collapse its trust region.
    # A zero-tangent retraction in high precision projects the promoted
    # carry back onto the manifold before stage 2 starts.
    x_high = jax.tree_util.tree_map(cast(high_dtype), res_low.x)
    x_high = problem.manifold.retract(
        x_high, jax.tree_util.tree_map(jnp.zeros_like, x_high))
    # fresh radius: stage 1 exits with a collapsed trust region by
    # construction (its floor detector IS the collapse); carrying it
    # would make stage 2 spend its first iterations re-growing
    res_high = solve(problem, x_high, params, data=data)

    return EscalatedResult(
        x=res_high.x, f=res_high.f, gradfx_norm=res_high.gradfx_norm,
        status=res_high.status,
        num_iterations=res_low.num_iterations + res_high.num_iterations,
        switch_iteration=res_low.num_iterations,
        stage_low=res_low, stage_high=res_high)
