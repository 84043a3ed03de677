"""Steihaug-Toint truncated preconditioned *projected* conjugate-gradient.

Approximately solves the trust-region subproblem

    min_s  <g, s> + (1/2) <s, H s>
    s.t.   A s = 0            (optional, via a constraint preconditioner)
           |s|_M <= Delta

entirely inside one ``lax.while_loop`` so that the whole inner solve is a
single fused XLA computation: the only per-iteration costs are one
Hessian-vector product and a handful of inner-product reductions (which on a
sharded tangent space become ``psum`` collectives — see
``optimization_tpu.parallel``).

Functional contract matches the reference ``STPCG``
(``LinearAlgebra/IterativeSolvers.h:166-426``), including:

- truncation test  |r_k|_P <= |r_0|_P * min(kappa_fgr, |r_0|_P^theta)
  (``IterativeSolvers.h:275-291``);
- the kernel-of-H escape:  |H p| / |p| < epsilon  ->  walk (a descent-aligned)
  p to the trust-region boundary (``IterativeSolvers.h:300-338``);
- negative-curvature / overlong-step boundary exit with
  sigma = (-<s,Mp> + sqrt(<s,Mp>^2 + |p|_M^2 (Delta^2 - |s|_M^2))) / |p|_M^2
  (``IterativeSolvers.h:347-362``);
- the M-norm recurrences for <s,Mp>, |s|_M^2, |p|_M^2
  (``IterativeSolvers.h:408-420``);
- Lagrange-multiplier cleanup r <- r - A^T lambda after each application of a
  constraint preconditioner (``IterativeSolvers.h:236-252,388-404``).

Vectors are arbitrary PyTrees; the caller supplies ``inner`` (the M-metric
seam that becomes a collective when sharded).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.tree import (tree_axpy, tree_axpy_like, tree_neg,
                         tree_where, tree_zeros_like)

__all__ = ["STPCGResult", "stpcg"]


class STPCGResult(NamedTuple):
    s: Any
    update_step_M_norm: jnp.ndarray
    num_iterations: jnp.ndarray
    # Predicted model decrease -(<g,s> + 1/2 <s,Hs>) tracked by scalar
    # recurrence (interior step: +1/2 alpha <r,v>; boundary step along p:
    # -(sigma sign <r,p> + 1/2 sigma^2 kappa)) — algebraically the
    # reference's explicit dm (TNT.h:511-521) at zero extra operator
    # applications, so TNT's gain ratio needs no second Hv and the
    # compiled TNT program contains ONE Hv subgraph instead of two (the
    # dominant compile-time lever for operators with nested solves, e.g.
    # the marginalized SE-Sync Hessian).  Same contract as
    # flat_cg.FlatCGResult.predicted_decrease.
    predicted_decrease: jnp.ndarray = None


class _State(NamedTuple):
    """Rotated-loop carry: the search direction p_k is *formed at the top of
    iteration k* (p_k = -v_k + beta_k p_{k-1}) rather than at the bottom of
    iteration k-1.  The recurrences are identical to the reference — only
    the loop boundary moves — but it lets XLA fuse the p-formation, an
    elementwise-fusable Hessian application, and the batch of per-iteration
    inner products into one memory pass: forming p at the bottom of the body
    puts a while-loop back-edge between producer and consumer, which XLA
    cannot fuse across.  The M-norm trackers for p_k are reconstructed at
    the top from the carried previous-iteration scalars:

        <s_k, M p_k>  = beta_k (<s_{k-1}, M p_{k-1}> + alpha_{k-1}
                                |p_{k-1}|_M^2)
        |p_k|_M^2     = <r_k, v_k> + beta_k^2 |p_{k-1}|_M^2
    """

    k: jnp.ndarray
    s: Any
    r: Any
    v: Any
    p_prev: Any
    beta: jnp.ndarray          # beta_k forming p_k from p_{k-1} (0 on entry)
    alpha_prev: jnp.ndarray    # alpha_{k-1}
    s_M_p_prev: jnp.ndarray    # <s_{k-1}, M p_{k-1}>
    sk_M_2: jnp.ndarray        # |s_k|_M^2
    p_M_2_prev: jnp.ndarray    # |p_{k-1}|_M^2
    rv: jnp.ndarray            # <r_k, v_k>
    mval: jnp.ndarray          # model value <g,s_k> + 1/2 <s_k, H s_k>
    done: jnp.ndarray
    boundary: jnp.ndarray


def _validate(max_iterations, kappa_fgr, theta, epsilon) -> None:
    if max_iterations < 0:
        raise ValueError(
            "Maximum number of iterations (max_iterations) must be a "
            "nonnegative integer")
    if not (0 <= kappa_fgr < 1):
        raise ValueError(
            "Target fractional reduction of the gradient norm (kappa_fgr) "
            "must be a real value in the range [0,1)")
    if not (0 <= theta <= 1):
        raise ValueError(
            "Target superlinear convergence rate (theta) must be a real "
            "value in the range [0,1]")
    if not (0 < epsilon < 1):
        raise ValueError(
            "Relative norm tolerance for declaring a vector to lie in the "
            "kernel of H (epsilon) should be a small positive number in (0,1)")


def stpcg(
    g: Any,
    Hv: Callable[[Any], Any],
    inner: Callable[[Any, Any], jnp.ndarray],
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    precon: Optional[Callable[[Any], Tuple[Any, Any]]] = None,
    At: Optional[Callable[[Any], Any]] = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
    epsilon: float = 1e-8,
) -> STPCGResult:
    """Run STPCG.  ``Delta`` may be a traced scalar (TNT passes its radius in).

    - ``g``: model gradient (any PyTree).
    - ``Hv(v)``: symmetric model-Hessian operator.
    - ``inner(u, v)``: ambient inner product (becomes a ``psum`` when sharded).
    - ``precon(r) -> (v, lambda)``: optional constraint preconditioner solving
      ``[M A'; A 0] [v; lambda] = [r; 0]`` (plain SPD preconditioning is the
      special case lambda = None with no ``At``).
    - ``At(lambda)``: optional constraint-transpose operator.
    - ``user_function(k, s, r, v, p, alpha) -> bool``: optional pure stopping
      predicate evaluated each iteration before the update is applied (the
      jittable analog of the reference's STPCGUserFunction,
      ``IterativeSolvers.h:50-59,364-369``).
    """
    _validate(max_iterations, kappa_fgr, theta, epsilon)

    def apply_P(r):
        if precon is None:
            return r, r
        v, lam = precon(r)
        if At is not None:
            r = tree_axpy(-1.0, At(lam), r)
        return v, r

    # --- initialization (reference IterativeSolvers.h:207-283) ---
    s0 = tree_zeros_like(g)
    r0 = g
    v0, r0 = apply_P(r0)
    rv0 = inner(r0, v0)
    dtype = jnp.asarray(rv0).dtype
    Delta = jnp.asarray(Delta, dtype=dtype)
    Delta2 = Delta * Delta
    zero = jnp.zeros((), dtype)

    r0_norm = jnp.sqrt(rv0)
    target_rk_norm = r0_norm * jnp.minimum(
        jnp.asarray(kappa_fgr, dtype), r0_norm**theta)

    # With no preconditioner v == r identically: store an empty pytree in
    # the v slot and read r instead, so the carry does not move (and the
    # exit-selects do not rewrite) a duplicate n-vector every iteration.
    has_precon = precon is not None
    v_slot = v0 if has_precon else ()
    v_of = (lambda st: st.v) if has_precon else (lambda st: st.r)

    # Rotated loop (see _State): p_0 = -v_0 arises from beta_0 = 0.
    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        s=s0, r=r0, v=v_slot, p_prev=tree_zeros_like(v0),
        beta=zero, alpha_prev=zero,
        s_M_p_prev=zero, sk_M_2=zero, p_M_2_prev=zero, rv=rv0,
        mval=zero,
        done=jnp.asarray(False),
        boundary=jnp.asarray(False),
    )

    def cond(st: _State):
        return ((st.k < max_iterations)
                & ~st.done
                & (jnp.sqrt(st.rv) > target_rk_norm))

    def body(st: _State) -> _State:
        # Form this iteration's search direction and its M-norm trackers
        # from the carried scalars (identical recurrences, moved across the
        # loop back-edge so the p-formation fuses into the Hv/dots pass).
        p = tree_axpy_like(st.beta, st.p_prev, tree_neg(v_of(st)))
        sk_M_pk = st.beta * (st.s_M_p_prev + st.alpha_prev * st.p_M_2_prev)
        pk_M_2 = st.rv + st.beta * st.beta * st.p_M_2_prev

        Hp = Hv(p)
        kappa = inner(p, Hp)
        Hp_norm2 = inner(Hp, Hp)
        p_norm2 = inner(p, p)
        in_kernel = jnp.sqrt(Hp_norm2) < epsilon * jnp.sqrt(p_norm2)

        # Descent alignment of the kernel direction.  The model gradient at
        # s is the residual r = H s + g, so walking +p decreases the model iff
        # <p, r> < 0; flip p when <p, r> > 0.  NB deviation (adjudicated): the
        # reference flips when <p, r> < 0 (``IterativeSolvers.h:320-326``),
        # which contradicts its own stated intent ("ensure that it's a
        # direction of descent") and walks the model *uphill* whenever the
        # search direction lies in ker(H) — e.g. TNT from a point where the
        # Riemannian Hessian vanishes.  We implement the correct sign.
        pr = inner(p, st.r)
        sign = jnp.where(in_kernel & (pr > 0), -jnp.ones((), dtype),
                         jnp.ones((), dtype))
        sk_M_pk_eff = sign * sk_M_pk

        # Boundary steplength (shared by kernel / negative-curvature exits)
        disc = sk_M_pk_eff**2 + pk_M_2 * (Delta2 - st.sk_M_2)
        sigma = (-sk_M_pk_eff + jnp.sqrt(jnp.maximum(disc, 0.0))) / pk_M_2

        alpha = st.rv / kappa
        skplus1_M_2 = (st.sk_M_2 + 2.0 * alpha * sk_M_pk
                       + alpha * alpha * pk_M_2)
        neg_or_exit = (kappa <= 0) | (skplus1_M_2 > Delta2)
        boundary = in_kernel | neg_or_exit

        # Model-value recurrence (see STPCGResult.predicted_decrease):
        # interior CG step decreases it by alpha <r,v> / 2; the boundary
        # step from s_k along sigma*sign*p_k adds
        # sigma sign <r_k, p_k> + 1/2 sigma^2 kappa_k.
        m_int = st.mval - 0.5 * alpha * st.rv
        m_bnd = st.mval + sigma * sign * pr + 0.5 * sigma * sigma * kappa

        # Boundary branch: s + sigma * (sign * p), M-norm = Delta
        s_boundary = tree_axpy_like(sigma * sign, p, st.s)

        # Interior branch: full CG update (IterativeSolvers.h:374-420)
        s_int = tree_axpy_like(alpha, p, st.s)
        r_int = tree_axpy_like(alpha, Hp, st.r)
        v_int, r_int = apply_P(r_int)
        rv_int = inner(r_int, v_int)
        beta = rv_int / (alpha * kappa)

        if user_function is not None:
            user_stop = jnp.asarray(
                user_function(st.k, st.s, st.r, v_of(st), p, alpha))
        else:
            user_stop = jnp.asarray(False)
        # A user stop fires *before* the update is applied and only on interior
        # steps (the reference checks it after the boundary exits).
        user_stop = user_stop & ~boundary

        exit_now = boundary | user_stop

        s_new = tree_where(boundary, s_boundary,
                           tree_where(user_stop, st.s, s_int))
        r_new = tree_where(exit_now, st.r, r_int)
        v_new = tree_where(exit_now, st.v, v_int) if has_precon else ()

        return _State(
            k=jnp.where(exit_now, st.k, st.k + 1),
            s=s_new, r=r_new, v=v_new,
            p_prev=p,
            beta=jnp.where(exit_now, zero, beta),
            alpha_prev=jnp.where(exit_now, st.alpha_prev, alpha),
            s_M_p_prev=jnp.where(exit_now, st.s_M_p_prev, sk_M_pk),
            sk_M_2=jnp.where(exit_now, st.sk_M_2, skplus1_M_2),
            p_M_2_prev=jnp.where(exit_now, st.p_M_2_prev, pk_M_2),
            rv=jnp.where(exit_now, st.rv, rv_int),
            mval=jnp.where(user_stop, st.mval,
                           jnp.where(boundary, m_bnd, m_int)),
            done=exit_now,
            boundary=boundary,
        )

    st = jax.lax.while_loop(cond, body, st0)

    update_step_M_norm = jnp.where(st.boundary, Delta, jnp.sqrt(st.sk_M_2))
    return STPCGResult(s=st.s, update_step_M_norm=update_step_M_norm,
                       num_iterations=st.k,
                       predicted_decrease=-st.mval)
