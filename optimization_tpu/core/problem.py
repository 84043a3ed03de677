"""Problem protocols: the JAX counterpart of the reference's callback seams.

The reference threads user callbacks (objective, gradient, Hessian operator,
residual map, Jacobian pair, prox ops, ...) plus a variadic ``Args&...`` pack
through every solver (``Base/Concepts.h:26-38``, ``Riemannian/Concepts.h``).
Here a *problem* is a frozen bundle of pure functions with the uniform
signature ``fn(x, ..., data)`` where ``data`` is a runtime PyTree of problem
data (the ``Args...`` analog: it is a traced argument, so it can be vmapped
over instance batches and sharded over device meshes without recompilation).

Derivatives never need to be hand-written: gradients default to ``jax.grad``
pushed through the manifold's ``egrad_to_rgrad``, Hessian-vector products to
``jax.jvp`` of the Riemannian gradient field followed by tangent projection
(exact for Riemannian submanifolds; cf. the QuadraticModel seam at reference
``TNT.h:209-222``), and Jacobian/adjoint pairs to ``jax.jvp``/``jax.vjp``
(reference ``TNLS.h:246-248``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax

from ..manifolds.base import Manifold
from ..manifolds.euclidean import EUCLIDEAN
from .tree import tree_dot

__all__ = ["RiemannianProblem", "LeastSquaresProblem", "CompositeProblem"]


@dataclasses.dataclass(frozen=True, eq=False)
class RiemannianProblem:
    """min_x f(x) over a Riemannian manifold.

    - ``f(x, data) -> scalar``: objective.
    - ``manifold``: geometry bundle (defaults to Euclidean space).
    - ``grad(x, data) -> tangent``: optional Riemannian gradient override.
    - ``hess_vec(x, v, data) -> tangent``: optional Riemannian Hessian-vector
      product override (the STPCG hot operator, reference
      ``IterativeSolvers.h:294``).
    - ``precon(x, v, data) -> tangent``: optional positive-definite
      preconditioner (reference ``TNT.h:234-237``).
    """

    f: Callable[..., Any]
    manifold: Manifold = EUCLIDEAN
    grad: Optional[Callable[..., Any]] = None
    hess_vec: Optional[Callable[..., Any]] = None
    precon: Optional[Callable[..., Any]] = None
    quadratic_model: Optional[Callable[..., Any]] = None
    # Optional structured quadratic model for the single-synchronization
    # flat CG engine (linalg/flat_cg.py): ``flat_qm(x, data) -> (A0, U, B)``
    # with model Hessian H = A0 + U B U' (A0 elementwise, U (n, k) small-k,
    # B (k, k) symmetric).  Valid only when the iterate is a flat array and
    # the manifold metric is the ambient Euclidean dot (sphere, Euclidean);
    # TNT then runs its trust-region subproblem at one fused memory pass +
    # one reduction sync per CG iteration.  It may return a FOURTH element
    # — a ``linalg.flat_cg.FlatCGInit`` pre-loop dot group (typically
    # computed inside ``step_eval``'s fused pass and threaded through the
    # aux carry) — and TNT forwards it to ``stpcg_flat(init=)`` so the
    # subproblem starts with zero reductions (pair engine only).
    flat_qm: Optional[Callable[..., Any]] = None
    # Optional bring-your-own trust-region subproblem engine:
    # ``flat_solve(grad, x, data, aux, Delta, params) -> FlatCGResult``
    # replaces the whole STPCG/flat-CG dispatch in TNT (takes priority
    # over ``flat_qm``).  ``aux`` is the step_eval carry (or None);
    # ``params`` the TNTParams (static).  This is the seam a hand-written
    # subproblem kernel plugs in through, and how a caller pins engine
    # options (e.g. ``stpcg_flat(body_kind=...)``) that ``flat_qm`` does not
    # carry.
    flat_solve: Optional[Callable[..., Any]] = None
    # Optional elementwise preconditioner for the flat engine:
    # ``flat_prec(x, data) -> (v -> M^{-1/2} v)`` returns the elementwise,
    # linear, self-adjoint, positive map the flat CG folds in symmetrically
    # (see ``linalg.flat_cg.stpcg_flat(prec=)``; reference hot-loop
    # preconditioning ``IterativeSolvers.h:236-252,388-404``).  When set
    # together with ``flat_qm``, TNT keeps the subproblem on the flat
    # engine instead of falling back to generic STPCG; set ``precon`` to
    # the consistent full application M^{-1} v = P(P(v)) so the
    # preconditioned-gradient stopping/trace agree.
    flat_prec: Optional[Callable[..., Any]] = None
    # Optional fused trial-step evaluator for TNT's outer iteration:
    # ``step_eval(x, h, data) -> (x_prop, f_prop, grad_prop, gradnorm_prop)``
    # computes the retraction, trial objective, and trial Riemannian
    # gradient in as few memory passes / reduction syncs as the problem's
    # structure allows (the reference evaluates these separately,
    # ``TNT.h:505-508,560-562``; at n=2^24 the separate passes are the
    # dominant non-CG cost once the flat engine runs the subproblem at one
    # memory pass per CG iteration).  Must be algebraically
    # identical to retract + value + rgrad, and valid at h = 0 (TNT calls
    # it once at the initial iterate to seed the aux carry).
    #
    # It may return a FIFTH element — an auxiliary PyTree of quantities
    # computed about the trial point (e.g. the sphere Rayleigh quotient)
    # — which TNT carries alongside the iterate and passes to
    # ``flat_qm(x, data, aux)``, so the next quadratic model reuses the
    # trial evaluation's reductions instead of re-deriving them (the
    # x-dependent caching idea of the reference QuadraticModel seam,
    # ``TNT.h:374-380``, extended across the accept boundary).
    step_eval: Optional[Callable[..., Any]] = None

    def value(self, x, data=None):
        return self.f(x, data)

    def rgrad(self, x, data=None):
        if self.grad is not None:
            return self.grad(x, data)
        eg = jax.grad(lambda y: self.f(y, data))(x)
        return self.manifold.egrad_to_rgrad(x, eg)

    def hvp(self, x, v, data=None):
        """Riemannian Hessian-vector product Hess f(x)[v] (one-shot)."""
        if self.hess_vec is not None:
            return self.hess_vec(x, v, data)
        grad_field = lambda y: self.rgrad(y, data)
        _, dv = jax.jvp(grad_field, (x,), (v,))
        return self.manifold.proj(x, dv)

    def qm(self, x, data=None):
        """Quadratic model at x: (gradient, Hessian-vector closure).

        The analog of the reference's ``QuadraticModel`` seam
        (``TNT.h:209-222``): built once per outer iterate, so anything that
        depends only on x is computed once and reused across every inner CG
        iteration.  Users can cache arbitrary state by supplying
        ``quadratic_model(x, data) -> (grad, hvp_fn)``; the default partially
        evaluates the gradient field with ``jax.linearize`` (which hoists the
        x-dependent forward pass out of the per-CG-step tangent pushforward).
        """
        if self.quadratic_model is not None:
            return self.quadratic_model(x, data)
        if self.hess_vec is not None:
            return (self.rgrad(x, data),
                    lambda v: self.hess_vec(x, v, data))
        grad_field = lambda y: self.rgrad(y, data)
        g, lin = jax.linearize(grad_field, x)
        return g, lambda v: self.manifold.proj(x, lin(v))

    def apply_precon(self, x, v, data=None):
        if self.precon is None:
            return v
        return self.precon(x, v, data)


@dataclasses.dataclass(frozen=True, eq=False)
class LeastSquaresProblem:
    """min_x |F(x)| with F: M -> R^m (for TNLS, reference ``TNLS.h:226-264``).

    - ``residual(x, data) -> y``: the residual map F.
    - ``manifold``: domain geometry.
    - ``jvp(x, v, data)`` / ``vjp(x, w, data)``: optional Jacobian and adjoint
      overrides; default to ``jax.jvp`` / ``jax.vjp`` (+ tangent projection).
    - ``inner_y(u, v, data) -> scalar``: inner product on the codomain
      (defaults to the Euclidean PyTree dot).
    - ``precon``: optional *right*-preconditioner pair ``(M, Mt)`` with
      ``M(x, v, data)`` and ``Mt(x, v, data)`` (reference ``TNLS.h:60-63``).
    """

    residual: Callable[..., Any]
    manifold: Manifold = EUCLIDEAN
    jvp: Optional[Callable[..., Any]] = None
    vjp: Optional[Callable[..., Any]] = None
    inner_y: Optional[Callable[..., Any]] = None
    precon: Optional[tuple] = None

    def F(self, x, data=None):
        return self.residual(x, data)

    def J(self, x, v, data=None):
        """Jacobian-vector product gradF(x)[v] (one-shot)."""
        if self.jvp is not None:
            return self.jvp(x, v, data)
        _, dv = jax.jvp(lambda y: self.residual(y, data), (x,), (v,))
        return dv

    def Jt(self, x, w, data=None):
        """Jacobian-adjoint product gradF(x)^T w, projected into T_x(M)."""
        if self.vjp is not None:
            return self.vjp(x, w, data)
        _, pullback = jax.vjp(lambda y: self.residual(y, data), x)
        (g,) = pullback(w)
        return self.manifold.proj(x, g)

    def jacobian(self, x, data=None):
        """(J, J^T) operator pair at x — the reference's JacobianPairFunction
        seam (``TNLS.h:246-248``): the residual forward pass is evaluated once
        per outer iterate and shared by every inner LSQR iteration."""
        if self.jvp is not None or self.vjp is not None:
            return (lambda v: self.J(x, v, data),
                    lambda w: self.Jt(x, w, data))
        F_at = lambda y: self.residual(y, data)
        _, lin = jax.linearize(F_at, x)
        _, pullback = jax.vjp(F_at, x)

        def Jt_op(w):
            (g,) = pullback(w)
            return self.manifold.proj(x, g)

        return lin, Jt_op

    def inner_Y(self, u, v, data=None):
        if self.inner_y is not None:
            return self.inner_y(u, v, data)
        return tree_dot(u, v)


@dataclasses.dataclass(frozen=True, eq=False)
class CompositeProblem:
    """min_x f(x) + g(x), f smooth, g prox-friendly (for proximal gradient,
    reference ``ProximalGradient.h:125-147``).

    - ``f(x, data) -> scalar``; ``grad_f`` optional (defaults to ``jax.grad``).
    - ``g(x, data) -> scalar``: the nonsmooth term.
    - ``prox_g(x, lam, data) -> x'``: proximal operator of g.
    """

    f: Callable[..., Any]
    g: Callable[..., Any]
    prox_g: Callable[..., Any]
    grad_f: Optional[Callable[..., Any]] = None

    def value_f(self, x, data=None):
        return self.f(x, data)

    def value_g(self, x, data=None):
        return self.g(x, data)

    def value(self, x, data=None):
        return self.f(x, data) + self.g(x, data)

    def gradient_f(self, x, data=None):
        if self.grad_f is not None:
            return self.grad_f(x, data)
        return jax.grad(lambda y: self.f(y, data))(x)

    def prox(self, x, lam, data=None):
        return self.prox_g(x, lam, data)
