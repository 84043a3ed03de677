"""Low-rank matrix completion on the Grassmann manifold (RTRMC-style).

Recovers a rank-k matrix from a partial, noisy observation by optimizing
over the COLUMN SPACE only (Boumal & Absil, "RTRMC: A Riemannian
trust-region method for low-rank matrix completion", NeurIPS 2011 — a
problem family built directly on the Riemannian truncated-Newton
trust-region machinery this suite reimplements; solver seams cite
``/root/reference/include/Optimization/Riemannian/TNT.h:242-254``):

    min_{U in Gr(m, k)}  f(U),
    f(U) = min_W  1/2 |P_Omega(U W - M)|_F^2 + lam/2 |W|_F^2,

where P_Omega masks to the observed entries.  For fixed U the inner problem
is a separate ridge least-squares per *column* of M:

    W[:, j] = (U' D_j U + lam I)^{-1} U' D_j m_j,      D_j = diag(mask[:, j])

— n independent (k x k) SPD solves, batched as one einsum forming the
stacked (n, k, k) normal matrices followed by a fixed 2k-sweep batched CG
(matmul-only; see ``solve_W`` for why a batched Cholesky/solve lowering is
avoided on this runtime).  f is then evaluated through the solved W; because
W(U) is the exact
argmin, the envelope theorem makes the U-gradient equal the partial
gradient, and the generic autodiff pipeline (``jax.grad`` through the
batched solve, ``jax.jvp`` for Hessian-vector products) gives the exact
Riemannian gradient/Hessian on the quotient with no hand-written
derivatives.

The Grassmann (not Stiefel) geometry matters: f is invariant to the right
O(k) basis action, so on St(m, k) the Hessian is singular along the gauge
directions and trust-region solvers stall near the minimizer; the quotient
removes exactly those directions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.problem import RiemannianProblem
from ..manifolds.grassmann import GRASSMANN

__all__ = ["CompletionData", "make_problem", "solve_W", "predict",
           "random_instance", "spectral_init"]

_HP = jax.lax.Precision.HIGHEST


class CompletionData(NamedTuple):
    M_obs: jnp.ndarray    # (m, n) observed values (0 where unobserved)
    mask: jnp.ndarray     # (m, n) {0,1} observation mask
    lam: jnp.ndarray      # ridge weight on W (keeps the inner solve SPD)


def solve_W(U: jnp.ndarray, data: CompletionData) -> jnp.ndarray:
    """The inner ridge least-squares, all n columns batched: W is (k, n).

    Solved by a fixed 2k-sweep batched CG on the (k x k) SPD normal
    equations instead of a Cholesky factorization: CG on a k-dimensional
    SPD system terminates in at most k iterations in exact arithmetic, the
    whole computation is batched einsums (no LAPACK-style decomposition
    inside a differentiated solver loop), and the unrolled iteration
    differentiates cleanly under ``jax.grad``/``jax.jvp``.
    """
    k = U.shape[-1]
    # G[j] = U' D_j U  -> (n, k, k);  b[j] = U' D_j m_j -> (n, k)
    G = jnp.einsum("mj,mp,mq->jpq", data.mask, U, U, precision=_HP)
    b = jnp.einsum("mp,mj->jp", U, data.M_obs, precision=_HP)
    A = G + data.lam * jnp.eye(k, dtype=U.dtype)[None]

    def Av(v):
        return jnp.einsum("jpq,jq->jp", A, v, precision=_HP)

    # Converged columns are masked with SAFE denominators: the sweeps run
    # past exact convergence (rs -> 0), and differentiating rs'/rs there
    # divides by rs^2 -> 0 in f32, which poisons jax.grad/jvp with NaNs
    # even though the forward value is fine.  The where-guard evaluates the
    # division only with a denominator that is 1 when inactive.
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.sum(r * r, axis=-1)
    rs0 = rs
    floor = 1e-10 * rs0 + jnp.asarray(1e-30, U.dtype)
    for _ in range(2 * k):
        active = rs > floor
        Ap = Av(p)
        pAp = jnp.sum(p * Ap, axis=-1)
        alpha = jnp.where(active, rs / jnp.where(active, pAp, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = jnp.sum(r * r, axis=-1)
        beta = jnp.where(active, rs_new / jnp.where(active, rs, 1.0), 0.0)
        p = r + beta[:, None] * p
        rs = rs_new
    return x.T


def _f(U, data: CompletionData):
    W = solve_W(U, data)
    R = data.mask * (jnp.matmul(U, W, precision=_HP) - data.M_obs)
    return 0.5 * jnp.sum(R * R) + 0.5 * data.lam * jnp.sum(W * W)


def make_problem() -> RiemannianProblem:
    return RiemannianProblem(f=_f, manifold=GRASSMANN)


def predict(U: jnp.ndarray, data: CompletionData) -> jnp.ndarray:
    """The completed matrix U W(U)."""
    return jnp.matmul(U, solve_W(U, data), precision=_HP)


def spectral_init(data: CompletionData, k: int) -> jnp.ndarray:
    """Top-k left singular subspace of the (zero-filled, rescaled) observed
    matrix — the standard completion initializer; lands within the basin for
    incoherent matrices at reasonable sampling rates."""
    frac = jnp.maximum(jnp.mean(data.mask), 1e-6)
    Uf, _, _ = jnp.linalg.svd(data.M_obs / frac, full_matrices=False)
    return Uf[:, :k]


def random_instance(key, m: int, n: int, k: int, frac: float = 0.3,
                    noise: float = 0.0, lam: float = 1e-6):
    """Sample a rank-k ground truth and a Bernoulli(frac) observation mask.

    Returns ``(M_true, data)``.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    L = jax.random.normal(k1, (m, k))
    Rf = jax.random.normal(k2, (k, n))
    M_true = jnp.matmul(L, Rf, precision=_HP) / jnp.sqrt(float(k))
    mask = (jax.random.uniform(k3, (m, n)) < frac).astype(M_true.dtype)
    M_obs = mask * (M_true + noise * jax.random.normal(k4, (m, n)))
    return M_true, CompletionData(M_obs=M_obs, mask=mask,
                                  lam=jnp.asarray(lam, M_true.dtype))
