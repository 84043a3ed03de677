"""Range-aided pose synchronization (CORA-style unit-vector relaxation).

Pose-graph SLAM with auxiliary **range** measurements (UWB/acoustic
beacons between platforms): on top of the SE(d) relative-pose edges,
each range edge k = (i, j) observes only the DISTANCE d_k between t_i
and t_j.  The squared-distance residual (|t_j - t_i| - d_k)^2 is
nonsmooth at t_j = t_i and its lift breaks the quadratic structure, so
the model follows the certifiably-correct range-aided SLAM line of work
from the reference's ecosystem (Papalia-Morales-Doherty-Rosen-Leonard,
"CORA"): introduce one UNIT VECTOR u_k per range edge and minimize

    f(R, t, u) = sum_e  kappa_e |R_j - R_i Rtilde_e|_F^2
               + sum_e  tau_e   |t_j - t_i - R_i ttilde_e|^2
               + sum_k  rho_k   |t_j - t_i - d_k u_k|^2 ,

which agrees with the original range cost at the per-k optimum
u_k = (t_j - t_i)/|t_j - t_i| and is QUADRATIC in (R, t, u) jointly.

This is the framework's generality exercise for the reference's primary
usage pattern — the user writes ONLY the objective:

- the variable is a PyTree triple ``(R, t, u)`` on the product manifold
  SO(d)^n x R^{n d} x (S^{d-1})^m (``manifolds.product`` zipping the
  stacked-rotations, Euclidean, and row-wise sphere factors);
- the Riemannian gradient is ``jax.grad`` + tangent projection and the
  Hessian-vector product is ``jax.jvp`` of the gradient field — no
  hand-written derivatives anywhere (the ``Optimization::Riemannian``
  concepts seam, reference ``Riemannian/Concepts.h:40-104``,
  ``TNT.h:209-222``);
- the solver is the stock TNT trust region (``TNT.h:64-805``).

Gauge: the cost is invariant under the global rigid motion
R_i -> G R_i, t_i -> G t_i + c (u_k -> G u_k); the TR-CG inner solver
tolerates the resulting Hessian kernel (the kernel-of-H safeguard,
``IterativeSolvers.h:320-326``), and results are reported after optimal
gauge alignment (``pose_sync.alignment_errors``).

NB the full CORA algorithm certifies global optimality of the joint
problem through its rank-relaxed SDP; here certification ships for the
rotation stage (``rotation_sync.certify`` on the chordal objective) and
the joint refinement is a local (second-order-stationary) solve — the
documented scope boundary of this model.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.problem import RiemannianProblem
from ..manifolds import euclidean, product, rotations, sphere
from ..solvers import tnt
from . import rotation_sync as rs
from .pose_sync import _transposed_rotation_data, recover_translations

__all__ = ["RangeSyncData", "RangeSyncResult", "make_problem",
           "initial_guess", "solve_range_aided", "random_instance"]


class RangeSyncData(NamedTuple):
    """Pose edges (src -> dst: Rij, tij, weights kappa/tau) plus range
    edges (rsrc -> rdst: dists, weights rho)."""

    src: jnp.ndarray        # (E,) int32
    dst: jnp.ndarray        # (E,)
    Rij: jnp.ndarray        # (E, d, d) relative rotations
    tij: jnp.ndarray        # (E, d) relative translations (frame of src)
    rsrc: jnp.ndarray       # (K,) int32
    rdst: jnp.ndarray       # (K,)
    dists: jnp.ndarray      # (K,) measured ranges
    kappa: Optional[jnp.ndarray] = None   # (E,) rotation weights
    tau: Optional[jnp.ndarray] = None     # (E,) translation weights
    rho: Optional[jnp.ndarray] = None     # (K,) range weights


class RangeSyncResult(NamedTuple):
    R: jnp.ndarray          # (n, d, d)
    t: jnp.ndarray          # (n, d)
    u: jnp.ndarray          # (K, d) unit range bearings
    result: tnt.TNTResult   # the joint TNT solve


def _weights(data: RangeSyncData, dtype):
    E, K = data.src.shape[0], data.rsrc.shape[0]
    one = lambda w, m: (jnp.ones((m,), dtype) if w is None
                        else w.astype(dtype))
    return one(data.kappa, E), one(data.tau, E), one(data.rho, K)


def make_problem(data: RangeSyncData) -> RiemannianProblem:
    """The joint problem over ``x = (R, t, u)`` — objective only; all
    derivatives are automatic (module docstring)."""
    M = product((rotations(), euclidean(), sphere()))

    def f(x, dd):
        R, t, u = x
        dt = jnp.promote_types(R.dtype, jnp.float32)
        R, t, u = R.astype(dt), t.astype(dt), u.astype(dt)
        kap, tau, rho = _weights(data, dt)
        Rij = data.Rij.astype(dt)
        tij = data.tij.astype(dt)
        dists = data.dists.astype(dt)
        hi = jax.lax.Precision.HIGHEST

        pred = jnp.einsum("eij,ejk->eik", R[data.src], Rij, precision=hi)
        fr = jnp.sum(kap * jnp.sum((R[data.dst] - pred) ** 2, axis=(1, 2)))
        tpred = jnp.einsum("eij,ej->ei", R[data.src], tij, precision=hi)
        dt_e = t[data.dst] - t[data.src]
        ft = jnp.sum(tau * jnp.sum((dt_e - tpred) ** 2, axis=1))
        dr_k = t[data.rdst] - t[data.rsrc]
        fu = jnp.sum(rho * jnp.sum((dr_k - dists[:, None] * u) ** 2,
                                   axis=1))
        return fr + ft + fu

    return RiemannianProblem(f=f, manifold=M)


def initial_guess(data: RangeSyncData, n: int, *, key=None,
                  dtype=jnp.float32):
    """(R0, t0, u0): chordal spectral init for rotations
    (``rotation_sync.spectral_init``), LSQR translation recovery given
    R0 (``pose_sync.recover_translations``), and bearings from the
    recovered translation differences (random unit rows where the
    difference is degenerate)."""
    d = data.Rij.shape[-1]
    rot_data = _transposed_rotation_data(data.src, data.dst, data.Rij,
                                         data.kappa)
    Q0 = rs.spectral_init(rot_data, n, d, key=key)
    R0 = jnp.swapaxes(Q0, -1, -2).astype(dtype)
    t0, _ = recover_translations(R0, data.src, data.dst,
                                 data.tij.astype(dtype),
                                 weights=data.tau)
    diff = t0[data.rdst] - t0[data.rsrc]
    nrm = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    rnd = sphere().rand(key if key is not None else jax.random.PRNGKey(0),
                        diff.shape[0], d)
    u0 = jnp.where(nrm > 1e-6, diff / jnp.maximum(nrm, 1e-30), rnd)
    return R0, t0.astype(dtype), u0.astype(dtype)


def solve_range_aided(data: RangeSyncData, n: int, *,
                      params: Optional[tnt.TNTParams] = None,
                      key=None, anchor: int = 0,
                      dtype=jnp.float32) -> RangeSyncResult:
    """Initialize (rotations spectral, translations LSQR, bearings from
    the recovered geometry) and jointly refine with one Riemannian TNT
    solve on the product manifold."""
    problem = make_problem(data)
    x0 = initial_guess(data, n, key=key, dtype=dtype)
    if params is None:
        f32 = dtype == jnp.float32
        params = tnt.TNTParams(
            max_iterations=100, gradient_tolerance=(1e-3 if f32 else 1e-9),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
    res = tnt.solve(problem, x0, params)
    R, t, u = res.x
    t = t - t[anchor][None, :]
    return RangeSyncResult(R=R, t=t, u=u, result=res)


def random_instance(key, n: int, d: int = 3, *, extra_edges: int = 0,
                    n_ranges: int = 0, noise: float = 0.0,
                    range_noise: float = 0.0, box: float = 10.0):
    """Synthetic instance: a spanning path of pose edges (+ ``extra_edges``
    random ones) over ground-truth poses in a ``box``-sized world, plus
    ``n_ranges`` random range edges.  Returns
    ``(R_true, t_true, RangeSyncData)``."""
    import numpy as np

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    R_true = rs.ROTATIONS.rand(k1, n, d, d)
    t_true = box * jax.random.uniform(k2, (n, d))

    # 2**31 - 1: the maxval must fit int32 (JAX's default x32 mode)
    rng = np.random.default_rng(
        int(jax.random.randint(k3, (), 0, 2**31 - 1)))
    src = np.concatenate([np.arange(n - 1),
                          rng.integers(0, n, extra_edges)])
    dst = np.concatenate([np.arange(1, n),
                          rng.integers(0, n, extra_edges)])
    keep = src != dst
    src, dst = (jnp.asarray(src[keep], jnp.int32),
                jnp.asarray(dst[keep], jnp.int32))

    # noisy relative measurements in the src frame
    E = src.shape[0]
    Rn = rs.ROTATIONS.retract(
        jnp.eye(d)[None].repeat(E, 0),
        noise * jax.random.normal(k4, (E, d, d)))
    hi = jax.lax.Precision.HIGHEST
    Rij = jnp.einsum("eji,ejk->eik", R_true[src],
                     jnp.einsum("eij,ejk->eik", Rn, R_true[dst],
                                precision=hi), precision=hi)
    dt_e = t_true[dst] - t_true[src]
    tij = jnp.einsum("eji,ej->ei", R_true[src], dt_e, precision=hi)
    tij = tij + noise * jax.random.normal(k4, tij.shape)

    rr = rng.integers(0, n, (2, max(n_ranges, 0)))
    keep_r = rr[0] != rr[1]
    rsrc = jnp.asarray(rr[0][keep_r], jnp.int32)
    rdst = jnp.asarray(rr[1][keep_r], jnp.int32)
    dists = jnp.linalg.norm(t_true[rdst] - t_true[rsrc], axis=-1)
    dists = jnp.maximum(
        dists + range_noise * jax.random.normal(k5, dists.shape), 1e-3)

    return R_true, t_true, RangeSyncData(
        src=src, dst=dst, Rij=Rij, tij=tij,
        rsrc=rsrc, rdst=rdst, dists=dists)
