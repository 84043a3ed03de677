"""Rotation synchronization (SE-Sync-style) on SO(d)^n — the flagship model.

Estimates n absolute rotations {R_i} from noisy relative measurements
R~_ij ~ R_i R_j^T over a graph, by minimizing the chordal cost

    f(R) = sum_{(i,j) in E}  | R_i - R~_ij R_j |_F^2

over the product manifold SO(d)^n (represented as a stacked (n, d, d) array;
the reference solver suite is the engine behind exactly this problem family —
SE-Sync).  Gradients and Hessian-vector products come from autodiff through
the gather/scatter edge incidence — no hand-written derivatives — and the
whole instance vmaps over a fleet for scenario-parallel (DP) execution and
shards its rotation axis over the mesh "model" axis for block partitioning.

All heavy ops are (E, d, d) batched matmuls.  Every product runs at full
f32 precision (``Precision.HIGHEST``): a GPU's default TF32 inputs keep
about three decimal digits, too coarse for trust-region gain ratios and the
certificate's eigenvalue sign test.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.problem import RiemannianProblem
from ..manifolds.stiefel import ROTATIONS, STIEFEL

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)

__all__ = ["RotationSyncData", "CertificateResult", "certify",
           "make_problem", "random_instance", "random_fleet",
           "solve_robust", "RobustResult", "solve_staircase",
           "StaircaseResult", "round_lifted", "mean_rotation_error"]


class RotationSyncData(NamedTuple):
    src: jnp.ndarray     # (E,) int32: edge sources i
    dst: jnp.ndarray     # (E,) int32: edge targets j
    Rij: jnp.ndarray     # (E, d, d): measured relative rotations
    # Optional per-edge rotational information weights (SE-Sync's kappa; the
    # g2o loader surfaces these from the file's information matrices).
    kappa: Optional[jnp.ndarray] = None    # (E,)


def chordal_cost(R: jnp.ndarray, data: RotationSyncData) -> jnp.ndarray:
    """f(R) = sum_e kappa_e |R_i - R~_e R_j|_F^2 (kappa = 1 when absent)."""
    Ri = R[data.src]                       # (E, d, d)
    Rj = R[data.dst]
    # d x d products are tiny; run them at full precision (module
    # docstring).
    pred = jnp.einsum("eij,ejk->eik", data.Rij, Rj,
                      precision=jax.lax.Precision.HIGHEST)
    diff = Ri - pred
    sq = jnp.sum(diff * diff, axis=(-1, -2))
    if data.kappa is not None:
        sq = data.kappa * sq
    return jnp.sum(sq)


def jacobi_precon(x, v, data: RotationSyncData):
    """Block-Jacobi preconditioner of the chordal Hessian.

    The Euclidean Hessian of the chordal cost has exact vertex-diagonal
    blocks  2 deg_i I_d  (each incident edge contributes 2 kappa_e |R_i|_F^2
    curvature), so the Jacobi inverse is the per-vertex scalar
    1 / (2 deg_i) — and a positive per-block scalar preserves tangency on
    SO(d)^n exactly, so no re-projection is needed.  This is the
    preconditioner seam of the reference TNT (``TNT.h:122-125,394-426``)
    instantiated for rotation synchronization; it matters on graphs with
    strongly non-uniform degrees (hub-and-chain), where the unpreconditioned
    connection Laplacian's conditioning tracks deg_max/deg_min.
    """
    n = x.shape[0]
    w = (data.kappa if data.kappa is not None
         else jnp.ones_like(data.src, dtype=x.dtype))
    deg = (jnp.zeros((n,), x.dtype)
           .at[data.src].add(w).at[data.dst].add(w))
    inv = 1.0 / (2.0 * jnp.maximum(deg, jnp.finfo(x.dtype).tiny))
    return v * inv[:, None, None]


def make_problem(preconditioned: bool = False,
                 flat: bool = False) -> RiemannianProblem:
    """The chordal rotation-sync problem; ``preconditioned=True`` installs
    the block-Jacobi preconditioner (:func:`jacobi_precon`).

    ``flat=True`` routes the trust-region subproblem through the
    single-synchronization flat engine (``linalg/flat_cg.py``) by exposing
    the full Riemannian Hessian closure as the engine's fusible operator
    (U = None).  The ambient Frobenius metric (``_inner``) is the
    Euclidean dot the engine's contract requires, and the tame
    connection-Laplacian spectrum (<= ~4 kappa_max deg_max) keeps even
    the s >= 2 moment assemblies well within f32 at rotation-sync scales
    (group size via ``TNTParams.flat_s_steps``).  NOTE (flat_cg.py module
    docstring): the engine's restructurings are not shown to beat the
    generic STPCG inside nested compiled loops — treat this as an
    equivalence-tested
    alternative path, not a default (exact parity:
    tests/test_rotation_sync.py::test_flat_engine_matches_generic).
    Mutually exclusive with ``preconditioned`` (TNT falls back to the
    generic engine when a preconditioner is installed)."""
    base = RiemannianProblem(f=chordal_cost, manifold=ROTATIONS,
                             precon=jacobi_precon if preconditioned else None)
    if not flat or preconditioned:
        return base

    def flat_qm(x, data):
        _, hvp = base.qm(x, data)
        return hvp, None, None

    import dataclasses
    return dataclasses.replace(base, flat_qm=flat_qm)


def random_instance(key, n: int, d: int = 3, extra_edges: int = 0,
                    noise: float = 0.05, dtype=jnp.float32):
    """Sample a connected instance: a random spanning-path plus extra random
    edges, measurements perturbed by tangent-space Gaussian noise."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    R_true = ROTATIONS.rand(k1, n, d, d).astype(dtype)

    # Path edges guarantee connectivity; extra edges add redundancy
    src = jnp.arange(n - 1, dtype=jnp.int32)
    dst = src + 1
    if extra_edges:
        e_src = jax.random.randint(k2, (extra_edges,), 0, n, jnp.int32)
        e_dst = jax.random.randint(k3, (extra_edges,), 0, n, jnp.int32)
        src = jnp.concatenate([src, e_src])
        dst = jnp.concatenate([dst, e_dst])

    Rij_clean = _mm(R_true[src], jnp.swapaxes(R_true[dst], -1, -2))
    # Perturb each measurement with a small rotation exp(noise * skew)
    w = noise * jax.random.normal(k4, (src.shape[0], d, d), dtype)
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    # 2nd-order expm approximation is plenty for small noise
    pert = (jnp.eye(d, dtype=dtype) + skew + 0.5 * _mm(skew, skew))
    # Re-orthonormalize the perturbation via the manifold retraction machinery
    pert = _orthonormalize(pert)
    Rij = _mm(pert, Rij_clean)
    return R_true, RotationSyncData(src=src, dst=dst, Rij=Rij)


def random_fleet(key, B: int, n: int, d: int = 3, extra_edges: int = 0,
                 noise: float = 0.05, dtype=jnp.float32):
    """Sample B instances sharing ONE edge topology (so the fleet vmaps with
    a single (src, dst) and a stacked (B, E, d, d) measurement block).

    Returns ``(R_trues, data)`` with ``R_trues`` of shape (B, n, d, d) and
    ``data.Rij`` of shape (B, E, d, d).
    """
    kt, ke, kn = jax.random.split(key, 3)
    src = jnp.arange(n - 1, dtype=jnp.int32)
    dst = src + 1
    if extra_edges:
        k2, k3 = jax.random.split(ke)
        src = jnp.concatenate(
            [src, jax.random.randint(k2, (extra_edges,), 0, n, jnp.int32)])
        dst = jnp.concatenate(
            [dst, jax.random.randint(k3, (extra_edges,), 0, n, jnp.int32)])

    def one(k):
        k1, k4 = jax.random.split(k)
        R_true = ROTATIONS.rand(k1, n, d, d).astype(dtype)
        Rij_clean = _mm(R_true[src], jnp.swapaxes(R_true[dst], -1, -2))
        w = noise * jax.random.normal(k4, (src.shape[0], d, d), dtype)
        skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
        pert = _orthonormalize(
            jnp.eye(d, dtype=dtype) + skew + 0.5 * _mm(skew, skew))
        return R_true, _mm(pert, Rij_clean)

    R_trues, Rijs = jax.vmap(one)(jax.random.split(kt, B))
    return R_trues, RotationSyncData(src=src, dst=dst, Rij=Rijs)


def _orthonormalize(M):
    """Project (..., d, d) matrices onto O(d) via the polar factor."""
    g = _mm(jnp.swapaxes(M, -1, -2), M)
    w, q = jnp.linalg.eigh(g)
    inv_sqrt = _mm(q * (1.0 / jnp.sqrt(w))[..., None, :],
                   jnp.swapaxes(q, -1, -2))
    return _mm(M, inv_sqrt)


def connection_laplacian_op(data: RotationSyncData, n: int, d: int,
                            scatter_method: str = "scatter"):
    """Matrix-free connection Laplacian L of the measurement graph.

    L acts on (n*d, k) blocks: block row i gets  deg_i X_i - sum_{e: i->j}
    R~_e X_j - sum_{e: j->i} R~_e^T X_j.  The bottom eigenspace of L is
    spanned by the (stacked) true rotations in the noiseless case — the
    SE-Sync chordal initialization.

    ``scatter_method`` picks the edge->vertex accumulation strategy
    (``models/graph.edge_accumulator``), or ``"adjacency"`` — the dense
    padded-neighbor form: the weighted (transposed-where-reversed)
    measurement blocks are gathered per vertex slot ONCE at construction,
    and every apply is one neighbor gather + one (n, slots, d, d) x
    (n, slots, d, k) block contraction — no scatter, no E-sized
    intermediate.  Non-``"scatter"`` methods need concrete (untraced)
    ``data.src``/``data.dst``.
    """
    w = (data.kappa if data.kappa is not None
         else jnp.ones_like(data.src, dtype=data.Rij.dtype))
    deg = (jnp.zeros((n,), data.Rij.dtype)
           .at[data.src].add(w).at[data.dst].add(w))

    if scatter_method == "adjacency":
        from .graph import adjacency_tables
        nb, eid, fwd, _ = adjacency_tables(data.src, data.dst, n)
        zero_blk = jnp.zeros((1, d, d), data.Rij.dtype)
        R_slots = jnp.concatenate([data.Rij, zero_blk], 0)[eid]
        R_slots = jnp.where(fwd[:, :, None, None], R_slots,
                            jnp.swapaxes(R_slots, -1, -2))
        w_slots = jnp.concatenate([w, jnp.zeros((1,), w.dtype)])[eid]
        blocks = w_slots[:, :, None, None] * R_slots    # (n, slots, d, d)

        def L(S):
            k = S.shape[-1]
            X = S.reshape(n, d, k)
            X_ext = jnp.concatenate(
                [X, jnp.zeros((1, d, k), X.dtype)], 0)
            nbr = jnp.einsum("nsij,nsjk->nik", blocks, X_ext[nb],
                             precision=jax.lax.Precision.HIGHEST)
            return (deg[:, None, None] * X - nbr).reshape(n * d, k)

        return L

    from .graph import edge_accumulator
    acc = edge_accumulator(data.src, data.dst, n, method=scatter_method)

    def L(S):
        k = S.shape[-1]
        X = S.reshape(n, d, k)
        RX_j = jnp.einsum("e,eij,ejk->eik", w, data.Rij, X[data.dst],
                          precision=jax.lax.Precision.HIGHEST)
        RtX_i = jnp.einsum("e,eji,ejk->eik", w, data.Rij, X[data.src],
                           precision=jax.lax.Precision.HIGHEST)
        out = deg[:, None, None] * X + acc(-RX_j, -RtX_i)
        return out.reshape(n * d, k)

    return L


def spectral_init(data: RotationSyncData, n: int, d: int = 3,
                  key=None, max_iterations: int = 200,
                  tau: float = 1e-3, rr_method: str = "chol",
                  scatter_method: str = "scatter") -> jnp.ndarray:
    """SE-Sync-style chordal initialization: the d algebraically-smallest
    eigenvectors of the connection Laplacian (via our LOBPCG), reshaped to
    (n, d, d) blocks and projected onto SO(d).

    ``rr_method`` defaults to the one-eigh chol RR: this is a STANDARD
    eigenproblem (B = I), the easiest regime for Cholesky whitening, at a
    loose tau — and one eigh per iteration instead of two also halves the
    eigh programs to compile (benchmarks/probe_pose_stages.py splits the
    pipeline's cold wall by stage)."""
    from ..linalg.lobpcg import lobpcg

    if key is None:
        key = jax.random.PRNGKey(0)
    L = connection_laplacian_op(data, n, d, scatter_method=scatter_method)
    res = lobpcg(L, m=n * d, nx=min(2 * d + 2, n * d), nev=d,
                 max_iterations=max_iterations, tau=tau, key=key,
                 rr_method=rr_method)
    blocks = res.X.reshape(n, d, d)
    R = _orthonormalize(blocks)
    # Land in SO(d): negating column 0 of a block is a right-multiplication by
    # diag(-1, 1, ..), so per-block flips stay consistent up to global gauge.
    det = jnp.linalg.det(R)
    R = jnp.where(det[:, None, None] < 0,
                  R.at[..., :, 0].multiply(-1.0), R)
    return R


class RobustResult(NamedTuple):
    R: jnp.ndarray            # (n, d, d) robust rotations
    weights: jnp.ndarray      # (E,) final GNC weights (outliers -> ~0)
    result: Any               # TNTResult of the last GNC stage
    identifiable: jnp.ndarray # (n,) per-vertex inlier-majority flag
    all_identifiable: jnp.ndarray


def solve_robust(data: RotationSyncData, n: int, d: int = 3, *,
                 params=None, gnc_steps: int = 6, mu0: float = 64.0,
                 c2: Optional[float] = None, key=None) -> "RobustResult":
    """Outlier-robust rotation synchronization: Geman-McClure via graduated
    non-convexity (GNC), implemented as iteratively reweighted chordal solves
    over the per-edge ``kappa`` seam.

    Each GNC stage solves the weighted chordal problem with TNT, then
    updates the edge weights

        w_e = ( mu c^2 / (mu c^2 + r_e) )^2,      r_e = |R_i - M_e R_j|_F^2,

    while annealing ``mu`` from ``mu0`` down to 1 (mu -> inf is the convex
    quadratic; mu = 1 is Geman-McClure).  ``c2`` is the inlier scale
    (squared residual); defaults to the median residual of the initial fit.

    Returns a :class:`RobustResult` ``(R, weights, result, identifiable,
    all_identifiable)``: the robust estimate, the final per-edge weights
    (outliers -> ~0), the last TNT result, and the per-vertex
    identifiability flag of ``pose_sync.gnc_identifiability`` at the final
    weights (vertices whose incident inlier mass lost the strict majority
    are ambiguous between robust basins and flagged False).
    """
    from ..solvers import tnt as _tnt

    if params is None:
        f32 = data.Rij.dtype == jnp.float32
        params = _tnt.TNTParams(
            max_iterations=50,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)

    def residuals(R):
        Ri = R[data.src]
        pred = jnp.einsum("eij,ejk->eik", data.Rij, R[data.dst],
                          precision=jax.lax.Precision.HIGHEST)
        return jnp.sum((Ri - pred) ** 2, axis=(-1, -2))

    base_kappa = (data.kappa if data.kappa is not None
                  else jnp.ones_like(data.src, dtype=data.Rij.dtype))

    R = spectral_init(data, n, d, key=key).astype(data.Rij.dtype)
    r = residuals(R)
    if c2 is None:
        c2 = jnp.median(r)
    c2 = jnp.maximum(jnp.asarray(c2, data.Rij.dtype),
                     jnp.asarray(1e-12, data.Rij.dtype))

    mus = jnp.logspace(jnp.log10(mu0), 0.0, gnc_steps).astype(data.Rij.dtype)
    res = None
    w = jnp.ones_like(r)
    for mu in list(mus):
        w = ((mu * c2) / (mu * c2 + r)) ** 2
        wdata = RotationSyncData(src=data.src, dst=data.dst, Rij=data.Rij,
                                 kappa=base_kappa * w)
        res = _tnt.solve(make_problem(), R, params, data=wdata)
        R = res.x
        r = residuals(R)

    from .pose_sync import gnc_identifiability
    identifiable, _ = gnc_identifiability(w, data.src, data.dst, n,
                                          base_kappa)
    return RobustResult(R=R, weights=w, result=res,
                        identifiable=identifiable,
                        all_identifiable=jnp.all(identifiable))


class CertificateResult(NamedTuple):
    certified: jnp.ndarray        # bool: S = L - Lambda is PSD up to eta
    lam_min: jnp.ndarray          # smallest eigenvalue estimate of S
    eta: jnp.ndarray              # the tolerance actually used
    stationarity: jnp.ndarray     # |S X|_F / |X|_F (0 at critical points)
    num_iterations: jnp.ndarray   # LOBPCG iterations
    # Eigenvector of lam_min, shape (n d,): when the certificate FAILS this
    # is the second-order descent direction the Riemannian staircase
    # (solve_staircase) escapes along at the next rank.
    eigvec: Optional[jnp.ndarray] = None


def certify(R: jnp.ndarray, data: RotationSyncData, *,
            eta: Optional[float] = None, nx: int = 8,
            max_iterations: int = 200, tau: float = 1e-3,
            key=None, operator=None,
            rr_method: str = "eigh",
            precondition: bool = False,
            scatter_method: str = "scatter") -> CertificateResult:
    """Global-optimality certificate for a rotation-sync critical point.

    The chordal cost satisfies ``f(R) = tr(X' L X)`` with ``X = R.reshape
    (n d, d)`` and L the (weighted) connection Laplacian (verified
    identically in tests).  Following the SE-Sync certification of the
    Orthogonal-Procrustes/rotation-synchronization SDP relaxation (Rosen et
    al., the problem family the reference solver suite was built for): at a
    first-order critical point, with

        Lambda_i = sym( (L X)_i X_i' )        (d x d blocks),
        S = L - BlockDiag(Lambda_1..Lambda_n),

    ``S X = 0`` holds, and ``S >= 0`` certifies that R is a *global*
    optimizer of the relaxation — hence of rotation synchronization itself.
    The PSD check is the framework's own LOBPCG on the matrix-free operator
    ``S(V) = L(V) - Lambda V`` (exactly the role LOBPCG plays in the
    reference's ecosystem).

    ``eta``: PSD slack; defaults to ``1e3 * eps(dtype) * |L|_est`` (the
    certificate eigenvalue is only resolvable to numerical precision).

    ``operator``: optional replacement for the connection Laplacian — pass
    the full marginalized SE-Sync operator (``pose_sync.marginalized_
    problem``'s ``Q_op``) to certify the single-stage pose objective; the
    certificate structure S = Q - BlockDiag(sym((QX)_i X_i')) is identical.

    ``rr_method``: forwarded to :func:`~optimization_tpu.linalg.lobpcg.
    lobpcg` — ``"chol"`` halves the per-iteration eigh count (the
    certificate tolerance ``tau=1e-3`` is far inside that path's envelope).

    ``precondition``: block-Jacobi preconditioning of the certificate
    eigenproblem.  The diagonal d x d blocks of S are available in closed
    form for the connection-Laplacian objective — ``S_ii = w-deg_i I -
    Lambda_i`` (PSD whenever S is) — so T applies their clamped inverses as
    one batched (n, d, d) multiply: the batched analog of the
    regularized-Laplacian certificate preconditioners used in the SE-Sync
    ecosystem.  Measured: ~25-30% fewer LOBPCG iterations on wide-kappa
    weighted graphs at tight tolerances (it equilibrates per-vertex scales
    but cannot compress the near-null certificate eigenvalue itself).
    Ignored when a custom ``operator`` is passed (its diagonal blocks are
    not known here).

    ``R`` may carry a trailing rank-p axis, shape (n, d, p >= d) with
    row-orthonormal (d, p) blocks — the Riemannian-staircase lift
    (:func:`solve_staircase`): the same S = L - BlockDiag(sym((LX)_i X_i'))
    certifies the rank-p critical point of the relaxation.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n, d = R.shape[0], R.shape[1]
    L = (operator if operator is not None
         else connection_laplacian_op(data, n, d,
                                      scatter_method=scatter_method))
    X = R.reshape(n * d, R.shape[-1])

    p = X.shape[-1]
    LX = L(X)
    LXb = LX.reshape(n, d, p)
    Rb = X.reshape(n, d, p)
    Lam = jnp.einsum("nij,nkj->nik", LXb, Rb,
                     precision=jax.lax.Precision.HIGHEST)
    Lam = 0.5 * (Lam + jnp.swapaxes(Lam, -1, -2))

    def S_op(V):
        k = V.shape[-1]
        Vb = V.reshape(n, d, k)
        LamV = jnp.einsum("nij,njk->nik", Lam, Vb,
                          precision=jax.lax.Precision.HIGHEST)
        return L(V) - LamV.reshape(n * d, k)

    SX = S_op(X)
    stationarity = jnp.sqrt(jnp.sum(SX * SX) / jnp.sum(X * X))

    from ..linalg.lobpcg import lobpcg

    T_op = None
    if precondition and operator is None:
        # Closed-form diagonal blocks of S: S_ii = deg_i I - Lambda_i
        # (weighted degree when data.kappa is set).  Clamped inverse per
        # block; the clamp floor handles indefinite blocks at
        # NON-critical points (S not PSD) and near-disconnected vertices.
        w_e = (data.kappa if data.kappa is not None
               else jnp.ones_like(data.src, dtype=R.dtype))
        deg = (jnp.zeros((n,), R.dtype)
               .at[data.src].add(w_e).at[data.dst].add(w_e))
        blocks = (deg[:, None, None] * jnp.eye(d, dtype=R.dtype)) - Lam
        wb, qb = jnp.linalg.eigh(blocks)
        floor_b = 1e-2 * jnp.mean(deg) + jnp.finfo(R.dtype).tiny
        inv = jnp.einsum("nij,nj,nkj->nik", qb,
                         1.0 / jnp.maximum(wb, floor_b), qb,
                         precision=jax.lax.Precision.HIGHEST)

        def T_op(V):
            k = V.shape[-1]
            Vb = V.reshape(n, d, k)
            return jnp.einsum("nij,njk->nik", inv, Vb,
                              precision=jax.lax.Precision.HIGHEST
                              ).reshape(n * d, k)

    res = lobpcg(S_op, T=T_op, m=n * d, nx=nx, nev=1,
                 max_iterations=max_iterations, tau=tau, key=key,
                 rr_method=rr_method)
    lam_min = res.theta[0]

    if eta is None:
        # scale-aware tolerance from the Laplacian norm estimate
        omega = jax.random.normal(key, (n * d, nx), R.dtype)
        Lnorm = jnp.linalg.norm(L(omega)) / jnp.linalg.norm(omega)
        eta_val = 1e3 * jnp.finfo(R.dtype).eps * Lnorm
    else:
        eta_val = jnp.asarray(eta, R.dtype)

    return CertificateResult(
        certified=lam_min >= -eta_val,
        lam_min=lam_min, eta=eta_val, stationarity=stationarity,
        num_iterations=res.num_iterations, eigvec=res.X[:, 0])


class StaircaseResult(NamedTuple):
    R: jnp.ndarray            # (n, d, d) rounded + polished SO(d) estimate
    certified: jnp.ndarray    # certificate of the RETURNED R
    cert: Any                 # CertificateResult at R
    p_final: int              # relaxation rank the staircase stopped at
    rank_gap: float           # sigma_{d+1}/sigma_1 of the final lifted X
    result: Any               # TNTResult of the last solve
    # per-level history: (p, f, lam_min, sdp_certified)
    levels: tuple


def _lifted_problem(n: int, d: int) -> RiemannianProblem:
    """The rank-p SE-Sync relaxation  min tr(X' L X)  over block-row-
    orthonormal X (Boumal's Riemannian staircase / SE-Sync's rank-p stage;
    the reference TNT is the solver SE-Sync runs at each rank —
    ``Riemannian/TNT.h:242-254``).

    Variables are stored as Y of shape (n, p, d) — a product of Stiefel
    St(p, d) factors (orthonormal *columns*), so the existing STIEFEL
    bundle applies; the cost contracts the connection Laplacian against
    X = stacked Y_i' blocks.  Gradients and Hessian-vector products come
    from autodiff (the Laplacian application is (nd, p) matrix work).
    """
    def f(Y, data):
        p = Y.shape[-2]
        L = connection_laplacian_op(data, n, d)
        X = jnp.swapaxes(Y, -1, -2).reshape(n * d, p)
        return jnp.sum(X * L(X))

    return RiemannianProblem(f=f, manifold=STIEFEL)


def round_lifted(Y: jnp.ndarray):
    """Round a rank-p staircase iterate to SO(d)^n (SE-Sync rounding).

    X = stacked Y_i' blocks is (numerically) rank d at a certified
    optimum; take its top-d SVD factor, fix the global orientation by the
    majority determinant sign, and project each block to SO(d).
    Returns ``(R, rank_gap)`` with rank_gap = sigma_{d+1}/sigma_1 (0 when
    the relaxation solution is exactly rank d)."""
    n, p, d = Y.shape
    X = jnp.swapaxes(Y, -1, -2).reshape(n * d, p)
    U, s, _ = jnp.linalg.svd(X, full_matrices=False)
    Xd = (U[:, :d] * s[None, :d]).reshape(n, d, d)
    rank_gap = (s[d] / s[0]) if p > d else jnp.zeros((), Y.dtype)
    # global orientation: majority det sign, then per-block SO(d) projection
    R = _orthonormalize(Xd)
    det = jnp.linalg.det(R)
    flip = jnp.where(jnp.sum(jnp.sign(det)) < 0, -1.0, 1.0)
    R = R.at[..., :, 0].multiply(flip)
    det = jnp.linalg.det(R)
    R = jnp.where(det[:, None, None] < 0,
                  R.at[..., :, 0].multiply(-1.0), R)
    return R, rank_gap


def solve_staircase(data: RotationSyncData, n: int, d: int = 3, *,
                    p_max: Optional[int] = None, params=None, R0=None,
                    key=None, cert_nx: int = 8, cert_tau: float = 1e-3,
                    cert_max_iterations: int = 200,
                    escape_ts=None) -> "StaircaseResult":
    """Certifiably-global rotation synchronization via the **Riemannian
    staircase** (the SE-Sync algorithm the reference solver suite powers):

    1. solve the chordal problem on SO(d)^n (spectral init + TNT) and
       check the dual certificate;
    2. while the certificate fails and p < p_max: lift the solution to
       the rank-p relaxation (pad a zero row onto each Stiefel factor),
       escape the now-certified-saddle along the certificate's negative
       eigenvector (the direction D with blocks e_p v_i' is tangent and
       second-order descent: <D, Hess f[D]> = 2 lam_min < 0), re-solve
       with TNT on the St(p, d)^n product, and re-certify at rank p;
    3. round the lifted solution back to SO(d)^n (:func:`round_lifted`),
       polish with a short SO(d) TNT, and certify the returned estimate.

    At a certified rank the relaxation is tight for the SDP; a zero
    ``rank_gap`` additionally witnesses that the rounding is exact, and
    the returned ``certified`` flag is the certificate evaluated at the
    final polished R (the strongest user-facing statement).

    The loop over ranks runs on the host (each level is one compiled
    solve); d <= p <= p_max = d + 3 by default — SE-Sync practice is that
    one or two lifts suffice away from adversarial noise regimes.
    """
    from ..solvers import tnt as _tnt

    dtype = data.Rij.dtype
    if p_max is None:
        p_max = d + 3
    if params is None:
        f32 = dtype == jnp.float32
        params = _tnt.TNTParams(
            max_iterations=100,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
    if escape_ts is None:
        escape_ts = jnp.logspace(-4.0, 1.0, 11)

    if R0 is None:
        R0 = spectral_init(data, n, d, key=key).astype(dtype)
    res = _tnt.solve(make_problem(), R0, params, data=data)
    R = res.x
    cert = certify(R, data, nx=cert_nx, tau=cert_tau,
                   max_iterations=cert_max_iterations, key=key)
    levels = [(d, float(res.f), float(cert.lam_min),
               bool(cert.certified))]
    rank_gap = 0.0

    Y = jnp.swapaxes(R, -1, -2)                 # (n, d, d), Y_i = R_i'
    lifted = _lifted_problem(n, d)
    p = d
    while not bool(cert.certified) and p < p_max:
        p += 1
        # lift: pad a zero row; the lifted point is the same critical
        # point, now a strict saddle of the rank-p relaxation
        Y = jnp.concatenate([Y, jnp.zeros((n, 1, d), Y.dtype)], axis=1)
        v = cert.eigvec.reshape(n, d).astype(Y.dtype)
        Ydot = jnp.zeros_like(Y).at[:, -1, :].set(v)

        def f_at(t, Y=Y, Ydot=Ydot):
            Yt = STIEFEL.retract(Y, t * Ydot)
            return lifted.value(Yt, data)

        fs = jax.vmap(f_at)(escape_ts.astype(Y.dtype))
        t_best = escape_ts[int(jnp.argmin(fs))]
        Y = STIEFEL.retract(Y, t_best * Ydot)

        res = _tnt.solve(lifted, Y, params, data=data)
        Y = res.x
        cert = certify(jnp.swapaxes(Y, -1, -2), data, nx=cert_nx,
                       tau=cert_tau, max_iterations=cert_max_iterations,
                       key=key)
        levels.append((p, float(res.f), float(cert.lam_min),
                       bool(cert.certified)))

    if p > d:
        R, rank_gap = round_lifted(Y)
        rank_gap = float(rank_gap)
        # polish the rounded point on SO(d)^n, then certify what we return
        res = _tnt.solve(make_problem(), R.astype(dtype), params, data=data)
        R = res.x
        cert_R = certify(R, data, nx=cert_nx, tau=cert_tau,
                         max_iterations=cert_max_iterations, key=key)
    else:
        cert_R = cert

    return StaircaseResult(R=R, certified=cert_R.certified, cert=cert_R,
                           p_final=p, rank_gap=rank_gap, result=res,
                           levels=tuple(levels))


def mean_rotation_error(R: jnp.ndarray, R_true: jnp.ndarray) -> jnp.ndarray:
    """Gauge-aligned mean chordal error |R G - R_true|_F / sqrt(n) where the
    global gauge G is the polar factor of sum_i R_i^T R_true_i."""
    M = jnp.einsum("nij,nik->jk", R, R_true, precision=_HI)
    G = _orthonormalize(M)
    diff = _mm(R, G) - R_true
    return jnp.sqrt(jnp.sum(diff * diff) / R.shape[0])
