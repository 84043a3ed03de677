"""SE(d) pose synchronization — the full SE-Sync pipeline.

The reference solver suite is the engine behind SE-Sync (certifiable pose
synchronization).  This model composes the framework's pieces into that
pipeline for standard g2o pose graphs:

1. **Rotation stage**: chordal/spectral initialization (LOBPCG on the
   connection Laplacian) + Riemannian TNT refinement on SO(d)^n
   (``models/rotation_sync.py``).
2. **Translation stage**: with rotations fixed, translation recovery is a
   sparse linear least-squares problem solved matrix-free by our LSQR
   (``linalg/lsqr.py``) over the graph incidence operator.

**Measurement convention.**  A g2o edge (i, j) stores the relative pose of j
in frame i:  ``M_e ~= R_i' R_j`` and ``t_e ~= R_i' (t_j - t_i)``.  The
rotation-sync chordal model measures world-frame ratios ``R_i R_j'``
(left-multiplying).  The two are reconciled exactly by solving the chordal
model in *transposed* variables Q_k = R_k':

    |R_j - R_i M_e|_F  =  |Q_j - M_e' Q_i|_F,

i.e. rotation-sync over edges (src=j, dst=i) with measurements M_e', then
R = Q'.  No approximation is involved.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.problem import RiemannianProblem
from ..linalg.lsqr import lsqr
from ..solvers import tnt
from . import rotation_sync as rs

__all__ = ["PoseSyncResult", "solve_pose_graph", "recover_translations",
           "marginalized_problem", "solve_robust_se", "RobustSEResult",
           "gnc_identifiability", "alignment_errors"]


class PoseSyncResult(NamedTuple):
    R: jnp.ndarray           # (n, d, d) world-frame rotations
    t: jnp.ndarray           # (n, d) world-frame translations (anchor at 0)
    rotation_result: Any     # TNTResult of the rotation stage
    translation_residual: jnp.ndarray  # |A t - b| of the recovery LS
    certificate: Any = None  # rotation_sync.CertificateResult when requested


def _transposed_rotation_data(src, dst, Mij, kappa=None):
    """g2o-convention measurements -> chordal model in transposed variables."""
    return rs.RotationSyncData(src=dst, dst=src,
                               Rij=jnp.swapaxes(Mij, -1, -2), kappa=kappa)


def solve_rotations_g2o(src, dst, Mij, n: int, kappa=None,
                        params: Optional[tnt.TNTParams] = None,
                        key=None) -> tuple:
    """Rotation stage for g2o-convention measurements M_e ~= R_i' R_j.

    Returns ``(R, tnt_result)`` with R of shape (n, d, d).
    """
    d = Mij.shape[-1]
    data = _transposed_rotation_data(src, dst, Mij, kappa)
    Q0 = rs.spectral_init(data, n, d, key=key).astype(Mij.dtype)
    if params is None:
        f32 = Mij.dtype == jnp.float32
        params = tnt.TNTParams(
            max_iterations=100,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
    res = tnt.solve(rs.make_problem(), Q0, params, data=data)
    return jnp.swapaxes(res.x, -1, -2), res


def recover_translations(R, src, dst, tij, weights=None, *, anchor: int = 0,
                         max_iterations: int = 2000, btol: float = 1e-8,
                         Atol: float = 1e-8, scatter_method="scatter"):
    """Translation recovery: min_t sum_e w_e |t_j - t_i - R_i t_e|^2.

    Solved matrix-free by LSQR over the weighted incidence operator (one
    gather/scatter pair per product — XLA-fused, no matrix is formed).  The
    global-translation gauge is fixed by re-anchoring t[anchor] = 0.
    ``scatter_method`` picks the A' accumulation strategy
    (``models/graph.edge_accumulator``).  Returns ``(t, residual_norm)``.
    """
    from .graph import edge_accumulator
    n = R.shape[0]
    dt = R.dtype
    acc = edge_accumulator(
        src, dst, n,
        method=("gather" if scatter_method == "adjacency"
                else scatter_method))
    w = (jnp.sqrt(weights).astype(dt)[:, None] if weights is not None
         else jnp.ones((src.shape[0], 1), dt))

    # b_e = R_i t_e rotated into the world frame, weighted
    b = w * jnp.einsum("eij,ej->ei", R[src], tij.astype(dt),
                       precision=jax.lax.Precision.HIGHEST)

    def A(t):
        return w * (t[dst] - t[src])

    def At(r):
        rw = w * r
        return acc(-rw, rw)

    inner = lambda u, v: jnp.sum(u * v)
    res = lsqr(A, At, b, inner, inner, max_iterations=max_iterations,
               btol=btol, Atol=Atol)
    t = res.x - res.x[anchor][None, :]
    r = A(t) - b
    return t, jnp.sqrt(jnp.sum(r * r))


def _weighted_laplacian_solver(src, dst, tau, n, *, max_iterations=400,
                               rtol=None, jacobi=True, with_iters=False,
                               engine="cg", s_steps=2,
                               scatter_method="scatter"):
    """Matrix-free (P)CG solve of the weighted graph Laplacian L_tau z = r
    (L_tau = A' diag(tau) A with A the edge incidence operator), columnwise
    on (n, k) right-hand sides.  Consistent singular systems (columns of r
    sum to zero) stay in range(L_tau) when started at zero, so the minimum-
    norm solution comes out of plain CG.

    ``jacobi=True`` preconditions with the Laplacian diagonal (the weighted
    vertex degree) — the preconditioner seam of the reference
    (``Riemannian/TNT.h:122-125``) instantiated for the inner solve; it
    collapses the iteration count on graphs whose tau weights or degrees
    span orders of magnitude.

    ``engine="cg"`` (default) is the Jacobi-PCG loop with per-iteration
    re-projection onto range(L).  ``engine="flat"`` runs the
    communication-avoiding s-step engine (``linalg/flat_cg.py`` in
    ``solve_mode``) on the symmetrically Jacobi-transformed system
    Lt = D^-1/2 L D^-1/2 — algebraically the same preconditioned
    iteration with one reduction sync per ``s_steps`` iterations, all k
    right-hand-side columns stacked into ONE flat system (not a
    vmap-of-while_loop, whose triple-nested compile is far heavier inside
    the marginalized TNT), and the singular direction (Lt's nullvector
    e = D^1/2 1 / |D^1/2 1|) *grounded* through the engine's low-rank
    term: solving (Lt + sum_c e_c e_c') y = rt with rt projected onto
    range(Lt) once regularizes the system (unit eigenvalue mid-spectrum)
    and actively damps f32 null-direction drift.  The default is
    ``engine="cg"``: the coefficient engine's scalar algebra and larger
    reduction group do not pay at this operator's size, and the per-loop
    sync the s-step design saves is cheap inside a compiled nested loop
    (the flat path is not measured on the card yet).  It stays available,
    exact parity pinned by tests/test_pose_sync.py::TestFlatInnerSolver,
    for scales where syncs dominate.

    ``rtol`` defaults to ``50 * eps(dtype)`` — pushing f32 CG past its
    attainable residual makes the recurrences diverge (loss of orthogonality)
    and silently corrupts the marginalized objective, so the tolerance must
    track the dtype.  A curvature-breakdown guard stops the iteration when
    roundoff makes <p, L p> non-positive (``solve_mode`` in the flat
    engine).

    ``with_iters=True`` makes the returned solve give ``(z, k)`` (iteration
    count, for preconditioner benchmarking) instead of ``z``.

    ``scatter_method`` selects the L-apply strategy
    (``models/graph.laplacian_apply``): ``"scatter"`` (the baseline
    ``.at[].add()`` incidence adjoint), ``"gather"`` (padded incidence
    table — no scatter), ``"sort"`` (sorted ``segment_sum``), or
    ``"adjacency"`` (dense padded-neighbor form — one gather + slot
    reduction, no E-sized intermediate).  Non-scatter methods need
    concrete ``src``/``dst`` (host-side table construction).  The default
    stays ``"scatter"``: another summation order reshuffles the f32 TNT
    trajectory at the objective's noise floor, and the end-to-end solve is
    bound by initialization, compiles and the certificate rather than by
    this operator (``benchmarks/probe_scatter.py`` measures the arms; not
    on the card yet).  Opt in per problem where the operator throughput
    itself dominates.
    """
    from .graph import laplacian_apply
    L = laplacian_apply(src, dst, tau, n, method=scatter_method)
    deg = (jnp.zeros((n,), tau.dtype)
           .at[src].add(tau).at[dst].add(tau))
    inv_deg = 1.0 / jnp.maximum(deg, jnp.finfo(tau.dtype).tiny)

    if engine == "flat":
        from ..linalg.flat_cg import stpcg_flat

        dsq = (jnp.sqrt(jnp.maximum(deg, jnp.finfo(tau.dtype).tiny))
               if jacobi else jnp.ones_like(deg))
        inv_dsq = 1.0 / dsq
        e = dsq / jnp.sqrt(jnp.sum(dsq * dsq))
        def solve_flat(r):
            """All k columns as ONE flat (n*k,) system: a single while_loop
            (not a vmap-of-while_loop, whose triple-nested compile is far
            heavier inside the marginalized TNT) with one joint truncation
            target over the stacked residual; each column gets its own
            grounding vector through the engine's U B U' term."""
            tol = (50.0 * jnp.finfo(r.dtype).eps if rtol is None else rtol)
            k = r.shape[-1]
            rt = inv_dsq[:, None] * r
            rt = rt - e[:, None] * jnp.matmul(   # into range(Lt), once
                e, rt, precision=jax.lax.Precision.HIGHEST)

            def A0(v):
                z = inv_dsq[:, None] * v.reshape(-1, k)
                return (inv_dsq[:, None] * L(z)).reshape(-1)

            ecols = tuple(
                jnp.zeros((e.shape[0], k), e.dtype).at[:, c].set(e).reshape(-1)
                for c in range(k))
            Bk = jnp.eye(k, dtype=r.dtype)

            sol = stpcg_flat(-rt.reshape(-1), A0, ecols, Bk, jnp.inf,
                             max_iterations=max_iterations,
                             kappa_fgr=float(tol), theta=0.0,
                             s_steps=s_steps, solve_mode=True)
            z = inv_dsq[:, None] * sol.s.reshape(-1, k)
            if with_iters:
                return z, sol.num_iterations
            return z

        return solve_flat

    def M(res):
        if not jacobi:
            return res
        v = res * inv_deg[:, None]
        return v - jnp.mean(v, axis=0, keepdims=True)

    def solve(r):
        tol = (50.0 * jnp.finfo(r.dtype).eps if rtol is None else rtol)
        r0n = jnp.sqrt(jnp.sum(r * r))

        def body(c):
            k, z, res, p, rz, ok = c
            Lp = L(p)
            curv = jnp.sum(p * Lp)
            good = curv > 0
            alpha = jnp.where(good, rz / jnp.where(good, curv, 1.0), 0.0)
            z = z + alpha * p
            res = res - alpha * Lp
            v = M(res)
            rz_new = jnp.sum(res * v)
            p = v + (rz_new / rz) * p
            return (k + 1, z, res, p, rz_new, good & (rz_new > 0))

        def cond(c):
            k, z, res, p, rz, ok = c
            return ok & (k < max_iterations) & (jnp.sqrt(jnp.sum(res * res))
                                                > tol * r0n)

        z0 = jnp.zeros_like(r)
        v0 = M(r)
        k, z, _, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), z0, r, v0,
                         jnp.sum(r * v0), jnp.asarray(True)))
        return (z, k) if with_iters else z

    return solve


def marginalized_problem(src, dst, Mij, tij, kappa=None, tau=None,
                         *, n=None, cg_iterations=400, cg_rtol=None,
                         jacobi=True,
                         inner_engine="cg", inner_s_steps=2,
                         scatter_method="scatter"):
    """The full SE-Sync rotation problem with translations marginalized out.

    The SE(d) cost  sum_e kappa_e |R_j - R_i M_e|^2 + tau_e |t_j - t_i -
    R_i t_e|^2  is quadratic in t for fixed R; plugging in the optimal
    translations leaves a quadratic form in the (transposed, stacked)
    rotations:

        f(X) = tr(X' L_conn X) + <B(X), W (I - P) W B(X)>,

    where B(X)_e = t_e' X_{i(e)} (the translation data contracted against the
    source block), W = diag(sqrt(tau)), and P is the orthogonal projector
    onto range(W A) applied through a matrix-free CG solve of the weighted
    graph Laplacian (A = incidence).  This is the single-stage SE-Sync
    objective; minimizing it couples rotations through the translation
    measurements instead of the two-stage rotation-then-translation pipeline.

    Returns ``(problem, Q_op, n)``: a :class:`RiemannianProblem` over
    SO(d)^n in the transposed variables Q_k = R_k' (solve it like
    rotation-sync, then transpose), and the symmetric PSD operator ``Q_op``
    on (n d, k) blocks (for certification via ``rotation_sync.certify``).

    ``cg_rtol`` overrides the nested projector CG's relative tolerance
    (default ``50 * eps(dtype)`` via :func:`_weighted_laplacian_solver`) —
    loose settings (e.g. 1e-4 with a small ``cg_iterations`` cap) build a
    cheap certificate-grade operator whose perturbation of lam_min stays
    inside the certificate slack eta (see ``solve_pose_graph``).

    ``scatter_method`` selects the edge->vertex accumulation strategy used
    by every adjoint in the operator (``models/graph.edge_accumulator``:
    ``"scatter"`` / ``"gather"`` / ``"sort"`` / ``"adjacency"``);
    non-scatter methods need concrete ``src``/``dst``.  ``"adjacency"``
    (incidence adjoints then take the padded-incidence gather form) is
    the candidate ``benchmarks/probe_scatter.py`` times on this Hv at
    config6 scale, but the default stays ``"scatter"`` — see
    :func:`_weighted_laplacian_solver` (another summation order
    reshuffles the f32 trajectory at the noise floor and can land at a
    worse stationary point).
    """
    d = Mij.shape[-1]
    if n is None:
        # Edge-derived fallback; undercounts graphs with trailing isolated
        # vertices and concretizes traced indices — callers with a known
        # vertex count (solve_pose_graph passes graph.n_vertices) supply n.
        n = int(jnp.maximum(jnp.max(src), jnp.max(dst))) + 1
    dtype = Mij.dtype
    if tau is None:
        tau = jnp.ones_like(src, dtype=dtype)
    tau = tau.astype(dtype)
    sqw = jnp.sqrt(tau)

    from .graph import edge_accumulator
    # "adjacency" is a Laplacian-apply strategy; the incidence adjoints
    # A' and B' (per-edge contributions, not vertex fields) take its
    # scatter-free analog, the padded-incidence gather.
    acc_method = "gather" if scatter_method == "adjacency" else scatter_method
    acc_inc = edge_accumulator(src, dst, n, method=acc_method)
    acc_src = edge_accumulator(src, dst, n, method=acc_method,
                               sides=("src",))

    rot_data = _transposed_rotation_data(src, dst, Mij, kappa)
    L_conn = rs.connection_laplacian_op(rot_data, n, d,
                                        scatter_method=scatter_method)
    lap_solve = _weighted_laplacian_solver(src, dst, tau, n,
                                           max_iterations=cg_iterations,
                                           rtol=cg_rtol,
                                           jacobi=jacobi,
                                           engine=inner_engine,
                                           s_steps=inner_s_steps,
                                           scatter_method=scatter_method)

    tijd = tij.astype(dtype)

    def Bop(X):
        # (E, k): rows t_e' X_{src(e)}
        k = X.shape[-1]
        Xb = X.reshape(n, d, k)
        return jnp.einsum("ei,eik->ek", tijd, Xb[src],
                          precision=jax.lax.Precision.HIGHEST)

    def Bt(Y):
        # adjoint: block i accumulates sum_{e: src=i} t_e (x) Y_e
        k = Y.shape[-1]
        contrib = tijd[:, :, None] * Y[:, None, :]          # (E, d, k)
        return acc_src(contrib, None).reshape(n * d, k)

    def A_inc(z):
        return z[dst] - z[src]

    def At_inc(y):
        return acc_inc(-y, y)

    def proj_complement(Y):
        # (I - P) Y with P the projector onto range(W A), per column
        rhs = At_inc(sqw[:, None] * Y)
        z = lap_solve(rhs)
        return Y - sqw[:, None] * A_inc(z)

    def Q_tau(V):
        return Bt(sqw[:, None] * proj_complement(sqw[:, None] * Bop(V)))

    def Q_op(V):
        return L_conn(V) + Q_tau(V)

    def f(Qr, data):
        # Both terms as sums of squared residuals: tr(X' L_conn X) is the
        # chordal cost, and <WB, (I-P) WB> = |(I-P) WB|^2.  The inner-product
        # forms cancel O(|WB|^2) terms down to O(noise^2), which costs f32
        # ~1e-3 relative: enough for the trust region to accept steps on
        # rounding.  The squared form is also second order in the nested
        # CG's truncation error.
        X = Qr.reshape(n * d, d)
        r = proj_complement(sqw[:, None] * Bop(X))
        return rs.chordal_cost(Qr, rot_data) + jnp.sum(r * r)

    # The generic autodiff Hessian cannot differentiate through the inner CG
    # while_loop, so the Riemannian Hessian is analytic.  For f = tr(X'QX)
    # on a product of rotations (projection proj_X(V) = V - X sym(X'V)):
    #     Hess f(X)[V] = proj( 2 Q V - V sym(X_i' G_i) ),   G = 2 Q X,
    # with the Weingarten term inside the projection (verified numerically
    # against the dense autodiff Hessian in tests).
    def _sym(a):
        return 0.5 * (a + jnp.swapaxes(a, -1, -2))

    def _egrad(Qr):
        return (2.0 * Q_op(Qr.reshape(n * d, d))).reshape(n, d, d)

    def grad(Qr, data):
        return rs.ROTATIONS.proj(Qr, _egrad(Qr))

    def quadratic_model(Qr, data):
        G = _egrad(Qr)
        g = rs.ROTATIONS.proj(Qr, G)
        S = _sym(jnp.einsum("nij,nik->njk", Qr, G,
                            precision=jax.lax.Precision.HIGHEST))

        def hvp(V):
            GV = _egrad(V)
            corr = jnp.einsum("nij,njk->nik", V, S,
                              precision=jax.lax.Precision.HIGHEST)
            return rs.ROTATIONS.proj(Qr, GV - corr)

        return g, hvp

    def hess_vec(Qr, V, data):
        _, hvp = quadratic_model(Qr, data)
        return hvp(V)

    problem = RiemannianProblem(f=f, manifold=rs.ROTATIONS, grad=grad,
                                hess_vec=hess_vec,
                                quadratic_model=quadratic_model)
    return problem, Q_op, n


def gnc_identifiability(w, src, dst, n, base=None, threshold=0.5,
                        rel_cut=0.02):
    """Per-vertex identifiability of a GNC/IRLS fit from its final weights.

    An edge counts as *retained* when its final weight clears
    ``rel_cut * median(w)`` — at the Geman-McClure endpoint (mu = 1) even
    clean inliers sit at w ~ (c^2/(c^2+r))^2 ~ 0.25 (their residuals ARE
    the scale estimate) with a noise tail reaching w ~ 1e-2, while
    rejected outliers fall to ~(c^2/r)^2 ~ 1e-6..1e-9; the relative cut
    (default 0.02 * median ~ 5e-3 absolute) sits in the orders-of-
    magnitude gap between the two populations without assuming an
    absolute weight scale.  ``frac_i`` is the base-information-
    weighted retained fraction of vertex i's incident edges;
    ``identifiable_i = frac_i >= threshold`` (strict inlier majority).

    A vertex that keeps the majority is anchored by an inlier consensus;
    one that loses it sits between (near-)equal-cost robust basins and its
    estimate is reported as ambiguous rather than trusted silently — the
    same philosophy as the framework's status enums and LOBPCG
    ``pencil_consistent`` flag (reference status reporting seam:
    ``Riemannian/TNT.h:134-164``).  The median baseline assumes the fit
    itself is majority-inlier globally (GNC's own working assumption); a
    *mutually consistent* corrupted majority is indistinguishable from
    inliers by any weight-based criterion.

    Returns ``(identifiable (n,) bool, frac (n,))``.
    """
    base = (jnp.ones_like(w) if base is None else base)
    retained = (w >= rel_cut * jnp.median(w)).astype(w.dtype)
    mass = (jnp.zeros((n,), w.dtype)
            .at[src].add(base * retained).at[dst].add(base * retained))
    total = (jnp.zeros((n,), w.dtype)
             .at[src].add(base).at[dst].add(base))
    frac = mass / jnp.maximum(total, jnp.finfo(w.dtype).tiny)
    return frac >= threshold, frac


class RobustSEResult(NamedTuple):
    R: jnp.ndarray            # (n, d, d) robust rotations
    t: jnp.ndarray            # (n, d) robust translations
    w_rot: jnp.ndarray        # (E,) final rotation-channel GNC weights
    w_tr: jnp.ndarray         # (E,) final translation-channel GNC weights
    result: Any               # TNTResult of the last GNC stage
    # Per-vertex flag (gnc_identifiability, min over both channels) and its
    # conjunction: False marks vertices whose incident inlier mass lost the
    # majority — fundamentally ambiguous robust estimates.
    identifiable: jnp.ndarray
    all_identifiable: jnp.ndarray


def solve_robust_se(src, dst, Mij, tij, n, *, kappa=None, tau=None,
                    params: Optional[tnt.TNTParams] = None,
                    gnc_steps: int = 6, mu0: float = 64.0,
                    c2_rot=None, c2_tr=None, anchor: int = 0, key=None,
                    weight_floor: float = 1e-4,
                    scatter_method: str = "scatter") -> "RobustSEResult":
    """Outlier-robust SE(d) pose synchronization: Geman-McClure graduated
    non-convexity over the *marginalized* single-stage objective, reweighting
    both measurement channels of every edge through their information seams
    — kappa (rotation) and tau (translation).

    This extends ``rotation_sync.solve_robust`` (rotation-only GNC) to the
    full SE(d) cost: each GNC stage solves the translation-marginalized
    problem (:func:`marginalized_problem`) with the current per-edge weights,
    recovers translations, and updates

        w_e^rot = ( mu c_rot^2 / (mu c_rot^2 + r_e^rot) )^2,
        w_e^tr  = ( mu c_tr^2  / (mu c_tr^2  + r_e^tr ) )^2,

    with  r_e^rot = kappa_e |R_j - R_i M_e|_F^2  and
    r_e^tr = tau_e |t_j - t_i - R_i t_e|^2,  annealing mu from ``mu0`` down
    to 1 (mu -> inf is the convex quadratic; mu = 1 is Geman-McClure).  A
    rotation-outlier edge is thus also down-weighted in the translation
    recovery and vice versa — translation-only outliers (wrong loop-closure
    offsets with a correct relative rotation) are caught through the tau
    seam, which the rotation-only GNC cannot see.

    ``c2_rot`` / ``c2_tr`` are the inlier scales (squared residuals);
    default to the median residuals of the initial fit.

    ``weight_floor`` clamps the weights *used in the solves* from below
    (the returned weights are unfloored): Geman-McClure drives outlier
    weights to ~(c^2/r)^2 ~ 1e-9, and a translational weight that small
    makes the marginalized objective's inner Laplacian effectively
    disconnected (condition ~ 1/w), stalling its CG; the floor caps the
    conditioning while still suppressing outliers by 1/weight_floor.

    Returns a :class:`RobustSEResult` ``(R, t, w_rot, w_tr, result,
    identifiable, all_identifiable)``.  ``identifiable`` is the per-vertex
    flag of :func:`gnc_identifiability` evaluated at the final weights
    (min over the rotation and translation channels): a vertex whose
    incident measurements keep a strict inlier-mass majority.  Vertices
    with a local outlier majority sit between two (near-)equal-cost robust
    basins — the estimate there is fundamentally ambiguous, and the flag
    makes that visible instead of silently returning one basin.  (A
    *mutually consistent* corrupted majority is indistinguishable from
    inliers by any weight-based criterion; the flag reports retained-mass
    minority, the detectable failure mode.)
    """
    dtype = Mij.dtype
    base_kappa = (kappa if kappa is not None
                  else jnp.ones_like(src, dtype=dtype))
    base_tau = (tau if tau is not None
                else jnp.ones_like(src, dtype=dtype))

    def rot_residuals(R):
        pred = jnp.einsum("eij,ejk->eik", R[src], Mij,
                          precision=jax.lax.Precision.HIGHEST)
        return base_kappa * jnp.sum((R[dst] - pred) ** 2, axis=(-1, -2))

    def tr_residuals(R, t):
        pred = jnp.einsum("eij,ej->ei", R[src], tij,
                          precision=jax.lax.Precision.HIGHEST)
        return base_tau * jnp.sum((t[dst] - t[src] - pred) ** 2, axis=-1)

    if params is None:
        f32 = dtype == jnp.float32
        params = tnt.TNTParams(
            max_iterations=60,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)

    # Initial fit: spectral rotations + an IRLS-robustified translation fit.
    # The translation recovery is *linear* in t, so a plain least-squares
    # initial fit is dragged arbitrarily far by large translation outliers —
    # which inflates every edge residual and hence the median-based inlier
    # scale c2_tr by orders of magnitude, neutering the GNC weights (the
    # first marginalized stage then chases the corrupted translations and
    # destroys the rotations; observed on the 20%-outlier fixture).  A few
    # Geman-McClure IRLS rounds on the translation-only subproblem make the
    # initial fit, and therefore the scale estimate, outlier-proof.
    rot_data = _transposed_rotation_data(src, dst, Mij, base_kappa)
    Q = rs.spectral_init(rot_data, n, Mij.shape[-1], key=key).astype(dtype)
    R = jnp.swapaxes(Q, -1, -2)
    wt = jnp.ones_like(src, dtype=dtype)
    for _ in range(5):
        t, _ = recover_translations(R, src, dst, tij,
                                    weights=base_tau * wt, anchor=anchor,
                                    scatter_method=scatter_method)
        r_tr = tr_residuals(R, t)
        c2t_cur = jnp.maximum(jnp.median(r_tr),
                              jnp.asarray(1e-12, dtype))
        wt = (c2t_cur / (c2t_cur + r_tr)) ** 2
    r_rot = rot_residuals(R)
    r_tr = tr_residuals(R, t)

    def scale(c2, r):
        c = jnp.median(r) if c2 is None else jnp.asarray(c2, dtype)
        return jnp.maximum(c.astype(dtype), jnp.asarray(1e-12, dtype))

    c2r = scale(c2_rot, r_rot)
    c2t = scale(c2_tr, r_tr)

    mus = jnp.logspace(jnp.log10(mu0), 0.0, gnc_steps).astype(dtype)
    res = None
    w_rot = jnp.ones_like(r_rot)
    w_tr = jnp.ones_like(r_tr)
    floor = jnp.asarray(weight_floor, dtype)
    for mu in list(mus):
        w_rot = ((mu * c2r) / (mu * c2r + r_rot)) ** 2
        w_tr = ((mu * c2t) / (mu * c2t + r_tr)) ** 2
        problem, _, _ = marginalized_problem(
            src, dst, Mij, tij,
            kappa=base_kappa * jnp.maximum(w_rot, floor),
            tau=base_tau * jnp.maximum(w_tr, floor), n=n,
            scatter_method=scatter_method)
        res = tnt.solve(problem, Q, params)
        Q = res.x
        R = jnp.swapaxes(Q, -1, -2)
        t, _ = recover_translations(
            R, src, dst, tij,
            weights=base_tau * jnp.maximum(w_tr, floor), anchor=anchor,
            scatter_method=scatter_method)
        r_rot = rot_residuals(R)
        r_tr = tr_residuals(R, t)

    id_rot, frac_rot = gnc_identifiability(w_rot, src, dst, n, base_kappa)
    id_tr, frac_tr = gnc_identifiability(w_tr, src, dst, n, base_tau)
    identifiable = id_rot & id_tr
    return RobustSEResult(R=R, t=t, w_rot=w_rot, w_tr=w_tr, result=res,
                          identifiable=identifiable,
                          all_identifiable=jnp.all(identifiable))


def alignment_errors(R, t, R_true, t_true):
    """Errors after optimal world-gauge alignment.

    The pose-graph gauge is a global rigid motion acting on the *left*:
    R_i -> G R_i, t_i -> G t_i + c.  Returns ``(mean_rot_err, max_t_err)``
    with the chordal mean |G R_i - R_true_i|_F / sqrt(n) and the max
    translation deviation after the optimal (G, c).
    """
    n = R.shape[0]
    M = jnp.einsum("nij,nkj->ik", R_true, R,
                   precision=jax.lax.Precision.HIGHEST)  # sum R_true R'
    # polar factor restricted to SO(d)
    u, _, vt = jnp.linalg.svd(M)
    hi = jax.lax.Precision.HIGHEST
    s = jnp.ones(M.shape[0]).at[-1].set(
        jnp.sign(jnp.linalg.det(jnp.matmul(u, vt, precision=hi))))
    G = jnp.matmul(u * s[None, :], vt, precision=hi)
    rot_err = jnp.sqrt(jnp.sum((jnp.einsum("ij,njk->nik", G, R, precision=hi)
                                - R_true) ** 2) / n)
    tG = jnp.einsum("ij,nj->ni", G, t, precision=hi)
    c = jnp.mean(t_true - tG, axis=0)
    t_err = jnp.max(jnp.abs(tG + c - t_true))
    return rot_err, t_err


def solve_pose_graph(graph, *, dtype=jnp.float32,
                     params: Optional[tnt.TNTParams] = None,
                     anchor: int = 0, key=None,
                     certify: bool = False,
                     cert_fast: bool = False,
                     marginalized: bool = False,
                     tau=None, inner_engine="cg",
                     inner_s_steps=2, staircase: bool = False,
                     scatter_method: str = "scatter") -> PoseSyncResult:
    """Full SE(d) pose synchronization of an ``io.g2o.PoseGraph``.

    With ``certify=True`` the rotation estimate is checked for *global*
    optimality via the SE-Sync dual certificate (``rotation_sync.certify``:
    smallest eigenvalue of S = Q - Lambda via LOBPCG).  ``cert_fast=True``
    runs that eigenproblem in its cheap configuration — one-eigh
    shifted-Cholesky Rayleigh-Ritz plus the block-Jacobi certificate
    preconditioner (the latter applies on the chordal path only; the
    marginalized operator's diagonal blocks are not closed-form).

    With ``marginalized=True`` the rotation stage minimizes the full SE-Sync
    objective with translations marginalized out (:func:`marginalized_
    problem`) instead of the rotation-only chordal cost — the translation
    measurements then inform the rotations.  ``tau`` supplies per-edge
    translational weights (defaults to 1).

    With ``staircase=True`` the rotation stage runs the **Riemannian
    staircase** (``rotation_sync.solve_staircase``): if the chordal solve
    lands on a non-global critical point (dual certificate fails), the
    problem is lifted through rank-p relaxations, escaped along the
    certificate eigenvector, and rounded back — returning a certifiably
    global rotation estimate where the plain solve would silently return
    the stuck one.  Mutually exclusive with ``marginalized``.

    ``scatter_method`` (marginalized path) picks the edge->vertex
    accumulation strategy of the operator adjoints — see
    :func:`marginalized_problem`."""
    src = jnp.asarray(graph.src)
    dst = jnp.asarray(graph.dst)
    Mij = jnp.asarray(graph.Rij, dtype)
    tij = jnp.asarray(graph.tij, dtype)
    kappa = (jnp.asarray(graph.kappa, dtype)
             if graph.kappa is not None else None)

    if marginalized:
        problem, Q_op, n = marginalized_problem(src, dst, Mij, tij,
                                                kappa=kappa, tau=tau,
                                                n=graph.n_vertices,
                                                inner_engine=inner_engine,
                                                inner_s_steps=inner_s_steps,
                                                scatter_method=scatter_method)
        rot_data = _transposed_rotation_data(src, dst, Mij, kappa)
        Q0 = rs.spectral_init(rot_data, n, Mij.shape[-1], key=key,
                              scatter_method=scatter_method).astype(dtype)
        if params is None:
            f32 = dtype == jnp.float32
            params = tnt.TNTParams(
                max_iterations=100,
                gradient_tolerance=(2e-3 if f32 else 1e-8),
                relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
                preconditioned_gradient_tolerance=0.0)
        rres = tnt.solve(problem, Q0, params)
        R = jnp.swapaxes(rres.x, -1, -2)
        # Certificate operator with a LOOSE nested projector CG: each
        # certificate application of Q contains a
        # weighted-Laplacian CG solve, and the optimizer's tolerance
        # (50 eps ~ 6e-6 f32, cap 400) is far tighter than the
        # certificate needs — the lam_min SIGN decision carries slack
        # eta = 1e3 eps(dtype) |L| (rotation_sync.certify's default), so
        # in f32 (eta ~ 1.2e-4 |L|) a projector residual of 1e-4 relative
        # perturbs lam_min ~500x inside eta (measured: 4.1e-6 loose vs
        # 1.7e-6 tight on the test fixture).  The slack SCALES WITH THE
        # DTYPE: in f64 eta ~ 2e-13 |L| and any loose inner residual
        # swamps it, so f64 certificates keep the optimizer-grade
        # operator.  Decision parity pinned by tests/test_pose_sync.py
        # (loose == tight on both certifying and non-certifying points).
        cert_op = Q_op
        if dtype == jnp.float32:
            _, cert_op, _ = marginalized_problem(
                src, dst, Mij, tij, kappa=kappa, tau=tau,
                n=graph.n_vertices, cg_iterations=60, cg_rtol=1e-4,
                inner_engine=inner_engine, inner_s_steps=inner_s_steps,
                scatter_method=scatter_method)
        cert_x = rres.x
    elif staircase:
        # Certifiably-global rotation stage: the Riemannian staircase on
        # the transposed chordal model (rotation_sync.solve_staircase);
        # the returned certificate is re-derived below at the final point.
        sdata = _transposed_rotation_data(src, dst, Mij, kappa)
        out = rs.solve_staircase(sdata, graph.n_vertices, Mij.shape[-1],
                                 params=params, key=key)
        R = jnp.swapaxes(out.R, -1, -2)
        rres = out.result
        cert_op = None
        cert_x = out.R
    else:
        R, rres = solve_rotations_g2o(src, dst, Mij, graph.n_vertices,
                                      kappa=kappa, params=params, key=key)
        cert_op = None
        cert_x = jnp.swapaxes(R, -1, -2)

    t, tres = recover_translations(R, src, dst, tij,
                                   weights=tau, anchor=anchor,
                                   scatter_method=scatter_method)
    cert = None
    if certify:
        # Certify in the transposed (chordal-model) variables on the same
        # objective the rotation stage minimized (L for the chordal model,
        # the full marginalized Q when marginalized=True).  The
        # marginalized certificate defaults to the one-eigh shifted-
        # Cholesky Rayleigh-Ritz: at 10^4 poses it certifies in fewer
        # LOBPCG iterations than the eigh RR and compiles one eigh program
        # instead of two (benchmarks/probe_pose_stages.py).
        cert = rs.certify(cert_x,
                          _transposed_rotation_data(src, dst, Mij, kappa),
                          operator=cert_op,
                          rr_method=("chol" if (cert_fast or marginalized)
                                     else "eigh"),
                          precondition=cert_fast,
                          scatter_method=scatter_method)
    return PoseSyncResult(R=R, t=t, rotation_result=rres,
                          translation_residual=tres, certificate=cert)
