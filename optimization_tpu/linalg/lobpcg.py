"""LOBPCG block eigensolver (Duersch-Shao-Yang-Gu robust variant).

Computes the ``nev`` algebraically-smallest eigenpairs of the symmetric
generalized problem  A x = lambda B x  (B SPD), following the same algorithm
as the reference ``LOBPCG`` (``LinearAlgebra/LOBPCG.h:131-337``):
Rayleigh-Ritz on the three-block subspace S = [X | W | P] with diagonal
equilibration, soft locking of the contiguous converged prefix, randomized
2-norm estimates of A and B, and the scale-invariant convergence test

    r_i <= tau * (|A|_est + theta_i |B|_est) * |x_i|         (LOBPCG.h:292-307)

**Static-shape redesign — soft locking.**  XLA requires static
shapes, so instead of shrinking the basis (reference ``LOBPCG.h:249-264``
keeps ``ns = 3 nx - 2 nc`` live columns), S is always (m, 3 nx) and locked
W/P columns are *zeroed*; the Gram pencil is then repaired by writing 1
(resp. a moderate *negative* sentinel) into the masked diagonal of S'BS
(resp. S'AS).  The pencil decouples exactly into the active block plus
trivial fake eigenpairs that sort first; the active Ritz pairs are read from
the static-width window starting at the known fake count, so they are
*bitwise the mathematics of the reference's shrunken basis*.  (Sentinels are
kept near the active spectrum's scale: an eigh that normalizes by the
matrix norm (QDWH-based lowerings do) loses f32 accuracy to 1/eps-scale
sentinels.)  All heavy math is three (m x 3nx) block operator applications
and (3nx x m)@(m x 3nx) Gram GEMMs; the small (3nx)^2 eigensolve runs as a
single fused ``eigh``.

Efficiency deviation (documented): the reference recomputes ``AX = A(X)``
after the Rayleigh-Ritz step (``LOBPCG.h:281-282``); we form ``AX = AS @ C_x``
(algebraically identical) to save one block operator application per
iteration.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from ..core.debug import pad_value

__all__ = ["LOBPCGResult", "lobpcg", "lobpcg_fleet", "rayleigh_ritz"]


def _mm(a, b):
    """Full-precision matmul: reduced-precision inputs (a GPU's TF32
    default keeps ~3 decimal digits) destroy the Gram pencil / Ritz
    rotations in f32, so every precision-critical GEMM in this module pins
    HIGHEST precision."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def rayleigh_ritz(A: jnp.ndarray, B: jnp.ndarray,
                  eigh_fn: Optional[Callable[[jnp.ndarray], Tuple[
                      jnp.ndarray, jnp.ndarray]]] = None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Robust Rayleigh-Ritz for the dense symmetric pencil (A, B), B PSD.

    Returns ``(Theta, C)`` with ``C' A C = diag(Theta)`` and ``C' B C = I``
    on the numerically independent subspace, eigenvalues ascending.

    Equilibrates B by its diagonal first (reference ``LOBPCG.h:53-62``), then
    — instead of the reference's Cholesky route, which collapses in f32 when
    the LOBPCG basis grows near-collinear — whitens through the
    eigendecomposition of B with **spectral filtering** (the SVQB-style
    robustness of Duersch-Shao-Yang-Gu): directions of B_eq with relative
    eigenvalue below k*eps are deflated (their C columns are exactly zero and
    their Ritz values are a large sentinel, so they sort last and are never
    selected).  In f64 on a well-conditioned pencil this is algebraically the
    reference computation.

    ``eigh_fn`` overrides the dense symmetric eigensolver (default
    ``jnp.linalg.eigh``).  :func:`optimization_tpu.linalg.jacobi.jacobi_eigh`
    is the alternative whose cost batches for free when this RR runs vmapped
    over a fleet (benchmarks/probe_jacobi.py compares the two).
    """
    if eigh_fn is None:
        eigh_fn = jnp.linalg.eigh
    # The matmul-precision scope also covers the matmuls inside XLA's eigh
    # lowering — at a reduced-precision default the Ritz rotations come
    # back too inaccurate to converge.
    with jax.default_matmul_precision("float32"):
        n = B.shape[0]
        eps = jnp.finfo(B.dtype).eps
        bdiag = jnp.diagonal(B)
        d = 1.0 / jnp.sqrt(jnp.maximum(bdiag, eps * jnp.max(bdiag)))
        A_eq = A * d[:, None] * d[None, :]
        B_eq = B * d[:, None] * d[None, :]
        B_eq = 0.5 * (B_eq + B_eq.T)

        w, Q = eigh_fn(B_eq)
        good = w > (n * eps) * jnp.max(w)
        inv_sqrt_w = jnp.where(good,
                               1.0 / jnp.sqrt(jnp.where(good, w, 1.0)), 0.0)
        W_half = Q * inv_sqrt_w[None, :]      # whitening: W' B_eq W = I_good
        At = _mm(_mm(W_half.T, A_eq), W_half)
        At = 0.5 * (At + At.T)
        # Deflated rows/cols of At are exactly zero; a sentinel diagonal
        # decouples them and sorts their fake eigenvalues last.  The sentinel
        # is the Gershgorin upper bound (max absolute row sum) of At — a
        # *guaranteed* bound on every eigenvalue (a max-|entry| heuristic can
        # be beaten by a factor of n, e.g. the all-ones matrix), yet within
        # a factor n of the spectrum's scale: an eigh that normalizes by
        # |At| (QDWH-based) would see 1/eps-scale sentinels push the active
        # eigenvalues below f32 resolution.
        big = jnp.max(jnp.sum(jnp.abs(At), axis=1)) + 1.0
        At = At + jnp.diag(jnp.where(good, 0.0, big).astype(B.dtype))
        theta, U = eigh_fn(At)
        C = _mm(W_half, U)
        return theta, C * d[:, None]


def _rayleigh_ritz_chol(A: jnp.ndarray, B: jnp.ndarray,
                        eigh_fn=jnp.linalg.eigh, u_prev=None,
                        jacobi_sweeps: int = 6):
    """Rayleigh-Ritz via shifted Cholesky whitening: the fleet fast path.

    The robust :func:`rayleigh_ritz` pays TWO dense eigendecompositions per
    call; under ``jax.vmap`` (``lobpcg_fleet``) the batched small eighs
    dominate the lockstep iteration (benchmarks/probe_jacobi.py times the
    arms).  This variant whitens through a
    *shifted* Cholesky factorization instead — one batched ``cholesky`` plus
    two triangular solves replace the whitening eigh, halving the eigh count.

    This is close to the reference's own route (``LOBPCG.h:53-62`` LDLT on
    the equilibrated pencil), whose f32 failure mode — a near-collinear
    basis makes one-pass Cholesky whitening amplify null-direction noise
    into spurious small Ritz values (observed on the *first* LOBPCG
    iterations of an easy diagonal problem) — is repaired WITHOUT a second
    eigh:

    - a norm-relative shift ``delta = 16 n eps`` keeps the factorization of
      the unit-diagonal ``B_eq`` well-posed;
    - **two whitening passes** (the CholeskyQR2 idea, in pencil space): the
      second factorization acts on the first pass's near-identity whitened
      Gram, collapsing the kappa*eps orthonormality error of one-pass
      whitening (which otherwise floors LOBPCG residuals at
      ~kappa * eps * ||A|| and stalls convergence — observed) down to
      O(eps).  Valid while kappa(B_eq + delta I) <= 1/eps, guaranteed here
      by the shift;
    - each Ritz column's TRUE B-mass ``b_i = C_i' B_eq C_i`` is then
      computed directly (two small GEMMs): a (near-)null direction of
      ``B_eq`` — whose whitened mass was supplied by the shift — has
      ``b_i ~ 0`` while genuine directions have ``b_i ~ 1``.  Columns with
      ``b_i < 0.5`` get the eigh path's deflation treatment (zeroed,
      Gershgorin-sentinel Ritz value, sorted last); kept columns are
      rescaled by ``1/sqrt(b_i)`` (exact B-normalization) and their Ritz
      values refreshed as unshifted Rayleigh quotients
      ``C_i' A_eq C_i`` — removing the shift's O(delta/lambda) bias.

    Directions with B-eigenvalue *comparable* to the shift sit in a
    borderline band (deflate vs keep) — the same continuum the eigh path's
    ``n eps`` cutoff has; as with that path it is treated as approximation,
    not anomaly (a wrongly kept direction cannot be silently selected: the
    residual-based convergence test rejects it).  The returned ``ok`` flag
    therefore reports only genuine breakdown (non-finite Ritz values, e.g.
    a Cholesky NaN on an indefinite repaired pencil); callers fold it into
    ``pencil_consistent``.

    Returns ``(theta, C, ok)`` with eigenvalues ascending (deflated columns
    last), ``C' B C ~ I`` on the kept subspace.

    ``u_prev`` optionally WARM-STARTS the whitened eigenproblem with the
    previous lockstep iteration's raw eigenvector matrix (the
    ``rr_method="chol_warm"`` path): the eigh of At is then a
    threshold-Jacobi solve seeded by ``u_prev`` (``jacobi_eigh(v0=)``,
    capped at ``jacobi_sweeps``).  The return grows to
    ``(theta, C, ok, U)`` with ``U`` the raw eigenvectors to seed the
    next call.  In-fleet the live basis changes enough per lockstep
    iteration that the seeded solve needs several sweeps, and eigenvalue
    accuracy degrades when the sweep cap bites on stale seeds
    (benchmarks/probe_warm_rr.py).  The fleet default stays "chol";
    "chol_warm" is a tested opt-in for devices with cheap loop steps.
    """
    with jax.default_matmul_precision("float32"):
        n = B.shape[0]
        eps = jnp.finfo(B.dtype).eps
        eye = jnp.eye(n, dtype=B.dtype)
        bdiag = jnp.diagonal(B)
        d = 1.0 / jnp.sqrt(jnp.maximum(bdiag, eps * jnp.max(bdiag)))
        A_eq = A * d[:, None] * d[None, :]
        B_eq = 0.5 * (B + B.T) * d[:, None] * d[None, :]

        tri_inv = partial(jax.scipy.linalg.solve_triangular, lower=True)
        # Sharp shift first, safe shift as fallback.  The shift must
        # dominate B_eq's roundoff indefiniteness or the factorization
        # NaNs; that indefiniteness scales with ||B_eq|| <= n (unit
        # diagonal) and can reach ~ -n^2 eps on genuinely near-collinear
        # pencils (observed), but is ~n eps-scale on typical ones.  A
        # large one-size shift costs real convergence: the deflation
        # boundary (b-mass test below) sits at lambda ~ delta, and late
        # LOBPCG residual directions shrink THROUGH a 4 n^2 eps cutoff
        # before tight tolerances are reached (observed stall at
        # tau=1e-5).  So: factor with 16 n eps, and only where that NaNs
        # redo with 8 n^2 eps — two batched Cholesky calls are still far
        # cheaper than the eigh this path replaces.
        d_lo = 16.0 * n * eps
        d_hi = 8.0 * n * n * eps
        L1a = jnp.linalg.cholesky(B_eq + d_lo * eye)
        sharp_ok = jnp.all(jnp.isfinite(L1a))
        delta = jnp.where(sharp_ok, d_lo, d_hi)
        L1 = jnp.where(sharp_ok, L1a,
                       jnp.linalg.cholesky(B_eq + d_hi * eye))
        L1i = tri_inv(L1, eye)
        A1 = _mm(_mm(L1i, A_eq), L1i.T)
        B1 = _mm(_mm(L1i, B_eq), L1i.T)        # ~ I up to kappa*eps + shift
        # Pass-2 shift: a *negative* Gram eigenvalue lambda ~ -rho
        # (roundoff indefiniteness) maps to lambda/(lambda+delta) in B1 —
        # down to ~ -1/15 when delta is ~16x the indefiniteness scale
        # (observed -0.031 on a rank-1 f64 Gram) — plus B1's own
        # ~n*eps*||L1i||^2 computation error.  1/8 dominates both with
        # margin, and a LARGE pass-2 shift is harmless: genuine directions
        # have B1-eigenvalue in [0.5, 1] far above it, and the exact
        # B-mass rescale + unshifted Rayleigh refresh below remove its
        # bias entirely.
        L2 = jnp.linalg.cholesky(0.5 * (B1 + B1.T) + 0.125 * eye)
        L2i = tri_inv(L2, eye)
        At = _mm(_mm(L2i, A1), L2i.T)
        At = 0.5 * (At + At.T)
        if u_prev is not None:
            from .jacobi import jacobi_eigh
            theta0, U = jacobi_eigh(At, v0=u_prev,
                                    max_sweeps=jacobi_sweeps)
        else:
            theta0, U = eigh_fn(At)
        C = _mm(_mm(L2i, L1i).T, U)

        # True (unshifted) per-column B-mass: deflation detect + polish.
        BC = _mm(B_eq, C)
        b = jnp.sum(C * BC, axis=0)
        finite = (jnp.all(jnp.isfinite(C), axis=0) & jnp.isfinite(b)
                  & jnp.isfinite(theta0))
        spurious = (b < 0.5) | ~finite
        C = jnp.where(spurious[None, :], 0.0,
                      C / jnp.sqrt(jnp.maximum(b, delta))[None, :])
        # Unshifted Rayleigh refresh (B-normalized columns => denominator 1).
        theta = jnp.sum(C * _mm(A_eq, C), axis=0)
        big = jnp.max(jnp.sum(jnp.abs(At), axis=1)) + 1.0
        theta = jnp.where(spurious, big, theta)
        ok = jnp.all(jnp.isfinite(theta0))
        order = jnp.argsort(theta)
        if u_prev is not None:
            return (theta[order], C[:, order] * d[:, None], ok,
                    U[:, order])
        return theta[order], C[:, order] * d[:, None], ok


class LOBPCGResult(NamedTuple):
    theta: jnp.ndarray            # (nev,) Ritz values
    X: jnp.ndarray                # (m, nev) Ritz vectors
    num_iterations: jnp.ndarray
    num_converged: jnp.ndarray
    residual_norms: jnp.ndarray   # (nev,) at exit
    # True iff every iteration's repaired pencil decoupled as designed (the
    # masked fake pairs were all identified by their basis energy).  False
    # flags a sentinel/eigenvector-mixing anomaly instead of silently
    # returning wrong eigenpairs.
    # Plain Python default (not jnp.asarray): a traced-array default would
    # execute at import time and commit the JAX backend before user code can
    # configure it.
    pencil_consistent: Any = True
    # Per-iteration traces (NaN/-1 beyond num_iterations): max residual over
    # the nev wanted pairs, and the converged-prefix count.
    residual_trace: Optional[jnp.ndarray] = None
    nc_trace: Optional[jnp.ndarray] = None
    # Full loop state; pass back as ``warm_start=`` to resume exactly (the
    # host-chunked driver seam, core/driver.py:drive_lobpcg).
    warm_start: Optional[tuple] = None


class _State(NamedTuple):
    k: jnp.ndarray
    X: jnp.ndarray
    AX: jnp.ndarray
    BX: jnp.ndarray
    R: jnp.ndarray
    P: jnp.ndarray
    theta: jnp.ndarray
    nc: jnp.ndarray
    r: jnp.ndarray
    done: jnp.ndarray
    ok: jnp.ndarray
    residual_trace: jnp.ndarray
    nc_trace: jnp.ndarray
    # Raw eigenvector seed of the whitened RR pencil (rr_method
    # "chol_warm" only; () otherwise so the pytree stays uniform)
    Useed: object = ()


def lobpcg(
    A: Callable[[jnp.ndarray], jnp.ndarray],
    B: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    T: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    *,
    X0: Optional[jnp.ndarray] = None,
    m: Optional[int] = None,
    nx: Optional[int] = None,
    nev: int,
    max_iterations: int = 100,
    tau: float = 1e-6,
    key: Optional[jax.Array] = None,
    user_function: Optional[Callable[..., jnp.ndarray]] = None,
    warm_start: Optional[tuple] = None,
    eigh_fn: Optional[Callable[[jnp.ndarray], Tuple[jnp.ndarray,
                                                    jnp.ndarray]]] = None,
    rr_method: str = "eigh",
) -> LOBPCGResult:
    """Smallest ``nev`` eigenpairs of ``A x = lambda B x``.

    - ``A(S)``: symmetric block operator on (m, k) matrices.
    - ``B``: optional SPD block operator (absent => standard eigenproblem).
    - ``T``: optional SPD preconditioner approximating A^{-1}.
    - ``X0``: (m, nx) initial block; if omitted, a random Gaussian block of
      shape (m, nx) is drawn (reference ``LOBPCG.h:376-390``).
    - ``tau``: scale-invariant convergence tolerance (``LOBPCG.h:121-126``).
    - ``user_function(k, nev, theta, X, r, nc) -> bool``: optional pure
      stopping predicate (analog of ``LOBPCGUserFunction``,
      ``LOBPCG.h:86-93,322-324``).
    - ``warm_start``: a ``result.warm_start`` tuple from a previous call with
      the same operators/shapes: resumes the three-block iteration exactly
      (the host-chunked driver seam; ``max_iterations`` then counts
      *additional* iterations).
    - ``eigh_fn``: dense symmetric eigensolver for the (3nx)^2 Rayleigh-Ritz
      pencils (default ``jnp.linalg.eigh``); see :func:`rayleigh_ritz`.
    - ``rr_method``: ``"eigh"`` (default; deflating eigh whitening, robust to
      near-collinear bases), ``"chol"`` (shifted-Cholesky whitening — one
      eigh per iteration instead of two; ill-conditioning is *reported* via
      ``pencil_consistent`` instead of deflated.  The fleet fast path —
      see :func:`_rayleigh_ritz_chol`), or ``"chol_warm"`` (the chol path
      with its eigh warm-started from the previous iteration's Ritz
      rotation via threshold Jacobi; a tested opt-in, see
      :func:`_rayleigh_ritz_chol`).
    """
    if rr_method not in ("eigh", "chol", "chol_warm"):
        raise ValueError(
            'rr_method must be "eigh", "chol", or "chol_warm"')
    if key is None:
        key = jax.random.PRNGKey(0)
    if X0 is None:
        if m is None or nx is None:
            raise ValueError("Either X0 or (m, nx) must be supplied")
        key, sub = jax.random.split(key)
        X0 = jax.random.normal(sub, (m, nx))
    m, nx = X0.shape
    if nev > nx:
        raise ValueError("Block size nx must be greater than or equal to "
                         "the number nev of desired eigenpairs")
    if nx > m:
        raise ValueError("Block size nx must be less than or equal to "
                         "the dimension m of the problem")

    dtype = X0.dtype
    Bop = B if B is not None else (lambda S: S)
    Top = T if T is not None else (lambda S: S)

    warm_rr = rr_method == "chol_warm"
    if rr_method in ("chol", "chol_warm"):
        base_eigh = eigh_fn if eigh_fn is not None else jnp.linalg.eigh

        def _rr(Am, Bm):
            return _rayleigh_ritz_chol(Am, Bm, eigh_fn=base_eigh)

        def _rr_loop(Am, Bm, useed):
            if not warm_rr:
                th, Cm, ok = _rayleigh_ritz_chol(Am, Bm,
                                                 eigh_fn=base_eigh)
                return th, Cm, ok, useed
            return _rayleigh_ritz_chol(Am, Bm, eigh_fn=base_eigh,
                                       u_prev=useed)
    else:
        def _rr(Am, Bm):
            th, Cm = rayleigh_ritz(Am, Bm, eigh_fn=eigh_fn)
            return th, Cm, jnp.asarray(True)

        def _rr_loop(Am, Bm, useed):
            th, Cm, ok = _rr(Am, Bm)
            return th, Cm, ok, useed

    # Randomized 2-norm estimates (reference LOBPCG.h:199-214)
    omega = jax.random.normal(key, (m, nx), dtype)
    omega_norm = jnp.linalg.norm(omega)
    A2normest = jnp.linalg.norm(A(omega)) / omega_norm
    B2normest = (jnp.linalg.norm(Bop(omega)) / omega_norm
                 if B is not None else jnp.ones((), dtype))

    # Sentinel eigenvalue written into the A-diagonal of masked (locked)
    # basis columns.  Its exact value no longer carries correctness weight:
    # fake pairs are identified *post hoc* by their basis energy (the
    # repaired pencil decouples exactly, so a fake eigenvector is supported
    # on the masked coordinates, whose repaired B-diagonal is 1) and sorted
    # last explicitly — an earlier design required the sentinel to provably
    # under-run the active spectrum, which a randomized norm estimate cannot
    # guarantee (can undershoot ||A||_2 by ~sqrt(m/nx) on spiked spectra).
    # A positive moderate value keeps it away from the wanted (smallest)
    # Ritz values — degeneracy with an active Ritz value is the one channel
    # that could still mix eigenvectors, and ``pencil_consistent`` reports it
    # instead of silently corrupting the window.  (Moderate scale because
    # a QDWH-based eigh normalizes by |A|; 1/eps sentinels erase f32
    # accuracy.)
    pos_sent = 16.0 * (A2normest + B2normest) + 1.0

    n_trace = max(max_iterations, 1)

    if warm_start is None:
        # --- initialization: B-orthonormalize X0 (reference LOBPCG.h:218-230)
        AX = A(X0)
        BX = Bop(X0)
        theta0, C0, ok0 = _rr(_mm(X0.T, AX), _mm(X0.T, BX))
        X = _mm(X0, C0)
        AX = _mm(AX, C0)
        BX = _mm(BX, C0)
        R = AX - BX * theta0[None, :]
        k0 = jnp.zeros((), jnp.int32)
        st0 = _State(
            k=k0,
            X=X, AX=AX, BX=BX, R=R,
            P=jnp.zeros_like(X),
            theta=theta0,
            nc=jnp.zeros((), jnp.int32),
            r=jnp.linalg.norm(R[:, :nev], axis=0),
            done=jnp.asarray(False),
            ok=ok0,
            residual_trace=jnp.full((n_trace,), pad_value(), dtype),
            nc_trace=jnp.full((n_trace,), -1, jnp.int32),
            Useed=(jnp.eye(3 * nx, dtype=dtype) if warm_rr else ()),
        )
    else:
        k0, carry = warm_start
        # done must survive the resume for BOTH stop channels: converged
        # (nc >= nev) and RR breakdown (ok False — the chol path's frozen
        # state); dropping the latter would re-run the deterministically
        # re-breaking iteration every chunk, diverging from monolithic.
        st0 = _State(
            k=k0, done=(carry["nc"] >= nev) | ~carry["ok"],
            residual_trace=jnp.full((n_trace,), pad_value(), dtype),
            nc_trace=jnp.full((n_trace,), -1, jnp.int32),
            **carry)

    col = jnp.arange(nx)
    col_s = jnp.arange(3 * nx)

    def body(st: _State) -> _State:
        k = st.k + 1

        # Preconditioned search directions (reference LOBPCG.h:247)
        W = Top(st.R)

        # Soft locking masks: only the *active* (non-converged) trailing
        # columns of W and P enter the search space (reference LOBPCG.h:249-264)
        w_mask = col >= st.nc
        p_mask = w_mask & (k > 1)
        S = jnp.concatenate(
            [st.X, W * w_mask[None, :], st.P * p_mask[None, :]], axis=1)

        AS = A(S)
        BS = Bop(S)

        StAS = _mm(S.T, AS)
        StBS = _mm(S.T, BS)

        # Repair the pencil on masked columns: unit B-diagonal, sentinel
        # A-diagonal => exact decoupling into the active block plus trivial
        # fake pairs with eigenvector e_i and eigenvalue pos_sent.
        mask_s = jnp.concatenate(
            [jnp.ones((nx,), bool), w_mask, p_mask]).astype(dtype)
        off = 1.0 - mask_s
        StAS = (StAS * mask_s[:, None] * mask_s[None, :]
                + jnp.diag(pos_sent * off))
        StBS = StBS * mask_s[:, None] * mask_s[None, :] + jnp.diag(off)

        theta_all, C, rr_ok, Useed_new = _rr_loop(StAS, StBS, st.Useed)

        # Classify fake pairs by their (repaired-)B energy on the masked
        # coordinates: exactly 1 for fakes, 0 for active pairs (and 0 for
        # rayleigh_ritz's own deflated columns, which carry a huge theta and
        # therefore sort after every genuine pair anyway).  Sorting the key
        # (theta, fakes -> +inf) then makes the wanted pairs the static
        # leading window — no dynamic shapes, no reliance on sentinel
        # placement relative to the (unknown) active spectrum.
        energy = jnp.sum((C * off[:, None]) ** 2, axis=0)
        is_fake = energy > 0.5
        sort_key = jnp.where(is_fake, jnp.inf, theta_all)
        order = jnp.argsort(sort_key)[:nx]
        theta = theta_all[order]
        # Zero the masked rows of the selected columns: with exact
        # decoupling this is a no-op; under a sentinel/active eigenvalue
        # collision it truncates any mixed-in locked-direction content.
        C_x = C[:, order] * mask_s[:, None]

        n_fake = (3 * nx - jnp.sum(mask_s)).astype(jnp.int32)
        ok = st.ok & rr_ok & (jnp.sum(is_fake).astype(jnp.int32) == n_fake)

        X_new = _mm(S, C_x)
        AX_new = _mm(AS, C_x)
        BX_new = _mm(BS, C_x)
        R_new = AX_new - BX_new * theta[None, :]
        # Implicit-difference block P (reference LOBPCG.h:288)
        P_new = _mm(S[:, nx:], C_x[nx:, :])

        # Convergence test (reference LOBPCG.h:292-318)
        r = jnp.linalg.norm(R_new[:, :nev], axis=0)
        x_norms = jnp.linalg.norm(X_new[:, :nev], axis=0)
        tolerances = tau * (A2normest
                            + B2normest * jnp.abs(theta[:nev])) * x_norms
        converged = r <= tolerances
        # Contiguous converged prefix (soft locking must respect order)
        nc = jnp.sum(jnp.cumprod(converged.astype(jnp.int32))).astype(jnp.int32)

        done = nc >= nev
        if user_function is not None:
            done = done | jnp.asarray(
                user_function(k, nev, theta, X_new, r, nc))

        # RR breakdown (rr_ok False — possible only on the "chol" fast
        # path, e.g. both shift attempts NaN on a pathological pencil):
        # FREEZE at the last good state and stop, instead of letting NaN
        # poison the iterate.  The run exits flagged (pencil_consistent
        # False) with its pre-breakdown eigenpairs intact.
        def frz(new, old):
            return jnp.where(rr_ok, new, old)

        X_new, AX_new, BX_new = (frz(X_new, st.X), frz(AX_new, st.AX),
                                 frz(BX_new, st.BX))
        R_new, P_new = frz(R_new, st.R), frz(P_new, st.P)
        theta, nc, r = frz(theta, st.theta), frz(nc, st.nc), frz(r, st.r)
        if warm_rr:
            Useed_new = frz(Useed_new, st.Useed)
        done = done | ~rr_ok

        slot = k - 1 - k0
        return _State(k=k, X=X_new, AX=AX_new, BX=BX_new, R=R_new, P=P_new,
                      theta=theta, nc=nc, r=r, done=done, ok=ok,
                      residual_trace=st.residual_trace.at[slot].set(
                          jnp.max(r)),
                      nc_trace=st.nc_trace.at[slot].set(nc),
                      Useed=(Useed_new if warm_rr else ()))

    def cond(st: _State):
        return (st.k - k0 < max_iterations) & ~st.done

    st = jax.lax.while_loop(cond, body, st0)

    carry_out = dict(X=st.X, AX=st.AX, BX=st.BX, R=st.R, P=st.P,
                     theta=st.theta, nc=st.nc, r=st.r, ok=st.ok,
                     Useed=st.Useed)
    return LOBPCGResult(
        theta=st.theta[:nev],
        X=st.X[:, :nev],
        num_iterations=st.k,
        num_converged=st.nc,
        residual_norms=st.r,
        pencil_consistent=st.ok,
        residual_trace=st.residual_trace,
        nc_trace=st.nc_trace,
        warm_start=(st.k, carry_out),
    )


def lobpcg_fleet(
    A: Callable[[jnp.ndarray, Any], jnp.ndarray],
    data: Any,
    *,
    B: Optional[Callable[[jnp.ndarray, Any], jnp.ndarray]] = None,
    T: Optional[Callable[[jnp.ndarray, Any], jnp.ndarray]] = None,
    X0: Optional[jnp.ndarray] = None,
    m: Optional[int] = None,
    nx: Optional[int] = None,
    nev: int,
    max_iterations: int = 100,
    tau: float = 1e-6,
    key: Optional[jax.Array] = None,
    eigh_fn: Optional[Callable[[jnp.ndarray], Tuple[jnp.ndarray,
                                                    jnp.ndarray]]] = None,
    rr_method: str = "chol",
    warm_start: Optional[tuple] = None,
) -> LOBPCGResult:
    """Fleet-batched LOBPCG: one fused three-block iteration across many
    same-shaped pencils.

    Single-instance LOBPCG at moderate m is bound by small-op latency (two
    (3nx x 3nx) eighs + the blocked GEMMs per iteration), so certification
    and spectral-initialization sweeps that solve one pencil per problem
    pay that floor serially.  Batching the *entire* iteration —
    Rayleigh-Ritz, masking, convergence logic — with ``jax.vmap`` turns the
    fleet into single batched GEMMs/eighs whose per-instance cost
    amortizes the floor (benchmarks/config3 and config10 measure it).

    - ``A(S, data_i)`` (and optional ``B``/``T``): per-instance operators
      reading the instance slice of ``data`` (a PyTree stacked on a
      leading fleet axis — the vmap/shard seam; shard it over a mesh
      "batch" axis for multi-chip fleets).
    - ``X0``: optional (fleet, m, nx) initial blocks; default per-instance
      random Gaussians.
    - Remaining arguments as :func:`lobpcg`.

    The fleet iterates in LOCKSTEP until every instance's converged prefix
    reaches ``nev`` (or max_iterations): instances that converge early
    keep refining — their returned pairs are at least as converged as a
    standalone solve's, and ``num_iterations`` reports the lockstep count.

    The fleet default is ``rr_method="chol"`` (one eigh per iteration via
    shifted-Cholesky whitening, half the eigh count of the eigh RR and
    the most accurate converged arm in the fleet tests); the fleet pays
    ONE host dispatch per sweep where serial solves pay one per instance.
    Its speed against the eigh RR and batched parallel-Jacobi on the card
    is not measured yet (benchmarks/probe_jacobi.py, config10).

    Returns an :class:`LOBPCGResult` whose fields carry a leading fleet
    axis (``warm_start`` is batched too and resumes through
    ``lobpcg``-under-vmap).
    """
    fleet = jax.tree_util.tree_leaves(data)[0].shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, fleet)

    def one(data_i, key_i, X0_i, ws_i):
        return lobpcg(
            lambda S: A(S, data_i),
            B=(lambda S: B(S, data_i)) if B is not None else None,
            T=(lambda S: T(S, data_i)) if T is not None else None,
            X0=X0_i, m=m, nx=nx, nev=nev,
            max_iterations=max_iterations, tau=tau, key=key_i,
            eigh_fn=eigh_fn, rr_method=rr_method, warm_start=ws_i)

    if warm_start is not None:
        # Resume the whole fleet from a batched result.warm_start (the
        # host-chunked driver seam: core/driver.drive_lobpcg_fleet).
        return jax.vmap(lambda d, k, w: one(d, k, None, w))(
            data, keys, warm_start)
    if X0 is None:
        return jax.vmap(lambda d, k: one(d, k, None, None))(data, keys)
    return jax.vmap(lambda d, k, x: one(d, k, x, None))(data, keys, X0)
