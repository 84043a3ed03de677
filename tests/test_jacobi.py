"""Batched parallel-Jacobi symmetric eigensolver (linalg/jacobi.py).

The reference defers small dense eigenproblems to Eigen's selfadjoint solver
(e.g. ``LinearAlgebra/LOBPCG.h:53-62``); ``jacobi_eigh`` is a
replacement whose cost batches for free (fleet Rayleigh-Ritz).  Contract
tested here: the ``jnp.linalg.eigh`` contract (ascending eigenvalues,
orthonormal columns, A V = V diag(w)) over batches, odd sizes, graded and
degenerate spectra, plus the Brent-Luk tournament-permutation invariant the
whole scheme rests on.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from optimization_tpu.linalg.jacobi import _tournament_perm, jacobi_eigh
from optimization_tpu.linalg.lobpcg import lobpcg, rayleigh_ritz


@pytest.mark.parametrize("n", [2, 4, 6, 10, 48, 64])
def test_tournament_perm_covers_all_pairs(n):
    """n-1 iterates of the fixed permutation make every unordered index pair
    adjacent (positions 2i, 2i+1) exactly once."""
    perm = _tournament_perm(n)
    pos = np.arange(n)
    seen = set()
    for _ in range(n - 1):
        for i in range(n // 2):
            a, b = int(pos[2 * i]), int(pos[2 * i + 1])
            pair = (min(a, b), max(a, b))
            assert pair not in seen
            seen.add(pair)
        pos = pos[perm]
    assert len(seen) == n * (n - 1) // 2
    # ... and the sweep restores the identity arrangement (positions are
    # aligned at every sweep boundary, which the eigenvalue readout relies on)
    np.testing.assert_array_equal(pos, np.arange(n))


def _check(A, w, V, rtol):
    """jnp.linalg.eigh contract checks against numpy in float64."""
    A64 = np.asarray(A, np.float64)
    w64 = np.asarray(w, np.float64)
    V64 = np.asarray(V, np.float64)
    n = A64.shape[-1]
    scale = np.max(np.abs(np.linalg.eigvalsh(A64)), axis=-1)
    # ascending eigenvalues matching LAPACK
    np.testing.assert_allclose(
        w64, np.linalg.eigvalsh(A64),
        atol=rtol * np.max(scale), rtol=0)
    # residual + orthonormality
    res = A64 @ V64 - V64 * w64[..., None, :]
    assert np.max(np.abs(res)) <= rtol * np.max(scale) * 10
    ortho = np.swapaxes(V64, -1, -2) @ V64 - np.eye(n)
    assert np.max(np.abs(ortho)) <= rtol * 10


@pytest.mark.parametrize("n,batch", [(2, ()), (5, ()), (48, ()),
                                     (48, (16,)), (7, (3, 2))])
def test_matches_lapack_f64(n, batch):
    rng = np.random.default_rng(0)
    A = rng.standard_normal(batch + (n, n))
    A = A + np.swapaxes(A, -1, -2)
    w, V = jacobi_eigh(jnp.asarray(A))
    _check(A, w, V, 1e-13)


@pytest.mark.parametrize("n,batch", [(48, (16,)), (13, (4,))])
def test_matches_lapack_f32(n, batch):
    rng = np.random.default_rng(1)
    A = rng.standard_normal(batch + (n, n)).astype(np.float32)
    A = A + np.swapaxes(A, -1, -2)
    w, V = jacobi_eigh(jnp.asarray(A))
    assert w.dtype == jnp.float32
    # ~50 eps_f32 * ||A|| at n=48 (Jacobi's O(n eps) backward-error envelope)
    _check(A, w, V, 1e-5)


def test_batch_matches_singles():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 12, 12))
    A = A + np.swapaxes(A, -1, -2)
    wb, Vb = jacobi_eigh(jnp.asarray(A))
    for i in range(5):
        wi, Vi = jacobi_eigh(jnp.asarray(A[i]))
        # lockstep batching may run extra sweeps for some instances, so
        # agreement is to roundoff, not bitwise
        np.testing.assert_allclose(np.asarray(wb[i]), np.asarray(wi),
                                   rtol=0, atol=1e-12 * np.max(np.abs(wi)))


def test_degenerate_and_diagonal():
    # repeated eigenvalues: eigenvectors are only defined up to rotation,
    # but the contract checks (residual/orthonormality) remain exact
    Q, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((8, 8)))
    d = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 4.0, 4.0])
    A = (Q * d) @ Q.T
    w, V = jacobi_eigh(jnp.asarray(A))
    _check(A, w, V, 1e-13)
    # already-diagonal input: zero rotations, exact passthrough
    w, V = jacobi_eigh(jnp.diag(jnp.asarray([3.0, -1.0, 2.0])))
    np.testing.assert_array_equal(np.asarray(w), [-1.0, 2.0, 3.0])


def test_graded_equilibrated_spd_relative_accuracy():
    """The fleet Rayleigh-Ritz use case: a unit-diagonal near-singular SPD
    Gram matrix.  The threshold-Jacobi pivot criterion preserves the small
    eigenvalues' relative accuracy (an absolute eps*||A|| stop would not)."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((48, 8))
    B = X @ X.T + 1e-8 * np.eye(48)
    dd = 1.0 / np.sqrt(np.diag(B))
    B = B * dd[:, None] * dd[None, :]
    w, V = jacobi_eigh(jnp.asarray(B))
    wt = np.linalg.eigvalsh(B)
    # relative accuracy on the 1e-10-scale cluster is limited by the
    # van der Sluis scaled condition (~1e10 here): eps_f64 * cond ~ 1e-6
    np.testing.assert_allclose(np.asarray(w), wt, rtol=1e-5)


def test_sort_false_and_jit_vmap():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((4, 10, 10))
    A = A + np.swapaxes(A, -1, -2)
    w, V = jacobi_eigh(jnp.asarray(A), sort=False)
    _res = np.asarray(A) @ np.asarray(V) - np.asarray(V) * np.asarray(
        w)[..., None, :]
    assert np.max(np.abs(_res)) < 1e-12 * np.max(np.abs(A))
    # under vmap the batch axis becomes a vmapped axis — same results
    wv, Vv = jax.vmap(lambda a: jacobi_eigh(a))(jnp.asarray(A))
    np.testing.assert_allclose(np.sort(np.asarray(w), axis=-1),
                               np.asarray(wv), rtol=0,
                               atol=1e-12 * np.max(np.abs(A)))


def test_rayleigh_ritz_with_jacobi_matches_default():
    rng = np.random.default_rng(6)
    C = rng.standard_normal((24, 24))
    B = C @ C.T + 24 * np.eye(24)
    A = rng.standard_normal((24, 24))
    A = A + A.T
    td, Cd = rayleigh_ritz(jnp.asarray(A), jnp.asarray(B))
    tj, Cj = rayleigh_ritz(jnp.asarray(A), jnp.asarray(B),
                           eigh_fn=jacobi_eigh)
    np.testing.assert_allclose(np.asarray(tj), np.asarray(td), rtol=1e-10)
    # C'BC = I on both
    G = np.asarray(Cj).T @ B @ np.asarray(Cj)
    np.testing.assert_allclose(G, np.eye(24), atol=1e-10)


def test_lobpcg_with_jacobi_eigh():
    d = jnp.linspace(1.0, 500.0, 1500)
    res = lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                 m=1500, nx=12, nev=4, max_iterations=80, tau=1e-8,
                 eigh_fn=jacobi_eigh)
    assert int(res.num_converged) >= 4
    assert bool(res.pencil_consistent)
    np.testing.assert_allclose(np.asarray(res.theta),
                               np.asarray(d[:4]), rtol=1e-6)


def test_warm_start_seed_composes():
    """jacobi_eigh(v0=): conjugate-in, compose-out — warm-started results
    must match the cold solve and jnp.linalg.eigh on the original A."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 12, 12))
    A = jnp.asarray(A + np.swapaxes(A, -1, -2))
    w_ref, V_ref = jnp.linalg.eigh(A)
    # seed: the true eigenvectors perturbed by a small rotation
    P = jnp.asarray(rng.normal(size=(12, 12)) * 0.05)
    Q, _ = jnp.linalg.qr(jnp.eye(12) + P - P.T)
    v0 = V_ref @ Q.T
    w, V = jacobi_eigh(A, v0=v0)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref),
                               rtol=1e-10, atol=1e-10)
    # eigenvector residual on the ORIGINAL A
    R = A @ V - V * w[..., None, :]
    assert float(jnp.max(jnp.abs(R))) < 1e-8
    # orthonormality preserved through the composition
    I = jnp.swapaxes(V, -1, -2) @ V
    assert float(jnp.max(jnp.abs(I - jnp.eye(12)))) < 1e-10
