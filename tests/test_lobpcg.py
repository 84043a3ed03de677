"""LOBPCG tests mirroring reference ``LOBPCG_unit_test.cpp``.

Fixture: A = diag(LinSpaced(-n/2, n/2)), B = diag(1..n), T = |A| as a
(diagonal) preconditioner; n=1000, block size nx=10, nev=5, tau=1e-8
(ref lines 30-75).  Checks:

- Rayleigh-Ritz invariants C'AC = Theta, C'BC = I (ref lines 79-103).
- Small 4-dim standard problem with pinned X0 (ref lines 105-135).
- Standard / preconditioned / generalized problems: all nev converged and
  |Theta - Lambda_true| < 1e-4 (ref lines 137-225).
"""

import jax
import jax.numpy as jnp
import numpy as np

from optimization_tpu.linalg.lobpcg import lobpcg, lobpcg_fleet, rayleigh_ritz

import pytest


N = 1000
NX = 10
NEV = 5
TAU = 1e-8

Adiag = jnp.linspace(-0.5 * N, 0.5 * N, N)
Bdiag = jnp.linspace(1.0, N, N)

A_op = lambda S: Adiag[:, None] * S
B_op = lambda S: Bdiag[:, None] * S
T_op = lambda S: jnp.abs(Adiag)[:, None] * S


def test_rayleigh_ritz_invariants():
    n = 7
    rng = np.random.default_rng(5)
    AL = rng.uniform(-1, 1, (n, n))
    A = jnp.asarray(-AL @ AL.T)          # negative definite
    BL = rng.uniform(-1, 1, (n, n))
    B = jnp.asarray(BL @ BL.T + 1e-3 * np.eye(n))  # SPD
    theta, C = rayleigh_ritz(A, B)
    assert float(jnp.linalg.norm(C.T @ A @ C - jnp.diag(theta))) < 1e-8
    assert float(jnp.linalg.norm(C.T @ B @ C - jnp.eye(n))) < 1e-8
    # Ascending eigenvalue order
    assert (np.diff(np.asarray(theta)) >= 0).all()


def test_small_eigenvalue_problem():
    lam = jnp.array([1.0, 2.0, 3.0, 4.0])
    X0 = jnp.array([
        [0.8147, 0.6324],
        [0.9058, 0.0975],
        [0.1270, 0.2785],
        [0.9134, 0.5469],
    ])
    res = lobpcg(lambda S: lam[:, None] * S, X0=X0, nev=2,
                 max_iterations=N, tau=TAU)
    assert int(res.num_converged) == 2
    assert float(jnp.linalg.norm(res.theta - lam[:2])) < 1e-3


def test_standard_eigenvalue_problem():
    res = lobpcg(A_op, m=N, nx=NX, nev=NEV, max_iterations=10 * N, tau=TAU,
                 key=jax.random.PRNGKey(1))
    assert int(res.num_converged) == NEV
    assert float(jnp.linalg.norm(res.theta - Adiag[:NEV])) < 1e-4


def test_preconditioned_eigenvalue_problem():
    res = lobpcg(A_op, T=T_op, m=N, nx=NX, nev=NEV, max_iterations=N,
                 tau=TAU, key=jax.random.PRNGKey(2))
    assert int(res.num_converged) == NEV
    assert float(jnp.linalg.norm(res.theta - Adiag[:NEV])) < 1e-4


def _generalized_truth():
    lam = np.sort(np.asarray(Adiag) / np.asarray(Bdiag))
    return jnp.asarray(lam[:NEV])


def test_generalized_eigenvalue_problem():
    res = lobpcg(A_op, B=B_op, m=N, nx=NX, nev=NEV, max_iterations=N,
                 tau=TAU, key=jax.random.PRNGKey(3))
    assert int(res.num_converged) == NEV
    assert float(jnp.linalg.norm(res.theta - _generalized_truth())) < 1e-4


def test_preconditioned_generalized_eigenvalue_problem():
    res = lobpcg(A_op, B=B_op, T=T_op, m=N, nx=NX, nev=NEV,
                 max_iterations=N, tau=TAU, key=jax.random.PRNGKey(4))
    assert int(res.num_converged) == NEV
    assert float(jnp.linalg.norm(res.theta - _generalized_truth())) < 1e-4


def test_eigenvectors_satisfy_pencil():
    """Residual check: |A x - theta B x| small for each returned pair."""
    res = lobpcg(A_op, B=B_op, m=N, nx=NX, nev=NEV, max_iterations=N,
                 tau=TAU, key=jax.random.PRNGKey(3))
    R = A_op(res.X) - B_op(res.X) * res.theta[None, :]
    assert float(jnp.linalg.norm(R)) < 1e-3


def test_user_function_early_stop():
    stop = lambda k, nev, theta, X, r, nc: k >= 3
    res = lobpcg(A_op, m=N, nx=NX, nev=NEV, max_iterations=N, tau=TAU,
                 key=jax.random.PRNGKey(1), user_function=stop)
    assert int(res.num_iterations) == 3


def test_validation():
    import pytest

    with pytest.raises(ValueError):
        lobpcg(A_op, m=N, nx=4, nev=5, max_iterations=10)
    with pytest.raises(ValueError):
        lobpcg(A_op, m=3, nx=4, nev=2, max_iterations=10)


def test_f32_ill_conditioned_preconditioned():
    """Regression for an f32 failure mode: in pure f32 with a wide spectrum
    the Cholesky Rayleigh-Ritz collapses and 1/eps-scale soft-lock sentinels
    destroy eigh accuracy under norm-normalizing eigh implementations.  The
    whitened RR + moderate negative sentinels must converge in a handful of
    iterations with an exact-inverse preconditioner."""
    m = 20000
    d = jnp.linspace(1.0, float(m), m, dtype=jnp.float32)
    A = lambda S: d[:, None] * S
    T = lambda S: S / d[:, None]
    res = lobpcg(A, T=T, m=m, nx=12, nev=5, max_iterations=50, tau=1e-4,
                 key=jax.random.PRNGKey(3))
    assert int(res.num_converged) == 5
    assert int(res.num_iterations) <= 10
    # f32 floor: eps * |A| ~ 2.4e-3
    np.testing.assert_allclose(np.asarray(res.theta, np.float64),
                               np.arange(1.0, 6.0), atol=5e-2)


def test_vmapped_batch():
    """A fleet of eigenproblems under vmap: one compiled program."""
    B, m_, nx_, nev_ = 3, 200, 6, 3
    shifts = jnp.array([0.0, 10.0, 100.0])

    def solve_one(shift):
        dd = jnp.linspace(1.0, 50.0, m_) + shift
        res = lobpcg(lambda S: dd[:, None] * S, m=m_, nx=nx_, nev=nev_,
                     max_iterations=300, tau=1e-8)
        return res.theta, res.num_converged

    thetas, ncs = jax.vmap(solve_one)(shifts)
    for b in range(B):
        want = np.linspace(1.0, 50.0, m_)[:nev_] + float(shifts[b])
        np.testing.assert_allclose(np.asarray(thetas[b]), want, atol=1e-4)


class TestRound2Robustness:
    """Round-2: energy-classified fake pairs (no reliance on sentinel
    placement), warm-start seam, and the host-chunked standalone driver
    (reference front-end parity, ``LOBPCG.h:131-140``)."""

    def _diag_problem(self, m=400, nx=8, nev=4, spike=None):
        d = jnp.linspace(1.0, float(m), m, dtype=jnp.float64)
        if spike is not None:
            d = d.at[0].set(spike)
        A = lambda S: d[:, None] * S
        T = lambda S: S / jnp.abs(d)[:, None]
        return d, A, T

    def test_pencil_consistent_under_locking(self):
        d, A, T = self._diag_problem()
        res = lobpcg(A, T=T, m=400, nx=8, nev=4, max_iterations=100,
                     tau=1e-8, key=jax.random.PRNGKey(1))
        assert int(res.num_converged) >= 4
        assert bool(res.pencil_consistent)
        np.testing.assert_allclose(np.asarray(res.theta),
                                   np.arange(1.0, 5.0), atol=1e-4)

    def test_spiked_negative_spectrum(self):
        """One dominant negative eigenvalue (the certification use case the
        round-1 sentinel could misorder: a randomized Frobenius-style norm
        estimate may undershoot |A|_2 by ~sqrt(m/nx) on spiked spectra)."""
        m = 2048
        d, A, T = self._diag_problem(m=m, spike=-1e5)
        res = lobpcg(A, T=T, m=m, nx=8, nev=3, max_iterations=200,
                     tau=1e-8, key=jax.random.PRNGKey(2))
        assert bool(res.pencil_consistent)
        assert int(res.num_converged) >= 3
        np.testing.assert_allclose(np.asarray(res.theta),
                                   [-1e5, 2.0, 3.0], rtol=1e-6)

    def test_warm_start_resumes_exactly(self):
        d, A, T = self._diag_problem()
        X0 = jax.random.normal(jax.random.PRNGKey(5), (400, 8),
                               jnp.float64)
        mono = lobpcg(A, T=T, X0=X0, nev=4, max_iterations=40, tau=1e-10)
        assert int(mono.num_iterations) > 4   # the split below is partial
        r1 = lobpcg(A, T=T, X0=X0, nev=4, max_iterations=4, tau=1e-10)
        r2 = lobpcg(A, T=T, X0=X0, nev=4, max_iterations=36, tau=1e-10,
                    warm_start=r1.warm_start)
        assert int(r2.num_iterations) == int(mono.num_iterations)
        np.testing.assert_array_equal(np.asarray(r2.theta),
                                      np.asarray(mono.theta))
        np.testing.assert_array_equal(np.asarray(r2.X), np.asarray(mono.X))

    def test_driver_chunked_equals_monolithic(self, capsys):
        from optimization_tpu.core.driver import drive_lobpcg

        d, A, T = self._diag_problem()
        X0 = jax.random.normal(jax.random.PRNGKey(5), (400, 8), jnp.float64)
        mono = lobpcg(A, T=T, X0=X0, nev=4, max_iterations=100, tau=1e-8)
        res, times = drive_lobpcg(A, T=T, X0=X0, nev=4, max_iterations=100,
                                  tau=1e-8, chunk_iterations=7, verbose=True,
                                  precision=4)
        assert int(res.num_iterations) == int(mono.num_iterations)
        np.testing.assert_array_equal(np.asarray(res.theta),
                                      np.asarray(mono.theta))
        k = int(res.num_iterations)
        trace = np.asarray(res.residual_trace)
        assert np.isfinite(trace[:k]).all()
        assert np.all(np.isfinite(np.asarray(times)[:k]))
        out = capsys.readouterr().out
        assert out.count("Iter:") == k
        assert "LOBPCG terminated: 4/4 wanted eigenpairs converged" in out

    def test_driver_iteration_limit_report(self, capsys):
        from optimization_tpu.core.driver import drive_lobpcg

        d, A, T = self._diag_problem()
        res, _ = drive_lobpcg(A, T=T, m=400, nx=8, nev=4, max_iterations=3,
                              tau=1e-14, chunk_iterations=2, verbose=True,
                              key=jax.random.PRNGKey(0))
        out = capsys.readouterr().out
        assert "LOBPCG terminated: iteration limit reached" in out


def test_vmapped_fleet():
    """A fleet of LOBPCG instances under jax.vmap: the (3nx)^2 Rayleigh-Ritz
    stages batch into single fleet-wide kernels (the round-1 roadmap's
    'RR batched across a vmapped fleet').  Each instance must match its
    individual solve."""
    B, m, nx, nev = 4, 300, 8, 3
    rng = np.random.default_rng(8)
    ds = jnp.asarray(rng.uniform(1.0, 50.0, (B, m)))
    X0s = jnp.asarray(rng.normal(size=(B, m, nx)))

    def solve_one(d, X0):
        res = lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                     X0=X0, nev=nev, max_iterations=200, tau=1e-8)
        return res.theta, res.num_converged, res.pencil_consistent

    thetas, ncs, oks = jax.vmap(solve_one)(ds, X0s)
    assert bool(jnp.all(ncs >= nev))
    assert bool(jnp.all(oks))
    for b in range(B):
        th_ref = np.sort(np.asarray(ds[b]))[:nev]
        np.testing.assert_allclose(np.asarray(thetas[b]), th_ref, atol=1e-6)


def test_lobpcg_fleet_api():
    """lobpcg_fleet batches whole solves over a stacked data PyTree; each
    instance matches its standalone solve's eigenvalues."""
    from optimization_tpu.linalg.lobpcg import lobpcg_fleet

    B, m, nx, nev = 5, 250, 8, 3
    rng = np.random.default_rng(9)
    ds = jnp.asarray(rng.uniform(1.0, 40.0, (B, m)))

    res = lobpcg_fleet(lambda S, d: d[:, None] * S, ds,
                       T=lambda S, d: S / d[:, None],
                       m=m, nx=nx, nev=nev, max_iterations=200, tau=1e-8,
                       key=jax.random.PRNGKey(2))
    assert res.theta.shape == (B, nev)
    assert bool(jnp.all(res.num_converged >= nev))
    assert bool(jnp.all(res.pencil_consistent))
    for b in range(B):
        th_ref = np.sort(np.asarray(ds[b]))[:nev]
        np.testing.assert_allclose(np.asarray(res.theta[b]), th_ref,
                                   atol=1e-6)


class TestCholRR:
    """Round-3 fleet fast path: Rayleigh-Ritz via two-pass shifted Cholesky
    whitening (one eigh per iteration instead of two; _rayleigh_ritz_chol).
    Reference seam: LOBPCG.h:53-62 (the reference's own LDLT route)."""

    def test_rr_parity_with_eigh_path(self):
        from optimization_tpu.linalg.lobpcg import (_rayleigh_ritz_chol,
                                                    rayleigh_ritz)
        rng = np.random.default_rng(11)
        C = rng.standard_normal((24, 24))
        B = C @ C.T + 24 * np.eye(24)
        A = rng.standard_normal((24, 24))
        A = A + A.T
        td, _ = rayleigh_ritz(jnp.asarray(A), jnp.asarray(B))
        tc, Cc, ok = _rayleigh_ritz_chol(jnp.asarray(A), jnp.asarray(B))
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(tc), np.asarray(td),
                                   rtol=1e-10)
        # exact B-normalization (the post-hoc rescale): C' B C = I
        G = np.asarray(Cc).T @ B @ np.asarray(Cc)
        np.testing.assert_allclose(G, np.eye(24), atol=1e-10)

    def test_chol_path_converges_tight_f64(self):
        d = jnp.linspace(1.0, 800.0, 1500)
        res = lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                     m=1500, nx=12, nev=4, max_iterations=100, tau=1e-9,
                     rr_method="chol")
        assert int(res.num_converged) >= 4
        assert bool(res.pencil_consistent)
        np.testing.assert_allclose(np.asarray(res.theta),
                                   np.asarray(d[:4]), rtol=1e-9)

    def test_near_collinear_basis_no_spurious_pairs(self):
        """The one-pass-Cholesky failure mode: a near-collinear basis must
        not produce spurious small Ritz values (the two-pass + b-mass
        deflation repair).  X0 columns nearly parallel forces it."""
        d = jnp.linspace(1.0, 100.0, 400)
        base = jnp.ones((400,)) / 20.0
        X0 = (base[:, None]
              + 1e-9 * jax.random.normal(jax.random.PRNGKey(0), (400, 6)))
        res = lobpcg(lambda S: d[:, None] * S, X0=X0, nev=2,
                     max_iterations=150, tau=1e-6, rr_method="chol")
        theta = np.asarray(res.theta)
        # smallest true eigenvalue is 1.0; nothing below it may appear
        assert np.all(theta >= 0.9)

    def test_f32_beyond_envelope_stays_finite_and_accurate(self):
        """In f32 at a tolerance beyond the dtype floor (tau=1e-7) the chol
        fleet never converges its prefix — but every reported pair stays
        finite and near a true eigenvalue for the whole 120-iteration run
        (no silent degradation past the floor)."""
        d0 = jnp.linspace(1.0, 1000.0, 2000, dtype=jnp.float32)
        ds = jnp.arange(1.0, 5.0, dtype=jnp.float32)[:, None] * d0[None, :]
        # Explicit f32 X0: the suite runs x64, so the default Gaussian X0
        # would silently promote the whole solve to f64 and never reach
        # the breakdown regime this test exists to pin.
        X0 = jax.random.normal(jax.random.PRNGKey(1), (4, 2000, 16),
                               jnp.float32)
        res = lobpcg_fleet(
            lambda S, dd: dd[:, None] * S, ds,
            T=lambda S, dd: S / dd[:, None], X0=X0,
            m=2000, nx=16, nev=5, max_iterations=120, tau=jnp.float32(1e-7),
            key=jax.random.PRNGKey(5))
        assert res.X.dtype == jnp.float32
        theta = np.asarray(res.theta)
        assert np.all(np.isfinite(theta))
        # every instance's reported pairs are genuine (near a true
        # eigenvalue) even where the run is flagged
        for b in range(4):
            scale = float(b + 1)
            rel = np.abs(theta[b] / scale
                         - np.asarray(d0[:5], np.float64)) / np.asarray(
                             d0[:5], np.float64)
            assert np.max(rel) < 1e-3

    @pytest.mark.nan_traces  # deliberately NaN-injecting eigh fixture
    def test_rr_breakdown_freezes_not_poisons(self):
        """Deterministic pin of the breakdown-freeze contract: an eigh that
        NaNs on the (3nx)^2 iteration pencils (but not the nx^2 init
        pencil) breaks the first body iteration; the run must stop
        immediately, keep the finite post-init Ritz values, and flag
        pencil_consistent False — never propagate NaN into the iterate."""
        def breaking_eigh(M):
            w, V = jnp.linalg.eigh(M)
            if M.shape[0] == 3 * 8:      # body RR only (init is nx^2)
                return w * jnp.nan, V * jnp.nan
            return w, V

        d = jnp.linspace(1.0, 100.0, 300)
        res = lobpcg(lambda S: d[:, None] * S, m=300, nx=8, nev=3,
                     max_iterations=50, tau=1e-9, rr_method="chol",
                     eigh_fn=breaking_eigh)
        assert int(res.num_iterations) == 1
        assert not bool(res.pencil_consistent)
        assert np.all(np.isfinite(np.asarray(res.theta)))
        assert np.all(np.isfinite(np.asarray(res.X)))

    @pytest.mark.nan_traces  # deliberately NaN-injecting eigh fixture
    def test_warm_start_preserves_breakdown_freeze(self):
        """Resuming a breakdown-frozen run must stay frozen (the done bit
        reconstructs from ok on resume): chunked == monolithic even after
        an RR breakdown."""
        def breaking_eigh(M):
            w, V = jnp.linalg.eigh(M)
            if M.shape[0] == 3 * 8:
                return w * jnp.nan, V * jnp.nan
            return w, V

        d = jnp.linspace(1.0, 100.0, 300)
        kw = dict(m=300, nx=8, nev=3, tau=1e-9, rr_method="chol",
                  eigh_fn=breaking_eigh)
        r1 = lobpcg(lambda S: d[:, None] * S, max_iterations=5, **kw)
        r2 = lobpcg(lambda S: d[:, None] * S, max_iterations=5,
                    warm_start=r1.warm_start, **kw)
        assert int(r2.num_iterations) == int(r1.num_iterations) == 1
        assert not bool(r2.pencil_consistent)
        np.testing.assert_array_equal(np.asarray(r2.X), np.asarray(r1.X))


def test_drive_lobpcg_fleet_chunked_matches_monolithic():
    """Fleet host driving (round 3): chunked warm-started fleet == one
    monolithic fleet call, bitwise, and the stitched traces cover all
    lockstep iterations."""
    from optimization_tpu.core.driver import drive_lobpcg_fleet

    fleet, m, nev = 4, 500, 3
    ds = (jnp.arange(1.0, fleet + 1.0)[:, None]
          * jnp.linspace(1.0, 50.0, m)[None, :])
    A = lambda S, d: d[:, None] * S
    T = lambda S, d: S / d[:, None]

    mono = lobpcg_fleet(A, ds, T=T, m=m, nx=8, nev=nev,
                        max_iterations=40, tau=1e-9,
                        key=jax.random.PRNGKey(2))
    chunked, times = drive_lobpcg_fleet(A, ds, T=T, m=m, nx=8, nev=nev,
                                        max_iterations=40, tau=1e-9,
                                        key=jax.random.PRNGKey(2),
                                        chunk_iterations=7)
    np.testing.assert_array_equal(np.asarray(chunked.X),
                                  np.asarray(mono.X))
    np.testing.assert_array_equal(np.asarray(chunked.theta),
                                  np.asarray(mono.theta))
    assert bool(jnp.all(chunked.num_converged >= nev))
    tr = np.asarray(chunked.residual_trace)
    for b in range(fleet):
        kb = int(mono.num_iterations[b])
        assert np.isfinite(tr[b, :kb]).all()
    assert int(np.asarray(times).shape[0]) == 40


class TestWarmRR:
    """rr_method="chol_warm": the whitened RR eigh is a threshold-Jacobi
    solve seeded by the previous lockstep iteration's eigenvectors
    (jacobi_eigh(v0=)) — same convergence contract as "chol"."""

    def _diag_problem(self, m=800, nx=8, nev=4):
        d = jnp.linspace(1.0, 60.0, m)
        A = lambda S: d[:, None] * S
        T = lambda S: S / d[:, None]
        return A, T, d

    def test_matches_chol_convergence(self):
        from optimization_tpu.linalg.lobpcg import lobpcg

        A, T, d = self._diag_problem()
        kw = dict(T=T, m=800, nx=8, nev=4, max_iterations=150, tau=1e-8,
                  key=jax.random.PRNGKey(5))
        r_chol = lobpcg(A, rr_method="chol", **kw)
        r_warm = lobpcg(A, rr_method="chol_warm", **kw)
        assert int(r_warm.num_converged) >= 4
        assert bool(r_warm.pencil_consistent)
        lam_true = np.asarray(d)[:4]
        np.testing.assert_allclose(np.asarray(r_warm.theta), lam_true,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(r_warm.theta),
                                   np.asarray(r_chol.theta), atol=1e-6)
        # comparable iteration effort (warm RR changes only the eigh route)
        assert (int(r_warm.num_iterations)
                <= int(r_chol.num_iterations) + 10)

    def test_warm_start_resume(self):
        """Chunked driving must resume exactly: the Useed carry rides the
        warm_start tuple."""
        from optimization_tpu.linalg.lobpcg import lobpcg

        A, T, d = self._diag_problem()
        kw = dict(T=T, m=800, nx=8, nev=4, tau=1e-8,
                  key=jax.random.PRNGKey(5), rr_method="chol_warm")
        mono = lobpcg(A, max_iterations=60, **kw)
        a = lobpcg(A, max_iterations=30, **kw)
        b = lobpcg(A, max_iterations=30, warm_start=a.warm_start, **kw)
        assert int(b.num_converged) >= 4
        np.testing.assert_allclose(np.asarray(b.theta),
                                   np.asarray(mono.theta), atol=1e-8)

    def test_fleet_chol_warm(self):
        from optimization_tpu.linalg.lobpcg import lobpcg_fleet

        fleet, m, nx, nev = 6, 500, 8, 3
        ds = (jnp.arange(1.0, fleet + 1.0)[:, None]
              * jnp.linspace(1.0, 50.0, m)[None, :])
        res = lobpcg_fleet(lambda S, d: d[:, None] * S, ds,
                           T=lambda S, d: S / d[:, None],
                           m=m, nx=nx, nev=nev, max_iterations=120,
                           tau=1e-8, key=jax.random.PRNGKey(3),
                           rr_method="chol_warm")
        assert bool(jnp.all(res.num_converged >= nev))
        lam_true = np.asarray(ds[:, :nev] if False else
                              np.sort(np.asarray(ds), axis=1)[:, :nev])
        np.testing.assert_allclose(np.asarray(res.theta), lam_true,
                                   rtol=1e-6)
